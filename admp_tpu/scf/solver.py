"""Induced-dipole self-consistent field: on-device linear solvers with exact
implicit-function differentiation.

The reference converges induced dipoles with a *host-side* Python loop of damped
Jacobi steps (reference: admp/pme.py:111-143) — one device->host sync per
iteration — and truncates all gradients through the SCF by stop_gradient,
justifying the result with the Feynman-Hellmann theorem (admp/pme.py:83,114-125).
That is exact only for the total energy at tight convergence; gradients of any
other function of the dipoles (e.g. dipole-fitting losses) are silently wrong.

Here:
* The polarization energy is exactly quadratic in the induced dipoles U, so
  field(U) = dE/dU = A U - b defines an SPD linear system. We solve it with a
  diagonally-preconditioned conjugate-gradient loop inside ``lax.while_loop`` —
  fully on device, jit-compiled, no host syncs. A damped-Jacobi mode is kept for
  cross-validation with the reference.
* The solve is wrapped in ``jax.custom_vjp`` implementing the implicit-function
  adjoint: given the cotangent g of U*, solve A w = g once and propagate
  -(d field/d theta)^T w. This yields *exact* gradients of arbitrary downstream
  functions with respect to all parameters (positions, multipoles,
  polarizabilities, Thole widths, scale tables).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from admp_tpu.settings import SCFConfig
from admp_tpu.utils.constants import DIELECTRIC


def _tree_dot(a, b):
    leaves = jax.tree_util.tree_map(lambda x, y: jnp.sum(x * y), a, b)
    return jax.tree_util.tree_reduce(jnp.add, leaves)


def _pcg_fixed(matvec, r0, precond, x0, n_iters, tol_field, site_mask):
    """Statically-unrolled PCG: exactly ``n_iters`` iterations, no
    while_loop. The absence of dynamic control flow lets XLA fuse/overlap the
    iterations with the surrounding energy graph (warm-started MD needs 0-2
    iterations; extra ones are harmless). Convergence is REPORTED from the
    final residual, not enforced.

    Takes the initial residual ``r0 = b - A x0`` directly: PCG never needs
    ``b`` again, and the caller can usually produce ``r0`` cheaper than
    ``b`` + one matvec (``-field(u0)`` is one field build; ``-field(0)``
    followed by ``matvec(u0)`` is a field build AND a matvec)."""
    r = r0
    z = precond(r)
    p = z
    rz = _tree_dot(r, z)
    x = x0
    for _ in range(n_iters):
        ap = matvec(p)
        p_ap = _tree_dot(p, ap)
        alpha = jnp.where(
            p_ap != 0.0, rz / jnp.where(p_ap == 0.0, 1.0, p_ap), 0.0
        )
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _tree_dot(r, z)
        beta = jnp.where(rz != 0.0, rz_new / jnp.where(rz == 0.0, 1.0, rz), 0.0)
        p = z + beta * p
        rz = rz_new
    resid = jnp.max(jnp.abs(r * site_mask))
    return x, resid < tol_field, jnp.asarray(n_iters, jnp.int32), r


def _pcg(matvec, r0, precond, x0, max_iter, tol_field, site_mask):
    """Preconditioned CG on A x = b; terminates when the *field residual*
    max |A x - b| over polarizable sites drops below tol_field (the reference's
    convergence metric, admp/pme.py:136). Takes ``r0 = b - A x0`` directly
    (see _pcg_fixed)."""

    def resid_norm(r):
        return jnp.max(jnp.abs(r * site_mask))

    z0 = precond(r0)
    p0 = z0
    rz0 = _tree_dot(r0, z0)

    def cond(state):
        _, r, _, _, it = state
        return jnp.logical_and(resid_norm(r) >= tol_field, it < max_iter)

    def body(state):
        x, r, p, rz, it = state
        ap = matvec(p)
        p_ap = _tree_dot(p, ap)
        # plain CG steps; guard only exact-zero divisions (converged/breakdown).
        # Zeroing the step on a non-PD direction would stall the loop without
        # progress; taking it keeps CG effective even on borderline systems
        # (polarization-catastrophe configurations), and max_iter still bounds
        # the loop with converged=False reported.
        alpha = jnp.where(p_ap != 0.0, rz / jnp.where(p_ap == 0.0, 1.0, p_ap), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _tree_dot(r, z)
        beta = jnp.where(rz != 0.0, rz_new / jnp.where(rz == 0.0, 1.0, rz), 0.0)
        p = z + beta * p
        return (x, r, p, rz_new, it + 1)

    x, r, _, _, n_iter = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    return x, resid_norm(r) < tol_field, n_iter, r


def _jacobi(matvec, b, damping, x0, max_iter, tol_field, site_mask):
    """Damped Jacobi U <- U - field * pol / DIELECTRIC (reference:
    admp/pme.py:132-138) as a while_loop; field = A U - b."""

    def cond(state):
        _, r, it = state
        return jnp.logical_and(
            jnp.max(jnp.abs(r * site_mask)) >= tol_field, it < max_iter
        )

    def body(state):
        x, r, it = state
        x = x + damping * r  # field = -r, update U <- U - field * damping
        r = b - matvec(x)
        return (x, r, it + 1)

    r0 = b - matvec(x0)
    x, r, n_iter = jax.lax.while_loop(cond, body, (x0, r0, 0))
    return x, jnp.max(jnp.abs(r * site_mask)) < tol_field, n_iter, r


def _adjoint_pcg(matvec, diag, g, config, x0=None):
    """Adjoint solve A w = g (A symmetric) at a relative tolerance floored
    at 40*eps of the working dtype: an f32 PCG cannot reduce the residual
    below its rounding floor, and an unreachable target (the f64-grade 1e-8
    default on an f32 pipeline) otherwise burns the full 4*max_iter cap
    on EVERY force call. At the floor
    (~4.8e-6 relative for f32) the adjoint correction — itself O(SCF
    residual) — keeps far more accuracy than the f32 force pipeline can
    represent. Default x0 = 0, so r0 = g exactly — no matvec(0) evaluation;
    a caller-supplied warm start ``x0`` costs one matvec for r0 = g - A x0
    (see the ``adjoint_warmstart`` pre-solve). The residual mask is
    all-ones: cotangents land on zero-pol sites too."""
    precond = lambda r: r * diag
    eps = jnp.finfo(jnp.result_type(g)).eps
    adj_tol = jnp.maximum(config.adjoint_tol, 40.0 * eps)
    g_scale = jnp.maximum(jnp.max(jnp.abs(g)), 1e-30)
    ones = jnp.ones_like(g[..., :1])
    if x0 is None:
        x0, r0 = jnp.zeros_like(g), g
    else:
        x0 = jax.lax.stop_gradient(x0)
        r0 = g - matvec(x0)
    if config.adjoint_fixed_iters is not None:
        w, _, _, _ = _pcg_fixed(
            matvec, r0, precond, x0,
            config.adjoint_fixed_iters, adj_tol * g_scale, ones,
        )
    else:
        w, _, _, _ = _pcg(
            matvec, r0, precond, x0,
            4 * config.max_iter, adj_tol * g_scale, ones,
        )
    return w


def _make_external_r0_solve(_solve_impl, _setup, matvec_fn, config):
    """The external-r0 variant of the implicit-VJP solve (see
    make_induced_dipole_solver's ``external_r0``): forward PCG from the
    caller-supplied r0, adjoint via the matvec's theta-path plus the r0
    cotangent flowing back into the caller's field graph.

    Math: with u0 = stop_grad(u_init), the solve defines
    A(theta) (u* - u0) = r0(theta). Differentiating:
    du* = A^-1 (dr0 - dA (u*-u0)), so for cotangent g with w = A^-1 g:
    r0_bar = w and theta_bar = -vjp_theta[matvec(u*-u0, theta)](w).
    Summing r0_bar through the caller's r0 = -field(u0) graph reproduces
    exactly the classic -vjp_theta[field(u*, theta)](w) (field is affine in
    u: field(u) = A u - b, r0 = b - A u0).

    Caveat: the identity needs matvec's A(theta) to BE the field's A(theta).
    With the default exact matvec (SCFConfig matvec_grid_div=1,
    matvec_spread_order=None) it is, bit-for-bit. A REDUCED matvec under
    exact_adjoint adds a theta-path error vjp[(A_mv - A)(u*-u0)](w) — small
    warm-started (u* ~ u0) but O(u*) on a cold start, where the classic
    field_fn theta-path had none. settings.py already directs fitting
    workloads to the exact-matvec defaults for this reason.

    ``config.adjoint_warmstart`` (with ``exact_adjoint``): the solve's fifth
    argument ``w_init`` and third diagnostic output ``w`` are — the ADJOINT solution carried across MD/fitting
    steps the way ``u_init`` carries the dipoles. Key identity: for a plain
    energy+force call the downstream cotangent of u* is
    g = dE/du|_{u*} = field(u*) = -r_final — MINUS THE FORWARD SOLVE'S OWN
    FINAL RESIDUAL, available for free. The forward therefore pre-solves
    A w_pre = -r_final starting from w_init (warm along a trajectory), and
    the backward only REFINES from x0 = w_pre against the true cotangent g
    (r0 = g - A w_pre: one matvec plus however many iterations the
    g-vs-(-r_final) discrepancy — rounding noise, or a non-energy consumer
    of u* — actually needs). Exactness is untouched: the refinement runs to
    the same tolerance the cold adjoint solve did; only its starting point
    changes. Energy-only evaluations never pay: outside a gradient context
    the pre-solve feeds only the ``w`` output, and callers that drop it let
    XLA dead-code-eliminate the whole pre-solve."""

    @jax.custom_vjp
    def solve(inputs, u_init, pol, r0, w_init):
        u, converged, n_iter, r_final = _solve_impl(inputs, u_init, pol, r0)
        if config.adjoint_warmstart and config.exact_adjoint:
            matvec, _, diag, _ = _setup(inputs, pol)
            g_pre = jax.lax.stop_gradient(-r_final)
            w = _adjoint_pcg(matvec, diag, g_pre, config, x0=w_init)
        else:
            w = jnp.zeros_like(u)
        return u, (converged, n_iter, w)

    def solve_fwd(inputs, u_init, pol, r0, w_init):
        out = solve(inputs, u_init, pol, r0, w_init)
        u_star, (_conv, _n_iter, w_pre) = out
        return out, (u_star, jax.lax.stop_gradient(u_init), inputs, pol,
                     w_pre)

    def solve_bwd(residuals, cotangents):
        u_star, u0, inputs, pol, w_pre = residuals
        # the aux (converged, n_iter, w) cotangent is DISCARDED: w is an
        # adjoint warm start, non-differentiable by contract (the pme.py
        # surface stop-gradients it so the semantics are explicit)
        g, _ = cotangents
        if not config.exact_adjoint:
            return (
                jax.tree_util.tree_map(jnp.zeros_like, inputs),
                jnp.zeros_like(u_star),
                jnp.zeros_like(pol),
                jnp.zeros_like(u_star),
                jnp.zeros_like(u_star),
            )
        matvec, _, diag, _ = _setup(inputs, pol)
        x0 = w_pre if config.adjoint_warmstart else None
        w = _adjoint_pcg(matvec, diag, g, config, x0=x0)
        delta_u = jax.lax.stop_gradient(u_star - u0)
        _, vjp_fn = jax.vjp(lambda inp: matvec_fn(delta_u, inp), inputs)
        (inputs_bar,) = vjp_fn(-w)
        return (inputs_bar, jnp.zeros_like(u_star), jnp.zeros_like(pol), w,
                jnp.zeros_like(u_star))

    solve.defvjp(solve_fwd, solve_bwd)
    return solve


def make_induced_dipole_solver(field_fn, config: SCFConfig = SCFConfig(),
                               matvec_fn=None, external_r0=False):
    """Build a differentiable SCF solver.

    Args:
      field_fn: (u, inputs) -> field, the gradient of the total energy with
        respect to the induced dipoles u (shape (N, 3)); linear in u.
      config: solver configuration.
      matvec_fn: optional (v, inputs) -> A v, the u-Hessian applied to v —
        mathematically field_fn(v) - field_fn(0), but implementable at a
        fraction of the cost (only the u-quadratic terms: no permanent
        interaction tensors, dipole-only mesh; see
        models/pme.py make_induced_quadratic_energy). Used for every PCG
        iteration of the forward solve AND the implicit-adjoint solve inside
        each force evaluation. (An explicit two-phase prepared matvec with
        its invariants cached outside the loop buys nothing: XLA CSE
        already shares those subgraphs with the surrounding energy graph.)
      external_r0: the caller supplies the initial residual
        ``r0 = -field(u_init)`` as a fourth argument instead of the solver
        building it internally. This moves the full field build OUT of the
        custom_vjp boundary, into the caller's jit scope, where XLA can CSE
        its u-independent subgraphs (local frames, multipole rotation, the
        permanent-multipole spread + FFT) against the identical work in the
        surrounding energy evaluation — the sharing a split inside the
        opaque custom_vjp can never get. Requires ``matvec_fn`` (the
        adjoint's theta-path runs through it; equivalence:
        vjp[r0](w) - vjp_theta[A (u*-u0)](w) == -vjp_theta[field(u*)](w)).

    Returns:
      solve(inputs, u_init, pol) -> (u_star, (converged, n_iter)), or with
      ``external_r0``: solve(inputs, u_init, pol, r0, w_init) ->
      (u_star, (converged, n_iter, w)) where ``w`` is the carried adjoint
      warm-start state (zeros unless config.adjoint_warmstart with
      exact_adjoint — see _make_external_r0_solve). Differentiable in
      ``inputs`` (and ``r0``) via the implicit adjoint; ``u_init``,
      ``w_init`` and the preconditioner are gradient-free.
    """
    if external_r0 and matvec_fn is None:
        raise ValueError("external_r0 requires matvec_fn")

    def _setup(inputs, pol):
        """Matvec + preconditioner pieces shared by forward and adjoint.

        Does NOT build the right-hand side: with a dedicated ``matvec_fn``
        neither the adjoint solve nor the PCG forward needs ``field(0)`` —
        the forward starts from ``r0 = -field(u0)`` (one field build instead
        of field(0) + matvec(u0)), the adjoint from ``r0 = g`` (x0 = 0)."""
        pol_ng = jax.lax.stop_gradient(pol)
        inputs_ng = jax.lax.stop_gradient(inputs)
        site_mask = (pol_ng > config.pol_eps).astype(pol_ng.dtype)[:, None]
        # Jacobi preconditioner ~ A_diag^-1 = max(pol, 1e-8)/DIELECTRIC —
        # the SAME floor the polarization penalty applies
        # (ops/selfenergy.py:44), so zero-polarizability sites get their
        # true (huge) diagonal instead of a ZERO preconditioner entry.
        # With pol/DIELECTRIC those components never enter the Krylov
        # space: the forward solve hid that by masking them out of its
        # residual norm, but the adjoint solve (which must converge on ALL
        # sites — cotangents land on zero-pol sites too) could NEVER reach
        # any tolerance and burned its full iteration cap on every force
        # call.
        diag = (jnp.maximum(pol_ng, 1e-8) / DIELECTRIC)[:, None]

        if matvec_fn is not None:
            def matvec(v):
                return matvec_fn(v, inputs_ng)
        else:
            zero_u = jnp.zeros((pol.shape[0], 3), dtype=pol_ng.dtype)
            field_at_zero = field_fn(zero_u, inputs_ng)

            def matvec(v):
                return field_fn(v, inputs_ng) - field_at_zero

        return matvec, inputs_ng, diag, site_mask

    def _solve_impl(inputs, u_init, pol, r0=None):
        matvec, inputs_ng, diag, site_mask = _setup(inputs, pol)
        u0 = jax.lax.stop_gradient(u_init)
        if config.method == "jacobi":
            zero_u = jnp.zeros_like(u0)
            b = -field_fn(zero_u, inputs_ng)
            return _jacobi(
                matvec, b, diag, u0, config.max_iter, config.field_tol, site_mask
            )
        # r0 = b - A u0 = -field(u0): one field build replaces the
        # field(0) + matvec(u0) pair (PCG never references b again)
        if r0 is None:
            r0 = -field_fn(u0, inputs_ng)
        else:
            r0 = jax.lax.stop_gradient(r0)
        precond = lambda r: r * diag
        if config.fixed_iters is not None:
            return _pcg_fixed(
                matvec, r0, precond, u0, config.fixed_iters, config.field_tol,
                site_mask,
            )
        return _pcg(
            matvec, r0, precond, u0, config.max_iter, config.field_tol,
            site_mask,
        )

    if external_r0:
        return _make_external_r0_solve(_solve_impl, _setup, matvec_fn, config)

    @jax.custom_vjp
    def solve(inputs, u_init, pol):
        u, converged, n_iter, _r = _solve_impl(inputs, u_init, pol)
        return u, (converged, n_iter)

    def solve_fwd(inputs, u_init, pol):
        out = solve(inputs, u_init, pol)
        return out, (out[0], inputs, pol)

    def solve_bwd(residuals, cotangents):
        u_star, inputs, pol = residuals
        g, _ = cotangents  # cotangent of u*, diagnostics are non-differentiable
        if not config.exact_adjoint:
            # Feynman-Hellmann mode: u* is treated as the exact variational
            # optimum, so the solve contributes no gradient (the energy's
            # dependence on theta flows through the separate direct
            # evaluation at u*). This is the reference's stop_gradient
            # behavior (admp/pme.py:114-125); error is O(SCF residual).
            return (
                jax.tree_util.tree_map(jnp.zeros_like, inputs),
                jnp.zeros_like(u_star),
                jnp.zeros_like(pol),
            )
        matvec, _, diag, _ = _setup(inputs, pol)
        w = _adjoint_pcg(matvec, diag, g, config)
        # theta_bar = - (d field / d theta)^T w  evaluated at u*
        _, vjp_fn = jax.vjp(lambda inp: field_fn(u_star, inp), inputs)
        (inputs_bar,) = vjp_fn(-w)
        return (
            inputs_bar,
            jnp.zeros_like(u_star),
            jnp.zeros_like(pol),
        )

    solve.defvjp(solve_fwd, solve_bwd)
    return solve
