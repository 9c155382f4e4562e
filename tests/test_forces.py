"""Finite-difference validation of forces, virials, and parameter gradients.

The reference never checks forces against finite differences (its tests stop at
geometry helpers, reference: tests/). These tests close that gap and also
validate the *exact* SCF parameter gradients that the reference's
Feynman-Hellmann shortcut cannot provide (reference: admp/pme.py:83,114-125).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admp_tpu import ADMPPmeForce, SCFConfig, convert_cart2harm
from tests.watergen import water_arrays

M_SCALES = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])


@pytest.fixture(scope="module")
def small():
    sysd = water_arrays(n_side=2, spacing=3.1, jitter=0.12, seed=1)
    sysd["pairs"] = jnp.asarray(
        [[i, j] for i in range(24) for j in range(i + 1, 24)], dtype=jnp.int32
    )
    return sysd


def _fd_force(energy_fn, positions, atoms, eps=1e-5):
    """Central-difference gradient for a few (atom, dim) entries."""
    out = {}
    pos = np.asarray(positions)
    for a in atoms:
        for d in range(3):
            dp = pos.copy(); dp[a, d] += eps
            dm = pos.copy(); dm[a, d] -= eps
            out[(a, d)] = (energy_fn(jnp.asarray(dp)) - energy_fn(jnp.asarray(dm))) / (
                2 * eps
            )
    return out


@pytest.mark.slow
def test_fixed_multipole_forces_fd(small):
    sysd = small
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    force = ADMPPmeForce(
        jnp.asarray(sysd["box"]), sysd["axis_types"], sysd["axis_indices"],
        sysd["covalent_map"], 3.0, 1e-3, 2,
    )
    box = jnp.asarray(sysd["box"])

    def e_fn(p):
        return float(force.get_energy(p, box, sysd["pairs"], q_local, M_SCALES))

    _, grad = force.get_forces(
        jnp.asarray(sysd["positions"]), box, sysd["pairs"], q_local, M_SCALES
    )
    fd = _fd_force(e_fn, sysd["positions"], atoms=[0, 1, 7])
    for (a, d), val in fd.items():
        np.testing.assert_allclose(float(grad[a, d]), val, rtol=2e-5, atol=1e-6)


@pytest.mark.slow
def test_polarizable_forces_fd(small):
    """Forces through the converged SCF (implicit function theorem path)."""
    sysd = small
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    box = jnp.asarray(sysd["box"])
    force = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        3.0, 1e-3, 2, lpol=True,
        scf_config=SCFConfig(field_tol=1e-6, max_iter=200),
    )
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])
    u0 = jnp.zeros((24, 3))

    def e_fn(p):
        return float(
            force._energy_and_aux(
                p, box, sysd["pairs"], q_local, pol, tholes,
                M_SCALES, M_SCALES, M_SCALES, u0,
            )[0]
        )

    _, grad = force.get_forces(
        jnp.asarray(sysd["positions"]), box, sysd["pairs"], q_local,
        pol, tholes, M_SCALES, M_SCALES, M_SCALES, U_init=u0,
    )
    assert bool(force.lconverg)
    fd = _fd_force(e_fn, sysd["positions"], atoms=[0, 13], eps=2e-5)
    for (a, d), val in fd.items():
        np.testing.assert_allclose(float(grad[a, d]), val, rtol=5e-5, atol=5e-6)


@pytest.mark.slow
def test_polarizable_parameter_gradients_fd(small):
    """Exact d(E)/d(pol) and d(E)/d(Q_local) through the SCF solution."""
    sysd = small
    box = jnp.asarray(sysd["box"])
    positions = jnp.asarray(sysd["positions"])
    force = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        3.0, 1e-3, 2, lpol=True,
        scf_config=SCFConfig(field_tol=1e-7, max_iter=300),
    )
    tholes = jnp.asarray(sysd["tholes"])
    u0 = jnp.zeros((24, 3))
    q_local0 = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pol0 = jnp.asarray(sysd["pol"])

    def e_of(q_local, pol):
        return force._energy_and_aux(
            positions, box, sysd["pairs"], q_local, pol, tholes,
            M_SCALES, M_SCALES, M_SCALES, u0,
        )[0]

    gq, gpol = jax.grad(e_of, argnums=(0, 1))(q_local0, pol0)

    eps = 1e-5
    # charge of atom 0
    qp = q_local0.at[0, 0].add(eps)
    qm = q_local0.at[0, 0].add(-eps)
    fd_q = (float(e_of(qp, pol0)) - float(e_of(qm, pol0))) / (2 * eps)
    np.testing.assert_allclose(float(gq[0, 0]), fd_q, rtol=1e-5)

    # polarizability of atom 0 (an O site) — requires implicit diff; the
    # reference's stop_gradient would zero the indirect term
    eps_p = 1e-4
    fd_p = (
        float(e_of(q_local0, pol0.at[0].add(eps_p)))
        - float(e_of(q_local0, pol0.at[0].add(-eps_p)))
    ) / (2 * eps_p)
    np.testing.assert_allclose(float(gpol[0]), fd_p, rtol=1e-4, atol=1e-8)


@pytest.mark.slow
def test_virial_via_box_gradient(small):
    """dE/d(box) is well-defined and finite-difference consistent (the virial
    path the reference only aspires to in its README, reference: README.md:12)."""
    sysd = small
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    force = ADMPPmeForce(
        jnp.asarray(sysd["box"]), sysd["axis_types"], sysd["axis_indices"],
        sysd["covalent_map"], 3.0, 1e-3, 2,
    )
    positions = jnp.asarray(sysd["positions"])

    def e_of_box(box):
        return force.get_energy(positions, box, sysd["pairs"], q_local, M_SCALES)

    g = jax.grad(e_of_box)(jnp.asarray(sysd["box"]))
    eps = 1e-5
    box_p = np.asarray(sysd["box"]).copy(); box_p[0, 0] += eps
    box_m = np.asarray(sysd["box"]).copy(); box_m[0, 0] -= eps
    fd = (float(e_of_box(jnp.asarray(box_p))) - float(e_of_box(jnp.asarray(box_m)))) / (
        2 * eps
    )
    np.testing.assert_allclose(float(g[0, 0]), fd, rtol=1e-4)


@pytest.mark.slow
def test_f64_weight_pipeline_cuts_recip_force_error(small):
    """spread_precision='f64' must remove the B-spline weight rounding that
    dominates f32 reciprocal force error (measured 50x on water_1024)."""
    sysd = small
    import admp_tpu.ops.reciprocal as R
    from admp_tpu.ops.frames import construct_local_frames
    from admp_tpu.ops.harmonics import rot_local2global
    from admp_tpu.ops.influence import ck_1
    from admp_tpu.utils.constants import DIELECTRIC

    grid = (24, 24, 24)

    def forces(dtype, precision=None):
        pos = jnp.asarray(sysd["positions"], dtype)
        box = jnp.asarray(sysd["box"], dtype)
        ql = convert_cart2harm(jnp.asarray(sysd["q_cart"], dtype), 2)

        def e(p):
            qg = rot_local2global(
                ql,
                construct_local_frames(
                    p, box, jnp.asarray(sysd["axis_types"]),
                    jnp.asarray(sysd["axis_indices"]),
                ),
                2,
            )
            mesh = R.spread_to_mesh(p, box, qg, grid, 2, precision=precision)
            return R.convolve_energy(mesh, box, 0.7, ck_1, False, DIELECTRIC)

        return np.asarray(jax.grad(e)(pos), np.float64)

    f_ref = forces(jnp.float64)
    err_f32 = np.sqrt(((forces(jnp.float32) - f_ref) ** 2).mean())
    err_mix = np.sqrt(((forces(jnp.float32, "f64") - f_ref) ** 2).mean())
    assert err_mix < 0.25 * err_f32


@pytest.mark.slow
def test_feynman_hellmann_adjoint_mode():
    """SCFConfig(exact_adjoint=False) — the reference's stop_gradient SCF
    (admp/pme.py:114-125) — must run and give forces close to (but measurably
    different from) the exact implicit adjoint; exactness stays the default.
    Measured on the 3000-atom liquid box: the truncation costs 1.7e-3
    relative force RMSE."""
    import numpy as np

    from admp_tpu import ADMPPmeForce, SCFConfig
    from admp_tpu.ops.harmonics import convert_cart2harm
    from admp_tpu.settings import EngineConfig
    from tests.watergen import water_arrays

    sysd = water_arrays(n_side=2, spacing=3.0, jitter=0.1, seed=7)
    n = sysd["positions"].shape[0]
    pairs = [[i, j] for i in range(n) for j in range(i + 1, n)]
    pairs = jnp.asarray(pairs, dtype=jnp.int32)
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    scales = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])
    box = jnp.asarray(sysd["box"])
    positions = jnp.asarray(sysd["positions"])
    u0 = jnp.zeros((n, 3))

    assert SCFConfig().exact_adjoint  # exact gradients are the default

    out = {}
    for exact in (True, False):
        pme = ADMPPmeForce(
            box, sysd["axis_types"], sysd["axis_indices"],
            sysd["covalent_map"], 3.0, 1e-3, 2, lpol=True,
            config=EngineConfig(scf=SCFConfig(exact_adjoint=exact)),
        )
        (e, (_u, conv, _n)), f = pme._value_grad_aux(
            positions, box, pairs, q_local, jnp.asarray(sysd["pol"]),
            jnp.asarray(sysd["tholes"]), scales, scales, scales, u0,
        )
        assert bool(conv)
        out[exact] = (float(e), np.asarray(f))
    # identical energies (the solve itself is unchanged) ...
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-12)
    # ... close but not identical forces (truncated implicit term)
    df = out[False][1] - out[True][1]
    ref = np.sqrt(np.mean(out[True][1] ** 2))
    rel = np.sqrt(np.mean(df**2)) / ref
    assert 0.0 < rel < 0.05, rel


@pytest.mark.slow
def test_lmax0_lpol_recip_includes_induced_dipoles():
    """Charge-only polarizable model (lmax=0, lpol): the reciprocal space
    must include the induced dipoles. Cross-check: identical physics
    expressed as lmax=1 with zero permanent dipoles must give the same
    energy and forces (the reference's own lmax==0+lpol branch is buggy,
    admp/pme.py:226-227, so this is a self-consistency gate, not an oracle
    one)."""
    import numpy as np

    from admp_tpu import ADMPPmeForce
    from tests.watergen import water_arrays

    sysd = water_arrays(n_side=2, spacing=3.0, jitter=0.1, seed=11)
    n = sysd["positions"].shape[0]
    pairs = [[i, j] for i in range(n) for j in range(i + 1, n)]
    pairs = jnp.asarray(pairs, dtype=jnp.int32)
    scales = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])
    box = jnp.asarray(sysd["box"])
    positions = jnp.asarray(sysd["positions"])
    charges = jnp.asarray(sysd["q_cart"][:, :1])  # charges only
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])
    u0 = jnp.zeros((n, 3))
    # no anchors needed for charges; NoAxisType everywhere
    from admp_tpu.ops import frames as fc

    axis_types = np.full(n, fc.NOAXISTYPE, dtype=np.int32)
    axis_indices = np.full((n, 3), -1, dtype=np.int32)

    out = {}
    for lmax, q in ((0, charges), (1, jnp.concatenate(
            [charges, jnp.zeros((n, 3))], axis=-1))):
        pme = ADMPPmeForce(
            box, axis_types, axis_indices, sysd["covalent_map"],
            3.0, 1e-3, lmax, lpol=True,
        )
        (e, (u_star, conv, _n)), f = pme._value_grad_aux(
            positions, box, pairs, q, pol, tholes,
            scales, scales, scales, u0,
        )
        assert bool(conv)
        out[lmax] = (float(e), np.asarray(f), np.asarray(u_star))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-10)
    np.testing.assert_allclose(out[0][1], out[1][1], atol=1e-10)
    np.testing.assert_allclose(out[0][2], out[1][2], atol=1e-10)
    # and the recip term really sees the dipoles: a nonzero-u energy must
    # differ from the u=0 energy by more than the real+self parts alone
    assert np.abs(out[0][2]).max() > 1e-4
