"""Reciprocal-space PME: B-spline multipole spreading, 3D FFT, influence convolution.

Feature parity with reference: admp/recip.py:21-431, redesigned for XLA:

* Spline weights are evaluated once per dimension per stencil offset (see
  ops/bsplines.py) and combined with outer products, instead of 216 piecewise
  evaluations per atom (reference: admp/recip.py:239-241).
* The spherical-harmonic gradient operators (reference: admp/recip.py:215-275)
  are built from separable per-dimension derivative products — the whole
  spread tensor is a short sum of rank-1-per-dimension terms.
* k-space bookkeeping (integer frequencies, Euler factors, k^2) is computed on
  3D broadcast grids matching the fftn layout by construction, instead of the
  roll/meshgrid permutation dance (reference: admp/recip.py:332-365).
* The gamma point is handled with a closed-form C(0), keeping gradients NaN-free.
* The chain rule du/dx uses the general (non-orthorhombic-safe) transpose; for
  diagonal boxes it is identical to the reference.

The energy is  E = sum_k C(|k|^2) |S_k|^2 / theta_k^2   (Parseval form,
reference: admp/recip.py:413-426), with S_k = FFT(Q_mesh).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from admp_tpu.utils.linalg3 import det3x3, inv3x3

from admp_tpu.ops import bsplines
from admp_tpu.utils.accmath import compensated_sum

RT3 = 1.7320508075688772


def _dft_mats(k: int, n_out: int, dtype):
    """Real cos/sin DFT matrices: C[m, c] = cos(2 pi m c / k), S = sin."""
    m = np.arange(n_out)[:, None]
    c = np.arange(k)[None, :]
    ang = 2.0 * np.pi * (m * c % k) / k
    return (jnp.asarray(np.cos(ang), dtype), jnp.asarray(np.sin(ang), dtype))


def spectrum_sq_dft(mesh):
    """|DFT(mesh)|^2 over the rfft half-spectrum via explicit matmul DFTs.

    O(K^4) instead of O(K^3 log K), but runs entirely in the mesh dtype as
    plain matmuls, with no FFT-internal rounding. This is the precision-mode
    FFT: recip_precision='f64-dft'.
    """
    k1, k2, k3 = mesh.shape
    dtype = mesh.dtype
    c3, s3 = _dft_mats(k3, k3 // 2 + 1, dtype)
    # last axis, real input: X[a,b,c] -> (re, im) over k3h modes
    re = jnp.einsum("abc,kc->abk", mesh, c3)
    im = -jnp.einsum("abc,kc->abk", mesh, s3)
    # middle axis, complex: e^{-i t}(R + i I) = (R cos + I sin) + i(I cos - R sin)
    c2, s2 = _dft_mats(k2, k2, dtype)
    re, im = (
        jnp.einsum("abk,mb->amk", re, c2) + jnp.einsum("abk,mb->amk", im, s2),
        jnp.einsum("abk,mb->amk", im, c2) - jnp.einsum("abk,mb->amk", re, s2),
    )
    # leading axis
    c1, s1 = _dft_mats(k1, k1, dtype)
    re, im = (
        jnp.einsum("amk,na->nmk", re, c1) + jnp.einsum("amk,na->nmk", im, s1),
        jnp.einsum("amk,na->nmk", im, c1) - jnp.einsum("amk,na->nmk", re, s1),
    )
    return re * re + im * im


def spectrum_sq(mesh):
    """|FFT(mesh)|^2 over the rfft half-spectrum, in ``mesh.dtype`` (a float64
    mesh takes the native float64 FFT)."""
    s_k = jnp.fft.rfftn(mesh)
    return jnp.real(s_k * jnp.conj(s_k))


def _reduce_energy(terms, compensated: bool):
    if compensated and terms.dtype == jnp.float32:
        return compensated_sum(terms)
    return jnp.sum(terms)


def mesh_coordinates(positions, box, grid_shape, order: int = bsplines.ORDER):
    """Map positions to mesh space.

    Returns:
      m_u0: (N, 3) int32 index of the reference mesh point (ceil of the scaled
        fractional coordinate, reference: admp/recip.py:76).
      u0: (N, 3) fractional offsets in [order/2, order/2 + 1).
      dug_dx: (3, 3) Jacobian d(u)/d(x) (u_j rows, x_c cols): N_j * invbox[c, j].
    """
    n = jnp.asarray(grid_shape, dtype=positions.dtype)
    box_inv = inv3x3(box)
    # u-grid coordinate i of atom a: N_i * (x @ box_inv)_i
    r_in_m = (positions @ box_inv) * n
    m_u0 = jnp.ceil(r_in_m).astype(jnp.int32)
    u0 = (m_u0 - r_in_m) + order / 2
    dug_dx = (box_inv * n[None, :]).T  # [j, c] = N_j invbox[c, j]
    return m_u0, u0, dug_dx


def spread_weights(u0, dug_dx, lmax: int):
    """Per-atom spread weights for each harmonic channel on the 6x6x6 stencil.

    Returns (N, 6, 6, 6, n_harm) where n_harm = (lmax+1)**2 and the stencil axes
    follow offsets (k1-3, k2-3, k3-3) for k in 0..5.

    Channels (matching reference: admp/recip.py:249-271):
      l=0: theta
      l=1: (d theta/dz, /dx, /dy)       [harmonic z,x,y order]
      l=2: ((3 Hzz - tr H)/2, rt3 Hxz, rt3 Hyz, rt3/2 (Hxx - Hyy), rt3 Hxy)
    where H is the Cartesian Hessian of theta. Note u = m_u0 - N s + 3, so
    d theta/dx = - sum_j (d theta/du_j) dug_dx[j, :] and the Hessian picks up
    two minus signs (none net).
    """
    m = bsplines.spline_values(u0)  # (N, 6, 3)
    mx, my, mz = m[..., 0], m[..., 1], m[..., 2]
    theta = jnp.einsum("ai,aj,ak->aijk", mx, my, mz)
    outs = [theta[..., None]]

    if lmax >= 1:
        d = bsplines.spline_derivs(u0)
        dx_, dy_, dz_ = d[..., 0], d[..., 1], d[..., 2]
        # d theta / du_j, separable products
        g_u = jnp.stack(
            [
                jnp.einsum("ai,aj,ak->aijk", dx_, my, mz),
                jnp.einsum("ai,aj,ak->aijk", mx, dy_, mz),
                jnp.einsum("ai,aj,ak->aijk", mx, my, dz_),
            ],
            axis=-1,
        )  # (N, 6,6,6, 3) over u axes
        # Cartesian gradient: -g_u @ dug_dx  -> (N,6,6,6,3) over x,y,z
        g_x = -jnp.einsum("...j,jc->...c", g_u, dug_dx)
        outs.append(jnp.stack([g_x[..., 2], g_x[..., 0], g_x[..., 1]], axis=-1))

    if lmax >= 2:
        d2 = bsplines.spline_derivs2(u0)
        d2x, d2y, d2z = d2[..., 0], d2[..., 1], d2[..., 2]
        # upper-triangular second derivatives in u space
        h_uu = jnp.stack(
            [
                jnp.einsum("ai,aj,ak->aijk", d2x, my, mz),   # (0,0)
                jnp.einsum("ai,aj,ak->aijk", dx_, dy_, mz),  # (0,1)
                jnp.einsum("ai,aj,ak->aijk", dx_, my, dz_),  # (0,2)
                jnp.einsum("ai,aj,ak->aijk", mx, d2y, mz),   # (1,1)
                jnp.einsum("ai,aj,ak->aijk", mx, dy_, dz_),  # (1,2)
                jnp.einsum("ai,aj,ak->aijk", mx, my, d2z),   # (2,2)
            ],
            axis=-1,
        )
        iu, ju = np.triu_indices(3)
        full = jnp.zeros(h_uu.shape[:-1] + (3, 3), h_uu.dtype)
        full = full.at[..., iu, ju].set(h_uu)
        full = full.at[..., ju, iu].set(h_uu)
        # H_xcd = dug_dx[j,c] dug_dx[l,d] * h_uu[j,l]
        h_xx = jnp.einsum("jc,ld,...jl->...cd", dug_dx, dug_dx, full)
        trace = h_xx[..., 0, 0] + h_xx[..., 1, 1] + h_xx[..., 2, 2]
        outs.append(
            jnp.stack(
                [
                    (3.0 * h_xx[..., 2, 2] - trace) / 2.0,
                    RT3 * h_xx[..., 0, 2],
                    RT3 * h_xx[..., 1, 2],
                    RT3 / 2.0 * (h_xx[..., 0, 0] - h_xx[..., 1, 1]),
                    RT3 * h_xx[..., 0, 1],
                ],
                axis=-1,
            )
        )

    return jnp.concatenate(outs, axis=-1)


# Separable-term derivative multi-indices (d^p/dux^p, d^q/duy^q, d^r/duz^r)
# for the spread stencil: order 0, the three first derivatives, the six
# second derivatives (p+q+r <= 2).
_SEP_TERMS = [
    (0, 0, 0),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
]


def spread_mixing_matrix(dug_dx, lmax: int):
    """Constant (n_harm, n_terms) matrix M with  W_h = sum_t M[h,t] T_t  where
    T_t = mx^(p) (x) my^(q) (x) mz^(r) are the separable spline-derivative
    stencils of ``_SEP_TERMS`` and W_h the harmonic spread weights of
    :func:`spread_weights`.

    The Cartesian chain rule (du/dx Jacobian and Hessian conjugation) is
    *atom-independent* — it depends only on the box — so the whole harmonic
    channel mixing collapses to this one tiny matrix, applied to the (N, H)
    multipoles instead of to (N, 216, H) stencil arrays. Same math as
    spread_weights (kept as the readable specification and test oracle), at a
    fraction of the memory traffic.
    """
    dug = dug_dx
    one = jnp.ones((), dug.dtype)
    zero = jnp.zeros((), dug.dtype)
    n_terms = 1 + (3 if lmax >= 1 else 0) + (6 if lmax >= 2 else 0)
    cols = []
    # t0: plain theta -> only the monopole channel
    col = [one] + [zero] * ((lmax + 1) ** 2 - 1)
    cols.append(col)
    if lmax >= 1:
        for j in range(3):
            # harmonic dipole order is (z, x, y); gradient carries the -1 of
            # u = m_u0 - N s + 3 (see spread_weights)
            col = [zero, -dug[j, 2], -dug[j, 0], -dug[j, 1]]
            if lmax >= 2:
                col += [zero] * 5
            cols.append(col)
    if lmax >= 2:
        for (j, l) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
            def beta(c, d):
                b = dug[j, c] * dug[l, d]
                if j != l:
                    b = b + dug[l, c] * dug[j, d]
                return b
            b00, b11, b22 = beta(0, 0), beta(1, 1), beta(2, 2)
            col = [zero, zero, zero, zero,
                   (3.0 * b22 - (b00 + b11 + b22)) / 2.0,
                   RT3 * beta(0, 2),
                   RT3 * beta(1, 2),
                   RT3 / 2.0 * (b00 - b11),
                   RT3 * beta(0, 1)]
            cols.append(col)
    assert len(cols) == n_terms
    return jnp.stack([jnp.stack(c) for c in cols], axis=-1)  # (H, T)


def spread_points_separable(u0, alpha, lmax: int, order: int = 6):
    """Per-atom order^3 stencil values  Q[a] = sum_t alpha[a,t] T_t[a]  from
    the separable spline-derivative products (see :func:`spread_mixing_matrix`).

    The largest intermediate is (N, T, order^2) — ~20x smaller than the
    (N, order^3, H) weight arrays of the direct formulation, which bound the
    memory traffic of the spread stage and its force adjoint.
    """
    n = u0.shape[0]
    tabs = [bsplines.spline_values(u0, order)]
    if lmax >= 1:
        tabs.append(bsplines.spline_derivs(u0, order))
    if lmax >= 2:
        tabs.append(bsplines.spline_derivs2(u0, order))
    tab = jnp.stack(tabs, axis=1)  # (N, lmax+1, order, 3)
    n_terms = alpha.shape[-1]
    terms = _SEP_TERMS[:n_terms]
    px = [t[0] for t in terms]
    py = [t[1] for t in terms]
    pz = [t[2] for t in terms]
    x = tab[..., 0][:, px]  # (N, T, order)
    y = tab[..., 1][:, py]
    z = tab[..., 2][:, pz]
    ax = alpha[:, :, None] * x
    xy = (ax[:, :, :, None] * y[:, :, None, :]).reshape(
        n, n_terms, order * order
    )
    q_points = jnp.einsum("atp,atk->apk", xy, z)  # (N, order^2, order)
    return q_points.reshape(n, order, order, order)


def atom_spread_alpha(positions, box, q_harm, grid_shape, lmax: int,
                      order: int = 6, precision: str | None = None):
    """Per-atom spread prerequisites: base mesh index, fractional offsets, and
    the separable-term coefficients alpha = q @ spread_mixing_matrix (with the
    MPID quadrupole 1/3 already applied).

    The (m_u0, u0, alpha) triple is everything atom-dependent the stencil
    evaluation needs — ~16 scalars/atom instead of the order^3 stencil — so it
    is also the natural payload for the distributed halo-exchange spread's
    atom redistribution (parallel/spread.py). ``precision='f64'`` evaluates
    the pipeline in float64 (see spread_to_mesh).
    """
    if precision == "f64":
        positions_w = positions.astype(jnp.float64)
        box_w = box.astype(jnp.float64)
        q_w = q_harm.astype(jnp.float64)
    else:
        positions_w, box_w, q_w = positions, box, q_harm
    m_u0, u0, dug_dx = mesh_coordinates(positions_w, box_w, grid_shape, order)
    q = q_w[:, : (lmax + 1) ** 2]
    if lmax >= 2:
        q = jnp.concatenate([q[:, :4], q[:, 4:9] / 3.0], axis=-1)
    # fold the (atom-independent) Cartesian chain rule into one small matrix
    # and build the stencil from separable spline-derivative products —
    # avoids every (N, 216, H)-wide intermediate of the direct formulation
    alpha = q @ spread_mixing_matrix(dug_dx, lmax)  # (N, T)
    return m_u0, u0, alpha


def _stencil_flat_index(m_u0, grid_shape, order: int):
    """(N, order^3) flat indices of each atom's periodic stencil points in the
    row-major (K1, K2, K3) mesh."""
    k1, k2, k3 = grid_shape
    offsets = jnp.arange(-(order // 2), order // 2)
    idx1 = jnp.mod(m_u0[:, 0:1] + offsets[None, :], k1)  # (N, order)
    idx2 = jnp.mod(m_u0[:, 1:2] + offsets[None, :], k2)
    idx3 = jnp.mod(m_u0[:, 2:3] + offsets[None, :], k3)
    return (
        (idx1[:, :, None, None] * k2 + idx2[:, None, :, None]) * k3
        + idx3[:, None, None, :]
    ).reshape(m_u0.shape[0], order ** 3)


def spread_to_mesh(positions, box, q_harm, grid_shape, lmax: int,
                   atom_chunk: int | None = None,
                   precision: str | None = None,
                   mesh_dtype=None, order: int = 6):
    """Spread harmonic multipoles onto the (K1, K2, K3) charge mesh.

    Quadrupole channels carry the 1/3 prefactor of the MPID convention
    (reference: admp/recip.py:300-310). The mesh is accumulated with one flat
    scatter-add; its transpose (the force-interpolation gather) is a flat
    gather of the same indices.

    ``atom_chunk``: accumulate the mesh over fixed-size atom blocks (lax.scan)
    to bound the (N, T, order^2) weight intermediates at large N.

    ``precision='f64'``: evaluate the B-spline weight pipeline (spline
    polynomials, harmonic gradient operators, per-atom contraction — all tiny
    (N, 6, ...) arrays) in float64 and round the per-atom stencil values back
    to the working dtype before the scatter. Measured on water_1024: the
    weight pipeline carries essentially ALL of the f32 reciprocal force error
    (3.6e-4 -> 6.7e-6 relative with this on; scatter/FFT/convolution rounding
    is negligible). Requires jax_enable_x64.

    ``mesh_dtype``: accumulate the mesh in this dtype instead of the working
    dtype (the full-f64 reciprocal path scatters float64 stencil values into a
    float64 grid).
    """
    k1, k2, k3 = grid_shape
    if atom_chunk is not None and positions.shape[0] > atom_chunk:
        n = positions.shape[0]
        n_pad = (-n) % atom_chunk
        pos_p = jnp.concatenate([positions, jnp.zeros((n_pad, 3), positions.dtype)])
        q_p = jnp.concatenate(
            [q_harm, jnp.zeros((n_pad, q_harm.shape[1]), q_harm.dtype)]
        )
        pos_b = pos_p.reshape(-1, atom_chunk, 3)
        q_b = q_p.reshape(-1, atom_chunk, q_harm.shape[1])

        def body(mesh, blk):
            p_blk, q_blk = blk
            return mesh + spread_to_mesh(
                p_blk, box, q_blk, grid_shape, lmax, None, precision,
                mesh_dtype, order,
            ), 0.0

        mesh0 = jnp.zeros((k1, k2, k3), mesh_dtype or q_harm.dtype)
        mesh, _ = jax.lax.scan(body, mesh0, (pos_b, q_b))
        return mesh

    m_u0, u0, alpha = atom_spread_alpha(
        positions, box, q_harm, grid_shape, lmax, order, precision
    )
    q_points = spread_points_separable(u0, alpha, lmax, order)
    q_points = q_points.astype(mesh_dtype or q_harm.dtype)
    flat = _stencil_flat_index(m_u0, grid_shape, order).reshape(-1)
    mesh = jnp.zeros((k1 * k2 * k3,), dtype=q_points.dtype)
    return mesh.at[flat].add(q_points.reshape(-1)).reshape(k1, k2, k3)


def spread_to_mesh_multi(positions, box, coeffs, grid_shape, order: int = 6):
    """Spread C independent scalar (lmax=0) channels in one pass.

    The dispersion PME needs three charge grids (C6, C8, C10 coefficients,
    reference: admp/disp_pme.py:115-119) over identical B-spline geometry —
    the reference runs three full spread pipelines; here the per-atom stencil
    weights are computed once and scattered with a leading channel axis.

    Args:
      coeffs: (N, C) per-atom channel coefficients.
    Returns:
      (C, K1, K2, K3) meshes, channel axis leading so the batched FFT runs
      over contiguous channel grids.
    """
    k1, k2, k3 = grid_shape
    n = positions.shape[0]
    m_u0, u0, _ = mesh_coordinates(positions, box, grid_shape, order)
    if order == 4:
        m = bsplines.spline_values4(u0)  # (N, 4, 3)
    else:
        m = bsplines.spline_values(u0)  # (N, 6, 3)
    txy = (m[:, :, None, 0] * m[:, None, :, 1]).reshape(n, order * order)
    theta = (txy[:, :, None] * m[:, None, :, 2]).reshape(n, order ** 3)

    flat = _stencil_flat_index(m_u0, grid_shape, order)
    n_ch = coeffs.shape[-1]
    # one flat 1D scatter over all channels: channel c lives at offset c*K^3
    kcube = k1 * k2 * k3
    all_idx = (flat[None, :, :] + (jnp.arange(n_ch) * kcube)[:, None, None])
    vals = theta[None, :, :] * coeffs.T[:, :, None]  # (C, N, order^3)
    mesh = jnp.zeros((n_ch * kcube,), dtype=theta.dtype)
    mesh = mesh.at[all_idx.reshape(-1)].add(vals.reshape(-1))
    return mesh.reshape(n_ch, k1, k2, k3)


def convolve_energy_multi(meshes, box, kappa, ck_fns, include_gamma, prefactor=1.0,
                          order: int = 6):
    """Influence-function convolution for channel-stacked (C, K1, K2, K3)
    meshes (one rfft batched over the leading channel axis)."""
    grid_shape = meshes.shape[1:]
    volume = det3x3(box)
    ksq, theta_sq = k_space_grids(box, grid_shape, meshes.dtype, rfft=True,
                                  order=order)
    s_k = jnp.fft.rfftn(meshes, axes=(1, 2, 3))
    s_sq = jnp.real(s_k * jnp.conj(s_k))  # (C, K1, K2, K3h)

    nonzero = ksq > 0.0
    ksq_safe = jnp.where(nonzero, ksq, 1.0)
    w3 = _hermitian_weights(grid_shape[2], meshes.dtype)
    energy = 0.0
    for c, ck_fn in enumerate(ck_fns):
        c_k = jnp.where(nonzero, ck_fn(ksq_safe, kappa, volume), 0.0)
        e_c = jnp.sum((c_k / theta_sq * w3[None, None, :]) * s_sq[c])
        if include_gamma:
            c0 = ck_fn.at_zero(kappa, volume)
            e_c = e_c + c0 * s_sq[c, 0, 0, 0] / theta_sq[0, 0, 0]
        energy = energy + e_c
    return prefactor * energy


def make_disp_pme_recip(ck_fns, kappa, grid_shape, static_box=None,
                        spread_order: int = 6):
    """Multi-channel dispersion reciprocal engine: one spread, one batched FFT
    for all C6/C8/C10 grids (3x fewer scatter and FFT passes than the
    per-channel pipeline the reference uses, admp/disp_pme.py:61-77).

    ``static_box``: when the cell is fixed (NVT/NVE MD), pass the box here to
    precompute the erfc-based influence grids once as device constants —
    the per-step convolution reduces to multiply-and-sum. Box gradients
    (virial) through the dispersion influence term are then *not* tracked;
    leave None for NPT / virial workloads.
    """
    grid_shape = tuple(int(k) for k in grid_shape)
    ck_fns = tuple(ck_fns)

    cached = None
    if static_box is not None:
        box0 = jnp.asarray(static_box)
        dtype = jnp.zeros(0).dtype
        weights, gammas = [], []
        for ck_fn in ck_fns:
            w, g = influence_weights(
                box0, grid_shape, kappa, ck_fn, True, spread_order, dtype
            )
            weights.append(w)
            gammas.append(g)
        cached = (tuple(weights), tuple(gammas))

    def disp_recip(positions, box, c_list):
        if cached is not None:
            box = _cached_influence_box_guard(box)
        meshes = spread_to_mesh_multi(
            positions, box, c_list[:, : len(ck_fns)], grid_shape, spread_order,
        )
        if cached is not None:
            weights, gammas = cached
            s_k = jnp.fft.rfftn(meshes, axes=(1, 2, 3))
            s_sq = jnp.real(s_k * jnp.conj(s_k))  # (C, K1, K2, K3h)
            energy = 0.0
            for c in range(len(ck_fns)):
                energy = energy + jnp.sum(
                    weights[c].astype(s_sq.dtype) * s_sq[c]
                ) + gammas[c] * s_sq[c, 0, 0, 0]
            return energy
        return convolve_energy_multi(meshes, box, kappa, ck_fns, True,
                                     order=spread_order)
    # NOTE: dispersion spreading is lmax=0 (theta only), whose intermediates
    # are (N, 216)-shaped after the outer product — no chunking needed at 100k

    return disp_recip


@jax.custom_jvp
def _cached_influence_box_guard(box):
    """Identity on the box that makes cache_influence box-differentiation
    LOUD and CONSISTENT instead of silently partial.

    A cache_influence engine precomputes C(k^2)/theta^2 for a fixed cell, so
    the influence term's box dependence is untracked while the spread's is —
    naive differentiation would return a wrong, *finite* virial. When the box
    is perturbed through this guard (grad/jvp/vjp w.r.t. box — including the
    broad linearizations the implicit-SCF adjoint performs and then
    discards), it (a) emits a prominent warning and (b) ZEROS the tangent, so
    the guarded engine contributes exactly no box gradient rather than a
    misleading partial one. Plain jit tracing and position/parameter
    gradients are unaffected (their box tangent is a symbolic zero)."""
    return box


@partial(_cached_influence_box_guard.defjvp, symbolic_zeros=True)
def _cached_influence_box_guard_jvp(primals, tangents):
    import warnings

    (box,) = primals
    (t,) = tangents
    if not isinstance(t, jax.custom_derivatives.SymbolicZero):
        warnings.warn(
            "cache_influence=True: box gradients through this reciprocal "
            "engine are NOT tracked (the influence grid is precomputed for a "
            "fixed cell); the engine contributes ZERO box gradient. Harmless "
            "unless you consume dE/dbox (virial/NPT) — then rebuild with "
            "cache_influence=False. (May fire from internal linearizations, "
            "e.g. the implicit-SCF adjoint, even for position-only forces.)",
            stacklevel=2,
        )
        t = jax.tree_util.tree_map(jnp.zeros_like, box)
    return box, t


def _fft_int_freqs(n: int):
    """Integer FFT frequencies [0, 1, ..., -1] matching fftn output layout."""
    return jnp.where(
        jnp.arange(n) <= n // 2 - (1 - n % 2), jnp.arange(n), jnp.arange(n) - n
    )


def k_space_grids(box, grid_shape, dtype, rfft=False, order: int = 6):
    """Return (ksq, theta_k_sq) broadcast grids.

    With ``rfft=True`` the last axis covers only the non-negative frequencies
    (length K3//2 + 1), matching ``jnp.fft.rfftn`` output. ``order`` selects
    the B-spline Euler deconvolution factor (6 default; 4 for the dispersion
    spread option).
    """
    k1, k2, k3 = grid_shape
    box_inv = inv3x3(box).astype(dtype)
    f1 = _fft_int_freqs(k1).astype(dtype)
    f2 = _fft_int_freqs(k2).astype(dtype)
    if rfft:
        f3 = jnp.arange(k3 // 2 + 1, dtype=dtype)
    else:
        f3 = _fft_int_freqs(k3).astype(dtype)
    # k_cart[c] = 2 pi sum_i f_i * box_inv[i, c]
    kvec = (
        f1[:, None, None, None] * box_inv[0][None, None, None, :]
        + f2[None, :, None, None] * box_inv[1][None, None, None, :]
        + f3[None, None, :, None] * box_inv[2][None, None, None, :]
    ) * (2.0 * jnp.pi)
    ksq = jnp.sum(kvec * kvec, axis=-1)

    euler = (
        bsplines.euler_spline_theta4 if order == 4
        else bsplines.euler_spline_theta
    )
    t1 = euler(f1, k1)
    t2 = euler(f2, k2)
    t3 = euler(f3, k3)
    theta_k = t1[:, None, None] * t2[None, :, None] * t3[None, None, :]
    return ksq, theta_k * theta_k


def _hermitian_weights(k3: int, dtype):
    """Multiplicities of rfft modes in the full spectrum: the k3=0 plane (and
    the Nyquist plane for even K3) appear once, every other mode twice."""
    k3h = k3 // 2 + 1
    w = jnp.full((k3h,), 2.0, dtype=dtype)
    w = w.at[0].set(1.0)
    if k3 % 2 == 0:
        w = w.at[k3h - 1].set(1.0)
    return w


def influence_weights(box, grid_shape, kappa, ck_fn, include_gamma: bool,
                      order: int = 6, dtype=None):
    """Precompute the fixed-cell influence grid C(k^2)/theta^2 (with Hermitian
    multiplicity folded in) over the rfft half-spectrum, plus the gamma-point
    factor. The cache_influence fast path — shared by the single-device
    engines (make_pme_recip / make_disp_pme_recip) and the sharded layer
    (parallel/sharded.py slices its K2 pencil chunk out of this grid)."""
    box0 = jnp.asarray(box)
    dtype = dtype or box0.dtype
    ksq, theta_sq = k_space_grids(
        box0.astype(dtype), grid_shape, dtype, rfft=True, order=order
    )
    volume = det3x3(box0.astype(dtype))
    w3 = _hermitian_weights(grid_shape[2], dtype)
    nonzero = ksq > 0.0
    ksq_safe = jnp.where(nonzero, ksq, 1.0)
    c_k = jnp.where(nonzero, ck_fn(ksq_safe, kappa, volume), 0.0)
    weight = c_k / theta_sq * w3[None, None, :]
    gamma0 = (
        ck_fn.at_zero(kappa, volume) / theta_sq[0, 0, 0]
        if include_gamma
        else None
    )
    return weight, gamma0


def convolve_energy(mesh, box, kappa, ck_fn, include_gamma: bool, prefactor=1.0,
                    compensated: bool = False, dft: bool = False,
                    order: int = 6):
    """E = prefactor * sum_k C(k^2) |S_k|^2 / theta_k^2.

    The mesh is real, so the spectrum is Hermitian: an rfft over the last axis
    plus multiplicity weights halves the FFT, the influence evaluation, and
    their adjoints relative to a full complex FFT. A float64 mesh keeps the
    FFT, the influence evaluation and the Parseval sum in float64.
    """
    grid_shape = mesh.shape
    box = box.astype(mesh.dtype)
    volume = det3x3(box)
    ksq, theta_sq = k_space_grids(box, grid_shape, mesh.dtype, rfft=True,
                                  order=order)
    s_sq = spectrum_sq_dft(mesh) if dft else spectrum_sq(mesh)

    nonzero = ksq > 0.0
    ksq_safe = jnp.where(nonzero, ksq, 1.0)
    c_k = jnp.where(nonzero, ck_fn(ksq_safe, kappa, volume), 0.0)
    w3 = _hermitian_weights(grid_shape[2], mesh.dtype)
    energy = _reduce_energy((c_k / theta_sq * w3[None, None, :]) * s_sq,
                            compensated)
    if include_gamma:
        c0 = ck_fn.at_zero(kappa, volume)
        energy = energy + c0 * s_sq[0, 0, 0] / theta_sq[0, 0, 0]
    return prefactor * energy


def make_pme_recip(ck_fn, kappa, include_gamma, grid_shape, lmax, prefactor=1.0,
                   spread_precision: str | None = None,
                   recip_precision: str | None = None,
                   compensated: bool = False,
                   static_box=None, spread_order: int = 6):
    """Build a reciprocal-space energy function (positions, box, Q) -> energy.

    Matches the reference factory generate_pme_recip (admp/recip.py:21) with
    pme_order fixed at 6 (the only order the reference implements).

    ``static_box``: fixed-cell fast path — precompute the influence grid
    C(k^2)/theta_k^2 (erfc/exp over ~K^3/2 modes) once as a device constant;
    the per-step convolution reduces to FFT + multiply-and-sum. Box gradients
    (virial) through the influence term are then NOT tracked; leave None for
    NPT/virial workloads. (Same contract as the dispersion engine's
    cache_influence.)

    ``recip_precision='f64'``: float64 mesh accumulation, float64 FFT,
    float64 influence convolution (implies the f64 spread-weight pipeline).
    ``'f64-dft'``: same, but with an explicit-matmul DFT instead of the FFT
    (see spectrum_sq_dft). The energy is returned in the working dtype of
    ``q_harm``.
    """
    grid_shape = tuple(int(k) for k in grid_shape)
    if recip_precision == "ds":
        # double-single engine (ops/dsrecip.py): DS weights + compensated-
        # butterfly FFT + hand-written DS adjoint. Electro-only (ck_1,
        # no gamma), power-of-two grids.
        from admp_tpu.ops.dsrecip import make_ds_pme_recip

        assert not include_gamma, "recip_precision='ds' is electro-only"
        engines = {lmax: make_ds_pme_recip(kappa, grid_shape, lmax, prefactor,
                                           static_box=static_box)}

        def ds_recip(positions, box, q_harm, u_harm=None):
            if u_harm is None:
                e = engines[lmax](positions, box, q_harm)
            else:
                # merge induced dipoles into the dipole channels on ONE mesh
                # (spreading is linear) — the lmax=0+lpol path
                lm = max(lmax, 1)
                if lm not in engines:
                    engines[lm] = make_ds_pme_recip(
                        kappa, grid_shape, lm, prefactor,
                        static_box=static_box,
                    )
                n_ = q_harm.shape[0]
                q4 = jnp.zeros((n_, (lm + 1) ** 2), u_harm.dtype)
                q4 = q4.at[:, : q_harm.shape[1]].set(q_harm)
                q4 = q4.at[:, 1:4].add(u_harm)
                e = engines[lm](positions, box, q4)
            return e.astype(q_harm.dtype)

        return ds_recip
    f64_mode = recip_precision in ("f64", "f64-dft")
    if f64_mode:
        spread_precision = "f64"

    cached = None
    if static_box is not None:
        box0 = jnp.asarray(static_box)
        dtype = jnp.float64 if f64_mode else box0.dtype
        cached = influence_weights(
            box0, grid_shape, kappa, ck_fn, include_gamma, spread_order, dtype
        )

    def pme_recip(positions, box, q_harm, u_harm=None):
        """``u_harm`` (N, 3, harmonic z/x/y order): spread the induced dipoles
        on a SEPARATE lmax=1 mesh and sum the meshes. Spreading is linear in
        the multipoles, so this equals spreading q_harm with u added to its
        dipole channels — but the q_harm mesh is then an identical
        subexpression of the permanent-field computation (b = -field(0))
        inside the same jit, so XLA CSE shares one full spread+FFT between
        the SCF right-hand side and the energy evaluation at u*."""
        if cached is not None:
            box = _cached_influence_box_guard(box)
        atom_chunk = 4096 if positions.shape[0] > 16384 else None
        mesh_dtype = jnp.float64 if f64_mode else None
        mesh = spread_to_mesh(
            positions, box, q_harm, grid_shape, lmax, atom_chunk,
            spread_precision, mesh_dtype, spread_order,
        )
        if u_harm is not None:
            q_u = jnp.concatenate(
                [jnp.zeros((u_harm.shape[0], 1), u_harm.dtype), u_harm],
                axis=-1,
            )
            mesh = mesh + spread_to_mesh(
                positions, box, q_u, grid_shape, 1, atom_chunk,
                spread_precision, mesh_dtype, spread_order,
            )
        if cached is not None:
            weight, gamma0 = cached
            s_sq = (
                spectrum_sq_dft(mesh)
                if recip_precision == "f64-dft"
                else spectrum_sq(mesh)
            )
            energy = _reduce_energy(
                weight.astype(s_sq.dtype) * s_sq, compensated
            )
            if gamma0 is not None:
                energy = energy + gamma0 * s_sq[0, 0, 0]
            energy = prefactor * energy
        else:
            energy = convolve_energy(
                mesh, box, kappa, ck_fn, include_gamma, prefactor, compensated,
                dft=(recip_precision == "f64-dft"), order=spread_order,
            )
        return energy.astype(q_harm.dtype)

    return pme_recip
