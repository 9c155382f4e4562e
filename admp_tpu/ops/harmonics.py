"""Multipole representations: Cartesian <-> real spherical harmonics, and frame rotations.

Feature parity with reference: admp/multipole.py (conversion conventions at
multipole.py:17-33, rotations at multipole.py:80-201), but a different construction:

* Conversions are a single constant matrix contraction, batched over any leading shape.
* Rotations are computed by conjugating the equivalent Cartesian tensors with the
  (batched) frame matrices — ``d' = R d`` for dipoles and ``T' = R T R^T`` for
  quadrupoles — instead of the explicitly unrolled 5x5 Wigner-style matrix the
  reference hardcodes (admp/multipole.py:124-171). Mathematically identical on the
  traceless subspace, but expressed as small batched matmuls, and trivially
  correct for composition/inverse properties.

Conventions (matching the reference so force-field files are interchangeable):
  Cartesian order:  [c0, dX, dY, dZ, qXX, qYY, qZZ, qXY, qXZ, qYZ]
  Harmonic order:   [Q00, Q10(z), Q11c(x), Q11s(y), Q20, Q21c, Q21s, Q22c, Q22s]
Frames are (..., 3, 3) rotation matrices with the *local axes in rows*, i.e.
``v_local = R @ v_global``.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

RT3 = 1.73205080757  # sqrt(3), truncated as in reference: admp/multipole.py:14


def _cart2harm_matrix(lmax: int) -> np.ndarray:
    """Constant (n_harm, n_cart) conversion matrix."""
    n_harm = (lmax + 1) ** 2
    n_cart = {0: 1, 1: 4, 2: 10}[lmax]
    m = np.zeros((n_harm, n_cart))
    m[0, 0] = 1.0  # charge
    if lmax >= 1:
        m[1, 3] = 1.0  # Q10  <- dZ
        m[2, 1] = 1.0  # Q11c <- dX
        m[3, 2] = 1.0  # Q11s <- dY
    if lmax >= 2:
        inv_rt3 = 1.0 / RT3
        m[4, 6] = 1.0           # Q20  <- qZZ
        m[5, 8] = 2.0 * inv_rt3  # Q21c <- qXZ
        m[6, 9] = 2.0 * inv_rt3  # Q21s <- qYZ
        m[7, 4] = inv_rt3        # Q22c <- qXX
        m[7, 5] = -inv_rt3       #       - qYY
        m[8, 7] = 2.0 * inv_rt3  # Q22s <- qXY
    return m


def _harm2cart_matrix(lmax: int) -> np.ndarray:
    """Pseudo-inverse of _cart2harm_matrix on the traceless subspace."""
    n_harm = (lmax + 1) ** 2
    n_cart = {0: 1, 1: 4, 2: 10}[lmax]
    m = np.zeros((n_cart, n_harm))
    m[0, 0] = 1.0
    if lmax >= 1:
        m[1, 2] = 1.0  # dX <- Q11c
        m[2, 3] = 1.0  # dY <- Q11s
        m[3, 1] = 1.0  # dZ <- Q10
    if lmax >= 2:
        m[4, 4] = -0.5
        m[4, 7] = RT3 / 2.0   # qXX
        m[5, 4] = -0.5
        m[5, 7] = -RT3 / 2.0  # qYY
        m[6, 4] = 1.0         # qZZ
        m[7, 8] = RT3 / 2.0   # qXY
        m[8, 5] = RT3 / 2.0   # qXZ
        m[9, 6] = RT3 / 2.0   # qYZ
    return m


def convert_cart2harm(theta, lmax: int):
    """Cartesian multipoles -> real spherical harmonics.

    Args:
      theta: (..., n_cart) Cartesian multipoles (n_cart = 1, 4 or 10; extra trailing
        components beyond what ``lmax`` needs are ignored, matching the reference's
        behavior of slicing the first 10 columns).
      lmax: 0, 1 or 2.
    Returns:
      (..., (lmax+1)**2) harmonic multipoles.
    """
    if lmax > 2:
        raise NotImplementedError("l > 2 (beyond quadrupole) not supported")
    n_cart = {0: 1, 1: 4, 2: 10}[lmax]
    mat = jnp.asarray(_cart2harm_matrix(lmax), dtype=theta.dtype)
    return theta[..., :n_cart] @ mat.T


def convert_harm2cart(q, lmax: int):
    """Real spherical harmonics -> Cartesian multipoles (traceless quadrupole)."""
    if lmax > 2:
        raise NotImplementedError("l > 2 (beyond quadrupole) not supported")
    mat = jnp.asarray(_harm2cart_matrix(lmax), dtype=q.dtype)
    return q @ mat.T


def quad_harm_to_tensor(q2):
    """(..., 5) l=2 harmonic components -> (..., 3, 3) traceless symmetric tensor."""
    q20, q21c, q21s, q22c, q22s = (q2[..., k] for k in range(5))
    h = RT3 / 2.0
    xx = -0.5 * q20 + h * q22c
    yy = -0.5 * q20 - h * q22c
    zz = q20
    xy = h * q22s
    xz = h * q21c
    yz = h * q21s
    row_x = jnp.stack([xx, xy, xz], axis=-1)
    row_y = jnp.stack([xy, yy, yz], axis=-1)
    row_z = jnp.stack([xz, yz, zz], axis=-1)
    return jnp.stack([row_x, row_y, row_z], axis=-2)


def quad_tensor_to_harm(t):
    """(..., 3, 3) traceless symmetric tensor -> (..., 5) l=2 harmonics."""
    inv = 2.0 / RT3
    q20 = t[..., 2, 2]
    q21c = inv * t[..., 0, 2]
    q21s = inv * t[..., 1, 2]
    q22c = (t[..., 0, 0] - t[..., 1, 1]) / RT3
    q22s = inv * t[..., 0, 1]
    return jnp.stack([q20, q21c, q21s, q22c, q22s], axis=-1)


def _rotate_harm(q, rot, lmax: int):
    """Rotate harmonic multipoles by (..., 3, 3) rotation matrices ``rot``
    (acting on Cartesian vectors as v' = rot @ v)."""
    parts = [q[..., 0:1]]
    if lmax >= 1:
        # harmonic dipole order (z, x, y) -> cartesian (x, y, z)
        d_cart = jnp.stack([q[..., 2], q[..., 3], q[..., 1]], axis=-1)
        d_rot = jnp.einsum("...ij,...j->...i", rot, d_cart)
        parts.append(jnp.stack([d_rot[..., 2], d_rot[..., 0], d_rot[..., 1]], axis=-1))
    if lmax >= 2:
        t = quad_harm_to_tensor(q[..., 4:9])
        t_rot = jnp.einsum("...ij,...jk,...lk->...il", rot, t, rot)
        parts.append(quad_tensor_to_harm(t_rot))
    return jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]


def rotate_harm_components(q, f, lmax: int):
    """Rotate harmonic multipole components by per-pair frames, all in (C,)
    component form (same math as ops/harmonics._rotate_harm).

    ``q``: sequence of (C,) harmonic components; ``f``: 9-tuple of frame
    entries (fxx..fzz, rows = local x, y, z axes).
    """
    fxx, fxy, fxz, fyx, fyy, fyz, fzx, fzy, fzz = f
    out = [q[0]]
    if lmax >= 1:
        # harmonic dipole order (z, x, y) -> cartesian
        cx, cy, cz = q[2], q[3], q[1]
        lx = fxx * cx + fxy * cy + fxz * cz
        ly = fyx * cx + fyy * cy + fyz * cz
        lz = fzx * cx + fzy * cy + fzz * cz
        out += [lz, lx, ly]
    if lmax >= 2:
        q20, q21c, q21s, q22c, q22s = q[4], q[5], q[6], q[7], q[8]
        h = RT3 / 2.0
        txx = -0.5 * q20 + h * q22c
        tyy = -0.5 * q20 - h * q22c
        tzz = q20
        txy = h * q22s
        txz = h * q21c
        tyz = h * q21s
        # T' = F T F^T via u[a] = F[a] . T (T symmetric)
        ux_x = fxx * txx + fxy * txy + fxz * txz
        ux_y = fxx * txy + fxy * tyy + fxz * tyz
        ux_z = fxx * txz + fxy * tyz + fxz * tzz
        uy_x = fyx * txx + fyy * txy + fyz * txz
        uy_y = fyx * txy + fyy * tyy + fyz * tyz
        uy_z = fyx * txz + fyy * tyz + fyz * tzz
        uz_x = fzx * txx + fzy * txy + fzz * txz
        uz_y = fzx * txy + fzy * tyy + fzz * tyz
        uz_z = fzx * txz + fzy * tyz + fzz * tzz
        tpxx = ux_x * fxx + ux_y * fxy + ux_z * fxz
        tpyy = uy_x * fyx + uy_y * fyy + uy_z * fyz
        tpzz = uz_x * fzx + uz_y * fzy + uz_z * fzz
        tpxy = ux_x * fyx + ux_y * fyy + ux_z * fyz
        tpxz = ux_x * fzx + ux_y * fzy + ux_z * fzz
        tpyz = uy_x * fzx + uy_y * fzy + uy_z * fzz
        inv = 2.0 / RT3
        out += [tpzz, inv * tpxz, inv * tpyz, (tpxx - tpyy) / RT3,
                inv * tpxy]
    return tuple(out)



def rot_global2local(q_global, frames, lmax: int = 2):
    """Rotate harmonic multipoles from the global frame into per-site local frames.

    Parity with reference: admp/multipole.py:92-179. ``frames`` is (..., 3, 3) with
    local axes in rows.
    """
    return _rotate_harm(q_global, frames, lmax)


def rot_local2global(q_local, frames, lmax: int = 2):
    """Inverse of :func:`rot_global2local` (reference: admp/multipole.py:183-201)."""
    return _rotate_harm(q_local, jnp.swapaxes(frames, -2, -1), lmax)


def rot_dipole_global2local(u_harm, frames):
    """Rotate bare harmonic-ordered dipoles (z, x, y) global -> local.

    Parity with reference: admp/multipole.py:80-89 (rot_ind_global2local).
    """
    d_cart = jnp.stack([u_harm[..., 1], u_harm[..., 2], u_harm[..., 0]], axis=-1)
    d_rot = jnp.einsum("...ij,...j->...i", frames, d_cart)
    return jnp.stack([d_rot[..., 2], d_rot[..., 0], d_rot[..., 1]], axis=-1)


def cart_dipole_to_harm(u_cart):
    """Cartesian dipoles (x, y, z) -> harmonic order (z, x, y).

    Used to merge induced dipoles into the harmonic multipole array
    (reference: admp/pme.py:233-236).
    """
    return jnp.stack([u_cart[..., 2], u_cart[..., 0], u_cart[..., 1]], axis=-1)


def harm_dipole_to_cart(u_harm):
    return jnp.stack([u_harm[..., 1], u_harm[..., 2], u_harm[..., 0]], axis=-1)


def rot_local2global_components(q_local, frame_comps, lmax: int = 2):
    """Local -> global rotation via frame *components* (see
    ops/frames.local_frames_components): rotates with F^T and restacks to an
    (N, H) array — the only (N, H)-materialization point of the per-atom
    pipeline."""
    f = frame_comps
    ft = (f[0], f[3], f[6], f[1], f[4], f[7], f[2], f[5], f[8])
    q_comps = tuple(q_local[..., k] for k in range((lmax + 1) ** 2))
    return jnp.stack(rotate_harm_components(q_comps, ft, lmax), axis=-1)
