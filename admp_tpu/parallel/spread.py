"""Distributed B-spline spreading with halo exchange at shard boundaries.

The round-2 sharded layer spread every device's atom block onto a PRIVATE
full-size (K1, K2, K3) mesh and reduce-scattered it into slabs — correct, but
per-device grid memory was O(K^3) (131 MB at K=320), not O(K^3 / P): grid
memory did not actually distribute (SURVEY section 5 calls for "sharded
scatter-add spreading with halo exchange at shard boundaries").

Here the spread is domain-decomposed over the leading grid axis:

1. Each device evaluates its local atoms' spread payload — base mesh index,
   fractional offsets u0, and the separable-term coefficients alpha
   (ops/reciprocal.atom_spread_alpha): ~16 scalars/atom, NOT the order^3
   stencil.
2. Atoms are binned by the slab that owns their base x-row and redistributed
   with ONE fixed-capacity ``all_to_all`` (the payload is tiny compared to the
   stencil, let alone the mesh).
3. Each device evaluates the order^3 stencils of the atoms it received and
   scatter-adds them into its (K1/P + order-1, K2, K3) slab — the only grid
   allocation anywhere, O(K^3 / P + halo).
4. The (order-1)-row halo is folded into the +1 ring neighbor with
   ``ppermute`` (ceil((order-1)/(K1/P)) hops when slabs are narrower than the
   stencil); the ring also realizes the periodic x-wrap.

Everything is jax-native (gather, all_to_all, scatter, ppermute), so reverse-
mode AD shards for free: the all_to_all/ppermute transposes are themselves
collectives, and the scatter transpose is the local force-interpolation
gather.

Capacity semantics: the per-(source, target) bin capacity is static
(``cap_factor`` x the uniform share). A denser-than-capacity bin cannot fall
back on-device without materializing the full mesh (which would defeat the
memory scaling), so overflow NaN-poisons the slab instead — a loud, detectable
failure (forces/energies go NaN) rather than silently dropped charge. Liquids
are near-uniform in x; the default 3x headroom is generous.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from admp_tpu.ops.reciprocal import atom_spread_alpha, spread_points_separable
from admp_tpu.ops import bsplines


def _ring_perm(n_dev: int):
    return [(i, (i + 1) % n_dev) for i in range(n_dev)]


def _bin_by_slab(owner, n_dev: int, cap: int):
    """Group local atom indices by target slab: (P, cap) gather indices, a
    validity mask, and an overflow flag (any bin denser than cap)."""
    n = owner.shape[0]
    order = jnp.argsort(owner)
    sorted_owner = owner[order]
    dev_iota = jnp.arange(n_dev, dtype=jnp.int32)
    starts = jnp.searchsorted(sorted_owner, dev_iota).astype(jnp.int32)
    ends = jnp.searchsorted(sorted_owner, dev_iota + 1).astype(jnp.int32)
    counts = ends - starts
    overflow = jnp.any(counts > cap)
    take = starts[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid = take < ends[:, None]
    take = jnp.minimum(take, n - 1)
    return order[take], valid, overflow


def _halo_fold(buf, width: int, halo: int, axis_name, n_dev: int):
    """Fold the halo rows [width, width+halo) into the +1 ring neighbors.

    When slabs are narrower than the stencil (width < halo) one hop leaves
    residual halo, so iterate ceil(halo / width) times; the ring wrap makes
    the x-periodicity exact."""
    n_folds = -(-halo // max(width, 1))
    perm = _ring_perm(n_dev)
    for _ in range(n_folds):
        tail = buf[width:]
        buf = buf.at[width:].set(0.0)
        recv = jax.lax.ppermute(tail, axis_name, perm)
        buf = buf.at[:halo].add(recv)
    return buf


def _local_slab_spread(base_r, q_points, dev, width, halo, k2, k3, order):
    """Scatter-add received stencil values into this device's halo-padded
    (width + halo, k2, k3) slab buffer: x rows are slab-relative (no wrap —
    halo rows live past width), y/z wrap periodically."""
    lx = base_r[:, 0] - dev.astype(jnp.int32) * width
    offs = jnp.arange(order, dtype=jnp.int32)
    idx1 = lx[:, None] + offs[None, :]                      # (A, order)
    idx2 = jnp.mod(base_r[:, 1:2] + offs[None, :], k2)
    idx3 = jnp.mod(base_r[:, 2:3] + offs[None, :], k3)
    flat = (
        (idx1[:, :, None, None] * k2 + idx2[:, None, :, None]) * k3
        + idx3[:, None, None, :]
    ).reshape(-1)
    buf = jnp.zeros(((width + halo) * k2 * k3,), q_points.dtype)
    buf = buf.at[flat].add(q_points.reshape(-1))
    return buf.reshape(width + halo, k2, k3)


def sharded_spread_halo(positions, box, q_harm, grid_shape, lmax: int,
                        axis_name, n_dev: int, order: int = 6,
                        cap_factor: float = 3.0,
                        precision: str | None = None):
    """Halo-exchange spread of harmonic multipoles, for use INSIDE shard_map.

    Args:
      positions, q_harm: the FULL (replicated) arrays; this device spreads the
        block ``[dev * N/P, (dev+1) * N/P)`` (the same convention the round-2
        atom-sharded spread used).
      grid_shape: (K1, K2, K3) with K1 % n_dev == 0.

    Returns:
      (slab, overflow): the (K1/P, K2, K3) slab owned by this device (the
      layout parallel/fft.rfft3d_pencil consumes) and a replicated bool; when
      True the slab has been NaN-poisoned (bin capacity exceeded — raise
      ``cap_factor``).
    """
    k1, k2, k3 = (int(k) for k in grid_shape)
    width = k1 // n_dev
    halo = order - 1
    half = order // 2
    n = positions.shape[0]
    n_loc = n // n_dev
    dev = jax.lax.axis_index(axis_name)

    pos_loc = jax.lax.dynamic_slice_in_dim(positions, dev * n_loc, n_loc)
    q_loc = jax.lax.dynamic_slice_in_dim(q_harm, dev * n_loc, n_loc)

    m_u0, u0, alpha = atom_spread_alpha(
        pos_loc, box, q_loc, grid_shape, lmax, order, precision
    )
    base_x = jnp.mod(m_u0[:, 0] - half, k1).astype(jnp.int32)
    base_y = jnp.mod(m_u0[:, 1] - half, k2).astype(jnp.int32)
    base_z = jnp.mod(m_u0[:, 2] - half, k3).astype(jnp.int32)
    owner = base_x // width

    cap = min(n_loc, int(-(-n_loc * cap_factor // n_dev)) + 8)
    take, valid, overflow = _bin_by_slab(owner, n_dev, cap)
    overflow = jax.lax.psum(
        overflow.astype(jnp.int32), axis_name
    ) > 0

    # payload per atom: u0 (3) + alpha (T) + base (3 int); invalid rows zeroed
    vmask = valid[..., None]
    u0_b = jnp.where(vmask, u0[take], 0.0)
    alpha_b = jnp.where(vmask, alpha[take], 0.0)
    base_b = jnp.where(
        vmask,
        jnp.stack([base_x, base_y, base_z], -1)[take],
        0,
    )
    # give invalid rows an owner-consistent x so their (zero-weight) scatter
    # rows stay inside the destination slab, spread over its rows
    pad_x = (
        jnp.arange(n_dev, dtype=jnp.int32)[:, None] * width
        + jnp.arange(cap, dtype=jnp.int32)[None, :] % width
    )
    base_b = base_b.at[..., 0].set(
        jnp.where(valid, base_b[..., 0], pad_x)
    )

    a2a = lambda x: jax.lax.all_to_all(
        x, axis_name, split_axis=0, concat_axis=0, tiled=True
    )
    u0_r = a2a(u0_b).reshape(n_dev * cap, 3)
    alpha_r = a2a(alpha_b).reshape(n_dev * cap, alpha.shape[-1])
    base_r = a2a(base_b).reshape(n_dev * cap, 3)

    q_points = spread_points_separable(u0_r, alpha_r, lmax, order)
    q_points = q_points.astype(q_harm.dtype)

    buf = _local_slab_spread(base_r, q_points, dev, width, halo, k2, k3,
                             order)

    buf = _halo_fold(buf, width, halo, axis_name, n_dev)
    slab = buf[:width]
    slab = jnp.where(overflow, jnp.float32(jnp.nan).astype(slab.dtype), slab)
    return slab, overflow


def sharded_spread_halo_multi(positions, box, coeffs, grid_shape,
                              axis_name, n_dev: int, order: int = 6,
                              cap_factor: float = 3.0):
    """Multi-channel (lmax=0) halo-exchange spread: C6/C8/C10 dispersion
    coefficients share one redistribution and one stencil-geometry pass.

    Returns ((C, K1/P, K2, K3) slab, overflow) — channel axis leading, the
    layout the pencil FFT batches over.
    """
    from admp_tpu.ops.reciprocal import mesh_coordinates

    k1, k2, k3 = (int(k) for k in grid_shape)
    width = k1 // n_dev
    halo = order - 1
    half = order // 2
    n = positions.shape[0]
    n_loc = n // n_dev
    n_ch = coeffs.shape[-1]
    dev = jax.lax.axis_index(axis_name)

    pos_loc = jax.lax.dynamic_slice_in_dim(positions, dev * n_loc, n_loc)
    c_loc = jax.lax.dynamic_slice_in_dim(coeffs, dev * n_loc, n_loc)

    m_u0, u0, _ = mesh_coordinates(pos_loc, box, grid_shape, order)
    base_x = jnp.mod(m_u0[:, 0] - half, k1).astype(jnp.int32)
    base_y = jnp.mod(m_u0[:, 1] - half, k2).astype(jnp.int32)
    base_z = jnp.mod(m_u0[:, 2] - half, k3).astype(jnp.int32)
    owner = base_x // width

    cap = min(n_loc, int(-(-n_loc * cap_factor // n_dev)) + 8)
    take, valid, overflow = _bin_by_slab(owner, n_dev, cap)
    overflow = jax.lax.psum(overflow.astype(jnp.int32), axis_name) > 0

    vmask = valid[..., None]
    u0_b = jnp.where(vmask, u0[take], 0.0)
    c_b = jnp.where(vmask, c_loc[take], 0.0)
    base_b = jnp.where(
        vmask, jnp.stack([base_x, base_y, base_z], -1)[take], 0
    )
    pad_x = (
        jnp.arange(n_dev, dtype=jnp.int32)[:, None] * width
        + jnp.arange(cap, dtype=jnp.int32)[None, :] % width
    )
    base_b = base_b.at[..., 0].set(
        jnp.where(valid, base_b[..., 0], pad_x)
    )

    a2a = lambda x: jax.lax.all_to_all(
        x, axis_name, split_axis=0, concat_axis=0, tiled=True
    )
    u0_r = a2a(u0_b).reshape(n_dev * cap, 3)
    c_r = a2a(c_b).reshape(n_dev * cap, n_ch)
    base_r = a2a(base_b).reshape(n_dev * cap, 3)

    if order == 4:
        m = bsplines.spline_values4(u0_r)
    else:
        m = bsplines.spline_values(u0_r, order)
    a = u0_r.shape[0]
    txy = (m[:, :, None, 0] * m[:, None, :, 1]).reshape(a, order * order)
    theta = (txy[:, :, None] * m[:, None, :, 2]).reshape(a, order ** 3)

    lx = base_r[:, 0] - dev.astype(jnp.int32) * width
    offs = jnp.arange(order, dtype=jnp.int32)
    idx1 = lx[:, None] + offs[None, :]
    idx2 = jnp.mod(base_r[:, 1:2] + offs[None, :], k2)
    idx3 = jnp.mod(base_r[:, 2:3] + offs[None, :], k3)
    flat = (
        (idx1[:, :, None, None] * k2 + idx2[:, None, :, None]) * k3
        + idx3[:, None, None, :]
    ).reshape(1, -1)
    kslab = (width + halo) * k2 * k3
    all_idx = flat + (jnp.arange(n_ch) * kslab)[:, None]
    vals = theta[None, :, :] * c_r.T[:, :, None]            # (C, A, order^3)
    buf = jnp.zeros((n_ch * kslab,), theta.dtype)
    buf = buf.at[all_idx.reshape(-1)].add(vals.reshape(-1))
    buf = buf.reshape(n_ch, width + halo, k2, k3)

    # fold halos per channel (one ppermute per hop moves all channels)
    n_folds = -(-halo // max(width, 1))
    perm = _ring_perm(n_dev)
    for _ in range(n_folds):
        tail = buf[:, width:]
        buf = buf.at[:, width:].set(0.0)
        recv = jax.lax.ppermute(tail, axis_name, perm)
        buf = buf.at[:, :halo].add(recv)
    slab = buf[:, :width]
    slab = jnp.where(overflow, jnp.float32(jnp.nan).astype(slab.dtype), slab)
    return slab, overflow
