"""Distributed 3D FFT: pencil decomposition with all_to_all transposes between devices.

The reference computes ``jnp.fft.fftn`` on a single device
(reference: admp/recip.py:410) — its only scaling strategy is a bigger chip.
Here the mesh charge grid is sharded over the leading grid axis across devices;
the FFT is computed as
    local FFT over (K2, K3)  ->  all_to_all transpose (K1-shard -> K2-shard)
    ->  local FFT over K1
which keeps every butterfly on-chip and rides the interconnect exactly once.
Designed for use inside ``jax.shard_map``; differentiable (the collectives'
transposes are themselves collectives, so reverse-mode AD shards too).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fft3d_pencil(local_slab, axis_name):
    """Forward 3D FFT of a grid sharded over its leading axis.

    Args:
      local_slab: (K1/P, K2, K3) local real or complex block.
      axis_name: mesh axis name over which the grid is sharded.

    Returns:
      (K1, K2/P, K3) local block of the full FFT, sharded over the *second*
      grid axis (the "transposed pencil" layout). Callers doing diagonal
      k-space multiplies never need to transpose back.
    """
    # FFT over the two locally-complete axes
    x = jnp.fft.fftn(local_slab.astype(jnp.complex64 if local_slab.dtype == jnp.float32 else jnp.complex128), axes=(1, 2))
    # redistribute: split K2 across devices, gather K1
    x = jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=0, tiled=True)
    # FFT over the now-complete leading axis
    return jnp.fft.fft(x, axis=0)


def _rfft_axis2(x):
    """Half-spectrum real FFT over axis 2 without the rfft primitive.

    The rfft primitive silently mis-tracks under shard_map's varying-axes
    bookkeeping (wrong values, round-1 note), and the round-1 workaround — a
    full complex FFT sliced to the half spectrum — pays 2x the local work.
    The classic even/odd packing recovers the rfft cost using only the plain
    complex FFT (whose shard_map rules are fine): pack x[2c], x[2c+1] into a
    length-n/2 complex signal, one FFT, then untangle
        X_k = E_k + e^(-2 pi i k / n) O_k,   k = 0..n/2
    with E/O the even/odd sub-spectra from Z_k and conj(Z_{-k}).
    Requires even n (PME grids always are).
    """
    n = x.shape[2]
    if n % 2:  # odd sizes: fall back to full FFT + slice
        dtype = jnp.complex64 if x.dtype == jnp.float32 else jnp.complex128
        return jnp.fft.fft(x.astype(dtype), axis=2)[..., : n // 2 + 1]
    m = n // 2
    z = x[..., 0::2] + 1j * x[..., 1::2]
    zk = jnp.fft.fft(z, axis=2)
    # Z_{-k mod m}: index 0 -> 0, k -> m-k
    zmk = jnp.conj(jnp.roll(jnp.flip(zk, axis=2), 1, axis=2))
    even = 0.5 * (zk + zmk)
    odd = -0.5j * (zk - zmk)
    w = jnp.exp(-2j * jnp.pi * jnp.arange(m) / n).astype(zk.dtype)
    x_k = even + w * odd
    # Nyquist mode: E and O are m-periodic, so X_{n/2} = E_0 - O_0
    x_nyq = even[..., :1] - odd[..., :1]
    return jnp.concatenate([x_k, x_nyq], axis=2)


def rfft3d_pencil(local_slab, axis_name):
    """Real-input variant of :func:`fft3d_pencil`: the local K3 axis uses a
    true rfft (half spectrum), halving the local axis-2 transform, the
    interconnect traffic, and the per-mode k-space work.

    Returns (K1, K2/P, K3//2 + 1) — pair with Hermitian multiplicity weights
    (see ops/reciprocal._hermitian_weights) for Parseval sums.
    """
    x = _rfft_axis2(local_slab)
    x = jnp.fft.fft(x, axis=1)
    x = jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=0, tiled=True)
    return jnp.fft.fft(x, axis=0)


def local_slab_index(axis_name):
    """Index of this device's slab along the sharded axis."""
    return jax.lax.axis_index(axis_name)
