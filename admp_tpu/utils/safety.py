"""Numerically-safe helpers for masked fixed-shape computation.

XLA wants static shapes: invalid lanes (neighbor-list padding,
self-pairs) are carried through the computation and masked out of the final sum.
That only works if the garbage lanes never produce inf/NaN, because
``jnp.where(mask, good, bad)`` still propagates NaN *gradients* from the bad branch.
The fix is the standard double-where: sanitize the *input* of the singular op.

The reference instead clamps values with host-built ``jnp.piecewise`` closures
(reference: admp/pme.py:351-376); here everything is pure ``jnp.where`` so it
vectorizes and is trivially differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp


def safe_inv(x, mask=None, eps=1e-8):
    """1/x that never divides by ~0. Masked-out lanes return 0."""
    big = jnp.asarray(1.0, x.dtype) / eps
    x_safe = jnp.where(jnp.abs(x) < eps, eps, x)
    out = 1.0 / x_safe
    if mask is not None:
        out = jnp.where(mask, out, 0.0)
    return jnp.minimum(out, big)


def masked_norm(vec, mask, axis=-1, fill=1.0):
    """Euclidean norm along ``axis``; lanes where ``mask`` is False get ``fill``.

    The sqrt input is sanitized *before* the sqrt so reverse-mode AD through
    masked lanes is exactly zero rather than NaN.
    """
    sq = jnp.sum(vec * vec, axis=axis)
    sq_safe = jnp.where(mask, sq, fill * fill)
    return jnp.where(mask, jnp.sqrt(sq_safe), fill)


def safe_normalize(vec, axis=-1, eps=1e-12):
    """Normalize vectors, mapping ~zero vectors to zero instead of NaN."""
    sq = jnp.sum(vec * vec, axis=axis, keepdims=True)
    sq_safe = jnp.where(sq < eps, 1.0, sq)
    return jnp.where(sq < eps, 0.0, vec / jnp.sqrt(sq_safe))


def clamp_min(x, lo):
    """Like jnp.maximum but written so the clamp point is AD-clean."""
    return jnp.where(x < lo, lo, x)


def clamp_max(x, hi):
    return jnp.where(x > hi, hi, x)
