"""Accuracy-corrected elementary functions for float32.

Fast hardware exp approximations can carry ~5e-6 maximum relative error,
~80x worse than a correctly-rounded f32 exp. Every Ewald screening
coefficient multiplies exp(-x^2) against ~1e3..1e4-magnitude prefactors, so
such an error would dominate the engine's f32 force accuracy. Whether the
GPU's own exp needs this correction is ROADMAP design item 3.

``exp_accurate`` recovers near-1-ulp f32 accuracy with classic range reduction:
  exp(y) = 2^k * exp(r),  k = round(y / ln 2),  r = y - k ln2 (|r| <= ln2/2)
with ln 2 split into high/low parts and a degree-7 Taylor polynomial for
exp(r) (|error| < 3e-9 relative on the reduced range). Costs ~15 vector ops
instead of 1 — negligible against the surrounding arithmetic.

float64 (and any non-f32) inputs fall through to jnp.exp: the polynomial is
f32-grade and the f64 path (CPU verification) must keep full precision.
"""

from __future__ import annotations

import jax.numpy as jnp

_LN2_HI = 0.69314575195e0   # high bits of ln 2, exactly representable in f32
_LN2_LO = 1.42860677e-06    # ln 2 - _LN2_HI
_INV_LN2 = 1.4426950408889634


def exp_accurate(y):
    """exp(y) with ~1-ulp f32 accuracy (identity for other dtypes)."""
    if y.dtype != jnp.float32:
        return jnp.exp(y)
    k = jnp.round(y * _INV_LN2)
    r = y - k * _LN2_HI
    r = r - k * _LN2_LO
    # degree-7 Taylor; |r| <= 0.3466 -> truncation < 3e-9 relative
    p = 1.0 / 5040.0
    p = p * r + 1.0 / 720.0
    p = p * r + 1.0 / 120.0
    p = p * r + 1.0 / 24.0
    p = p * r + 1.0 / 6.0
    p = p * r + 0.5
    p = p * r + 1.0
    p = p * r + 1.0
    return jnp.ldexp(p, k.astype(jnp.int32))


def two_sum(a, b):
    """Error-free transform: a + b = s + err exactly (Knuth TwoSum, 6 flops).

    Valid for any rounding mode and magnitude ordering; compiles to pure
    elementwise VPU work.
    """
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


import jax


@jax.custom_vjp
def compensated_sum(x):
    """Sum an array with an error-free TwoSum reduction tree.

    Carries (hi, lo) partials through log2(n) *contiguous-halves* levels
    (contiguous slices, not strided [0::2] gathers): the result error is
    O(n eps^2) instead of the O(log n eps) of a plain tree reduction — in
    float32 that is exact to well below 1 ulp of the true sum for any
    realistic n. Cost: ~8 flops/element.

    The adjoint is defined explicitly as the plain-sum broadcast (the error
    terms' exact derivative is zero); without the custom VJP, reverse-mode AD
    materializes 20 levels of slice/concat transposes.

    Used for the real-space pair-energy, self-energy, and k-space Parseval
    sums where the reference relies on float64 (admp/settings.py:5) — the
    accumulation of ~1e5-magnitude terms into a ~1e2 result is exactly where
    plain f32 summation loses the Ewald cancellation (measured -0.33 kJ/mol
    on water_1024, ROADMAP.md).
    """
    x = x.reshape(-1)
    hi = x
    lo = jnp.zeros_like(x)
    while hi.shape[0] > 1:
        n = hi.shape[0]
        if n % 2:
            hi = jnp.concatenate([hi, jnp.zeros((1,), hi.dtype)])
            lo = jnp.concatenate([lo, jnp.zeros((1,), lo.dtype)])
            n += 1
        half = n // 2
        s, e = two_sum(hi[:half], hi[half:])
        hi = s
        lo = lo[:half] + lo[half:] + e
    return hi[0] + lo[0]


def _compensated_sum_fwd(x):
    return compensated_sum(x), x.shape


def _compensated_sum_bwd(shape, g):
    return (jnp.broadcast_to(g, shape),)


compensated_sum.defvjp(_compensated_sum_fwd, _compensated_sum_bwd)


def masked_compensated_sum(x, mask):
    """compensated_sum(where(mask, x, 0)) without materializing the where
    twice; mask is broadcast against x."""
    return compensated_sum(jnp.where(mask, x, jnp.zeros_like(x)))
