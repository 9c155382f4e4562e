"""Double-single (two-float32) arithmetic: ~47-bit-significand values as
(hi, lo) float32 pairs, computed entirely with float32 operations.

Why not jnp.float64? Double-single stays in float32 arithmetic at a ~5-15x
flop overhead that the memory-bound pipelines mostly hide, and — crucially —
admits *hand-written adjoints*; whether it beats native float64 on the GPU is
ROADMAP design item 4. Reverse-mode AD
through error-free transformations silently degrades to plain f32 (in exact
arithmetic every compensation term is identically zero, so AD differentiates
the uncompensated function), which is why the accuracy engines built on this
module (ops/dsrecip.py) ship custom VJPs instead of relying on autodiff.

Representation invariant: x ~= hi + lo with |lo| <= ulp(hi)/2 (a normalized
pair). All operations assume and restore normalization. Error-free transforms
are the classic Dekker/Knuth building blocks; no FMA is assumed (JAX exposes
none), so two_prod uses Dekker splitting (exact for |a| < 2^115, far beyond
any force-field magnitude).

A DS number is just a (hi, lo) tuple of same-shape float32 arrays — a pytree,
so DS values flow through jit/vmap/scan unchanged.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_SPLIT = 4097.0  # 2^ceil(24/2) + 1: Dekker splitter for the 24-bit f32 mantissa


def f32(x):
    return jnp.asarray(x, jnp.float32)


def ds(hi, lo=None):
    """Build a DS pair from float32 arrays (lo defaults to zero)."""
    hi = f32(hi)
    return (hi, jnp.zeros_like(hi) if lo is None else f32(lo))


def from_f64(x):
    """Split a float64 (numpy, host-side) value into an exact DS pair.

    For *constants* (spline/polynomial coefficients, twiddle factors): the
    split is done in numpy so no f64 ever reaches the device.
    """
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return (jnp.asarray(hi), jnp.asarray(lo))


def to_f64(a):
    """Recombine to float64 (host/test use; requires x64)."""
    return np.asarray(a[0], np.float64) + np.asarray(a[1], np.float64)


def two_sum(a, b):
    """Error-free a + b (Knuth): s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b (Dekker, FMA-free): p + e == a * b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(a, b):
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return quick_two_sum(s, e)


def sub(a, b):
    return add(a, neg(b))


def neg(a):
    return (-a[0], -a[1])


def add_f(a, b):
    """DS + plain f32."""
    s, e = two_sum(a[0], b)
    e = e + a[1]
    return quick_two_sum(s, e)


def mul(a, b):
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def mul_f(a, b):
    """DS * plain f32."""
    p, e = two_prod(a[0], b)
    e = e + a[1] * b
    return quick_two_sum(p, e)


def mul_pow2(a, p):
    """Exact scaling by a power of two (f32 array or scalar)."""
    return (a[0] * p, a[1] * p)


def div(a, b):
    q1 = a[0] / b[0]
    r = sub(a, mul_f(b, q1))
    q2 = r[0] / b[0]
    r = sub(r, mul_f(b, q2))
    q3 = r[0] / b[0]
    s, e = quick_two_sum(q1, q2)
    return add_f((s, e), q3)


def recip(b):
    return div(ds(jnp.ones_like(b[0])), b)


def sqrt(a):
    """DS square root (one Karp-Markstein refinement of the f32 root)."""
    y = jnp.sqrt(a[0])
    y_safe = jnp.where(y == 0.0, 1.0, y)
    # r = (a - y^2) / (2y);  sqrt(a) ~= y + r
    y2 = two_prod(y, y)
    diff = sub(a, y2)
    r = diff[0] / (2.0 * y_safe)
    out = quick_two_sum(y, r)
    return (jnp.where(y == 0.0, 0.0, out[0]), jnp.where(y == 0.0, 0.0, out[1]))


def npow(a, n: int):
    """Integer power by repeated squaring."""
    assert n >= 1
    result = None
    base = a
    while n:
        if n & 1:
            result = base if result is None else mul(result, base)
        n >>= 1
        if n:
            base = mul(base, base)
    return result


def poly(x, coeffs_f64):
    """Horner evaluation with exact DS-split float64 coefficients.

    coeffs_f64: numpy array, highest order FIRST.
    """
    cs = [from_f64(c) for c in np.asarray(coeffs_f64, np.float64)]
    acc = ds(jnp.broadcast_to(cs[0][0], x[0].shape),
             jnp.broadcast_to(cs[0][1], x[0].shape))
    for c in cs[1:]:
        acc = add(mul(acc, x), (jnp.broadcast_to(c[0], x[0].shape),
                                jnp.broadcast_to(c[1], x[0].shape)))
    return acc


_LN2 = from_f64(np.log(2.0))
_INV_LN2 = float(1.0 / np.log(2.0))
# exp Taylor 1 + r + r^2/2 + ... + r^9/9!  (|r| <= ln2/2: error ~ 2e-11 rel)
_EXP_COEFFS = np.array(
    [1.0 / float(__import__("math").factorial(k)) for k in range(9, -1, -1)]
)


def exp(a):
    """DS exp. Relative error ~1e-11 over the force-field range
    (arguments in [-90, 90]); underflows to 0 below exp(-87)."""
    k = jnp.round(a[0] * _INV_LN2)
    r = sub(a, mul_f((jnp.broadcast_to(_LN2[0], k.shape),
                      jnp.broadcast_to(_LN2[1], k.shape)), k))
    e_r = poly(r, _EXP_COEFFS)
    # exact power of two: jnp.exp2 is NOT exact for integer args on all
    # backends (measured 4e-6 relative at 2^-104 on CPU); ldexp assembles the
    # exponent bits directly. Split k so the hi/lo parts scale without
    # intermediate under/overflow even when the result is subnormal-adjacent.
    ki = jnp.clip(k, -252.0, 252.0).astype(jnp.int32)
    half1 = ki // 2
    half2 = ki - half1
    s1 = jnp.ldexp(jnp.ones_like(e_r[0]), half1)
    s2 = jnp.ldexp(jnp.ones_like(e_r[0]), half2)
    return (e_r[0] * s1 * s2, e_r[1] * s1 * s2)


# Cody (1969) rational Chebyshev coefficients for erf/erfc (the netlib
# CALERF/SPECFUN constants — f64-grade, ~1e-16 in exact arithmetic).
_ERF_A = np.array([3.16112374387056560e00, 1.13864154151050156e02,
                   3.77485237685302021e02, 3.20937758913846947e03,
                   1.85777706184603153e-1])
_ERF_B = np.array([2.36012909523441209e01, 2.44024637934444173e02,
                   1.28261652607737228e03, 2.84423683343917062e03])
_ERF_C = np.array([5.64188496988670089e-1, 8.88314979438837594e00,
                   6.61191906371416295e01, 2.98635138197400131e02,
                   8.81952221241769090e02, 1.71204761263407058e03,
                   2.05107837782607147e03, 1.23033935479799725e03,
                   2.15311535474403846e-8])
_ERF_D = np.array([1.57449261107098347e01, 1.17693950891312499e02,
                   5.37181101862009858e02, 1.62138957456669019e03,
                   3.29079923573345963e03, 4.36261909014324716e03,
                   3.43936767414372164e03, 1.23033935480374942e03])
_ERF_P = np.array([3.05326634961232344e-1, 3.60344899949804439e-1,
                   1.25781726111229246e-1, 1.60837851487422766e-2,
                   6.58749161529837803e-4, 1.63153871373020978e-2])
_ERF_Q = np.array([2.56852019228982242e00, 1.87295284992346047e00,
                   5.27905102951428412e-1, 6.05183413124413191e-2,
                   2.33520497626869185e-3])
_INV_SQRT_PI = 5.6418958354775628695e-1


def _where(c, a, b):
    return (jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1]))


def erfc(x):
    """DS complementary error function for x >= 0 (relative error ~1e-13;
    the Ewald screening argument kr is always non-negative). Saturates to 0
    past x ~ 9.2 (erfc < 1e-38, below f32 range)."""
    y = x
    ysq = mul(y, y)

    # region 1: x < 0.46875 — erfc = 1 - x P(x^2)/Q(x^2)
    z = ysq
    xnum = mul(z, _bc(from_f64(_ERF_A[4]), z))
    xden = z
    for i in range(3):
        xnum = mul(add(xnum, _bc(from_f64(_ERF_A[i]), z)), z)
        xden = mul(add(xden, _bc(from_f64(_ERF_B[i]), z)), z)
    r1 = div(add(xnum, _bc(from_f64(_ERF_A[3]), z)),
             add(xden, _bc(from_f64(_ERF_B[3]), z)))
    erfc1 = sub(ds(jnp.ones_like(y[0])), mul(y, r1))

    exp_m = exp(neg(ysq))

    # region 2: 0.46875 <= x < 4 — erfc = exp(-x^2) P(x)/Q(x)
    y_s = _where(y[0] >= 0.46875, y, ds(jnp.full_like(y[0], 1.0)))
    xnum = mul(y_s, _bc(from_f64(_ERF_C[8]), y))
    xden = y_s
    for i in range(7):
        xnum = mul(add(xnum, _bc(from_f64(_ERF_C[i]), y)), y_s)
        xden = mul(add(xden, _bc(from_f64(_ERF_D[i]), y)), y_s)
    r2 = div(add(xnum, _bc(from_f64(_ERF_C[7]), y)),
             add(xden, _bc(from_f64(_ERF_D[7]), y)))
    erfc2 = mul(exp_m, r2)

    # region 3: x >= 4 — erfc = exp(-x^2)/x (1/sqrt(pi) - z P(z)/Q(z)), z=1/x^2
    big = y[0] >= 4.0
    z3 = recip(_where(big, ysq, ds(jnp.ones_like(y[0]))))
    xnum = mul(z3, _bc(from_f64(_ERF_P[5]), y))
    xden = z3
    for i in range(4):
        xnum = mul(add(xnum, _bc(from_f64(_ERF_P[i]), y)), z3)
        xden = mul(add(xden, _bc(from_f64(_ERF_Q[i]), y)), z3)
    r3 = mul(z3, div(add(xnum, _bc(from_f64(_ERF_P[4]), y)),
                     add(xden, _bc(from_f64(_ERF_Q[4]), y))))
    r3 = sub(_bc(from_f64(_INV_SQRT_PI), y), r3)
    erfc3 = mul(exp_m, div(r3, _where(big, y, ds(jnp.ones_like(y[0])))))

    out = _where(y[0] < 0.46875, erfc1, _where(big, erfc3, erfc2))
    return out


def _bc(c, like):
    """Broadcast a scalar DS constant to the shape of a DS array."""
    return (jnp.broadcast_to(c[0], like[0].shape),
            jnp.broadcast_to(c[1], like[0].shape))


def sum_pairs(a, axis=None):
    """Accumulate a DS array with pairwise DS additions along ``axis`` (or all
    axes when None) — tree reduction keeps the error O(eps^2 log n).

    Each level adds the even- and odd-indexed halves (two strided slices, one
    DS add — no concatenates); an odd-length tail element is folded into slot
    0 of the halved array, so every level is a single fused elementwise pass
    and total traffic is geometric in the input size."""
    hi, lo = a
    if axis is None:
        hi = hi.reshape(-1)
        lo = lo.reshape(-1)
        axis = 0
    n = hi.shape[axis]

    def sl(x, s):
        idx = [slice(None)] * x.ndim
        idx[axis] = s
        return x[tuple(idx)]

    while n > 1:
        half = n // 2
        part = add((sl(hi, slice(0, 2 * half, 2)),
                    sl(lo, slice(0, 2 * half, 2))),
                   (sl(hi, slice(1, 2 * half, 2)),
                    sl(lo, slice(1, 2 * half, 2))))
        if n % 2:
            tail = (sl(hi, slice(n - 1, n)), sl(lo, slice(n - 1, n)))
            head = (sl(part[0], slice(0, 1)), sl(part[1], slice(0, 1)))
            head = add(head, tail)
            ph = part[0].at[tuple([slice(None)] * axis + [slice(0, 1)])].set(
                head[0])
            pl = part[1].at[tuple([slice(None)] * axis + [slice(0, 1)])].set(
                head[1])
            part = (ph, pl)
        hi, lo = part
        n = half
    sq = [slice(None)] * hi.ndim
    sq[axis] = 0
    return (hi[tuple(sq)], lo[tuple(sq)])
