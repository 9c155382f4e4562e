"""Order-6 cardinal B-splines and derivatives, evaluated branch-free.

The reference evaluates the full piecewise polynomial with ``jnp.piecewise`` at all
216 stencil points x 3 dimensions per atom (reference: admp/recip.py:80-137).
``piecewise`` lowers to a cascade of selects over every element. Here we exploit the
PME structure instead: the fractional offset u0 of an atom always lies in [3, 4)
(order/2 shifted, reference: admp/recip.py:77), so the stencil point at offset
k - 3 (k = 0..5) has its argument u = u0 + k - 3 in [k, k+1) — the piecewise branch
is *statically known per stencil offset*. Each spline piece is evaluated exactly
once per dimension with no selects, and the 6x6x6 tensor weights come from an outer
product. This is both exact-to-the-reference math and dramatically cheaper:
6 polynomial evaluations per dimension instead of 216 piecewise dispatches.

Polynomials below are the standard cardinal B-spline pieces B6|[k, k+1); they agree
with reference: admp/recip.py:85-137 (same function, different factored form is NOT
used — coefficients match piece by piece).
"""

from __future__ import annotations

from math import comb

import numpy as np
import jax.numpy as jnp

ORDER = 6

# Power-basis coefficients (c0 + c1 u + ... + c5 u^5) of B6 restricted to [k, k+1),
# obtained by expanding the divided-difference form
#   B6(u) = sum_{j=0..k} (-1)^j C(6, j) (u - j)^5 / 5!   on [k, k+1).
_FACT5 = 120.0


def _piece_coeffs(order: int = ORDER) -> np.ndarray:
    """(order, order) array: row k = power-basis coeffs of B_order on [k, k+1)."""
    from math import comb, factorial

    coeffs = np.zeros((order, order))
    for k in range(order):
        acc = np.zeros(order)
        for j in range(k + 1):
            # expand (u - j)^(order-1)
            sign = (-1.0) ** j * comb(order, j)
            for p in range(order):
                acc[p] += (
                    sign
                    * comb(order - 1, p)
                    * (-float(j)) ** (order - 1 - p)
                )
        coeffs[k] = acc / float(factorial(order - 1))
    return coeffs


_C = _piece_coeffs()              # B6 pieces
_C1 = _C[:, 1:] * np.arange(1, ORDER)   # first derivative pieces
_C2 = _C1[:, 1:] * np.arange(1, ORDER - 1)  # second derivative pieces

_C4B = _piece_coeffs(4)           # B4 pieces
_C4B1 = _C4B[:, 1:] * np.arange(1, 4)
_C4B2 = _C4B1[:, 1:] * np.arange(1, 3)



def _shift_to_local(coeffs: np.ndarray) -> np.ndarray:
    """Re-express each piece k (power basis in u on [k, k+1)) in the local
    variable t = u - k in [0, 1). Same polynomials; evaluating them in t
    avoids the cancellation of large alternating u^p terms, which in
    float32 costs ~1e-4 relative on the small tail pieces."""
    out = np.zeros_like(coeffs)
    for k in range(coeffs.shape[0]):
        # p(t + k) = sum_p c_p (t + k)^p, expanded binomially in t
        for p_, c in enumerate(coeffs[k]):
            for q in range(p_ + 1):
                out[k, q] += c * comb(p_, q) * float(k) ** (p_ - q)
    return out


# (value, d/du, d2/du2) coefficient tables per supported spline order, in
# the local variable t = u0 - order/2 (see _eval_pieces). B4'' is piecewise
# *linear* (C0 at the knots) — usable for quadrupole spreading, at a
# measured accuracy cost (ROADMAP.md history).
_TABLES = {
    6: tuple(_shift_to_local(c) for c in (_C, _C1, _C2)),
    4: tuple(_shift_to_local(c) for c in (_C4B, _C4B1, _C4B2)),
}

# B6 evaluated at the integer knots 1..5 — the Euler spline factors for theta_k
# (reference: admp/recip.py:400-408 evaluates these at runtime; they are constants).
# Exact rational values: [1/120, 26/120, 66/120, 26/120, 1/120]
B6_KNOTS = np.array([1.0, 26.0, 66.0, 26.0, 1.0]) / 120.0


def _eval_pieces(u0, coeff_table):
    """Evaluate each piece k at u = u0 + k - order/2, i.e. at the local
    variable t = u0 - order/2 in [0, 1) of its [k, k+1) interval.

    Args:
      u0: (..., 3) fractional offsets in [order/2, order/2 + 1).
      coeff_table: (order, deg+1) static coefficients in t (_TABLES).
    Returns:
      (..., order, 3): value of stencil offset k (axis -2) per dimension.
    """
    order = coeff_table.shape[0]
    outs = []
    # cast coefficients to the input dtype: numpy f64 scalars would otherwise
    # promote f32 arrays to f64 under jax_enable_x64 (mixed-precision runs)
    table = coeff_table.astype(np.result_type(u0.dtype))
    t = u0 - order / 2.0
    for k in range(order):
        c = table[k]
        acc = jnp.full_like(t, c[-1])
        for p in range(len(c) - 2, -1, -1):
            acc = acc * t + c[p]
        outs.append(acc)
    return jnp.stack(outs, axis=-2)


def spline_values(u0, order: int = ORDER):
    """(..., 3) -> (..., order, 3): B at the stencil offsets per dimension."""
    return _eval_pieces(u0, _TABLES[order][0])


def spline_derivs(u0, order: int = ORDER):
    """First derivatives B' at the stencil offsets per dimension."""
    return _eval_pieces(u0, _TABLES[order][1])


def spline_derivs2(u0, order: int = ORDER):
    """Second derivatives B'' at the stencil offsets per dimension."""
    return _eval_pieces(u0, _TABLES[order][2])


def euler_spline_theta(kpts_int_axis, n_axis):
    """Per-axis Euler factor theta(k) = sum_m B6(m+3) cos(2 pi m k / N).

    Closed form using the constant knot values B6(1..5)
    (reference computes the same sum at runtime: admp/recip.py:400-408):
      theta(k) = 11/20 + (13/30) cos(2 pi k / N) + (1/60) cos(4 pi k / N)
    """
    b = jnp.asarray(B6_KNOTS, dtype=kpts_int_axis.dtype)
    ang = 2.0 * jnp.pi * kpts_int_axis / n_axis
    return b[2] + 2.0 * b[1] * jnp.cos(ang) + 2.0 * b[0] * jnp.cos(2.0 * ang)


# ---------------------------------------------------------------------------
# Order-4 variant (dispersion spreading option: the r^-6..r^-10 kernels are
# far smoother than Coulomb, so a 4^3 = 64-point stencil can replace the
# 216-point one at measured accuracy cost — see EngineConfig.disp_spread_order)
# ---------------------------------------------------------------------------

# B4 at the integer knots 1..3: [1/6, 4/6, 1/6]
B4_KNOTS = np.array([1.0, 4.0, 1.0]) / 6.0


def spline_values4(u0):
    """(..., 3) -> (..., 4, 3): B4 at the four stencil offsets per dimension.

    ``u0`` are fractional offsets in [2, 3) (order/2 = 2 shifted)."""
    return spline_values(u0, 4)


def euler_spline_theta4(kpts_int_axis, n_axis):
    """Per-axis Euler factor for order-4 splines:
    theta(k) = 4/6 + (2/6) cos(2 pi k / N)."""
    b = jnp.asarray(B4_KNOTS, dtype=kpts_int_axis.dtype)
    ang = 2.0 * jnp.pi * kpts_int_axis / n_axis
    return b[1] + 2.0 * b[0] * jnp.cos(ang)
