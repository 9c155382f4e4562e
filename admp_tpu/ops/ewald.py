"""Ewald/PME parameter heuristics.

Parity with reference: admp/pme.py:146-172 (which follows OpenMM's user-guide
formulas), evaluated host-side with numpy because the results (kappa, grid shape)
are static compile-time quantities — grid shapes must be Python ints for jit.
"""

from __future__ import annotations

import numpy as np


def next_fft_friendly(n: int) -> int:
    """Smallest 5-smooth integer >= n (radix-2/3/5 FFTs avoid the slow paths
    of sizes with large prime factors, and a larger mesh is strictly more
    accurate — rounding up loses nothing)."""
    m = int(n)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def setup_ewald_parameters(rc: float, ethresh: float, box) -> tuple:
    """Choose the Ewald splitting parameter and FFT mesh size.

    kappa = sqrt(-log(2*ethresh)) / rc
    K_i   = ceil(2 * kappa * L_i / (3 * ethresh^(1/5)))

    Args:
      rc: real-space cutoff (Angstrom).
      ethresh: target energy accuracy.
      box: (3, 3) lattice vectors in rows (only the diagonal is used, as in the
        reference — orthorhombic assumption for the mesh heuristic).

    Returns:
      (kappa, K1, K2, K3) with integer K's.
    """
    box = np.asarray(box)
    kappa = float(np.sqrt(-np.log(2.0 * ethresh)) / rc)
    ks = [int(np.ceil(2.0 * kappa * box[i, i] / 3.0 / ethresh**0.2)) for i in range(3)]
    return (kappa, ks[0], ks[1], ks[2])


def setup_ewald_parameters_fft(rc: float, ethresh: float, box) -> tuple:
    """As :func:`setup_ewald_parameters` but with mesh sizes rounded up to
    5-smooth values (>= the reference's accuracy)."""
    kappa, k1, k2, k3 = setup_ewald_parameters(rc, ethresh, box)
    return kappa, next_fft_friendly(k1), next_fft_friendly(k2), next_fft_friendly(k3)

