"""Bonded (valence) terms: harmonic bonds and angles.

The reference delegates all bonded interactions to OpenMM (its XMLs carry
<HarmonicBondForce>/<HarmonicAngleForce> blocks that ADMP itself never reads,
e.g. examples/water_1024/mpidwater.xml:16-21); without them no stand-alone MD
is possible. This module implements them with fixed index arrays, fully
vectorized, differentiable. OpenMM conventions: E = k/2 (r - r0)^2 and
E = k/2 (theta - theta0)^2, with k and lengths converted to the engine's
A / kJ/mol units by the caller (nm^2 -> A^2 divides k by 100).
"""

from __future__ import annotations

import jax.numpy as jnp
from admp_tpu.utils.linalg3 import inv3x3

from admp_tpu.ops.pbc import pbc_shift


def harmonic_bond_energy(positions, box, bond_idx, r0, k):
    """Sum of k/2 (|r_i - r_j| - r0)^2 over bonds.

    Args:
      bond_idx: (B, 2) int atom indices.
      r0, k: (B,) equilibrium lengths (A) and force constants (kJ/mol/A^2).
    """
    box_inv = inv3x3(box)
    dr = pbc_shift(
        positions[bond_idx[:, 0]] - positions[bond_idx[:, 1]], box, box_inv
    )
    r = jnp.sqrt(jnp.sum(dr * dr, axis=-1))
    return jnp.sum(0.5 * k * (r - r0) ** 2)


def harmonic_angle_energy(positions, box, angle_idx, theta0, k):
    """Sum of k/2 (theta - theta0)^2 over angle triplets (i, j, k): j central.

    Args:
      angle_idx: (A, 3) int indices.
      theta0, k: (A,) equilibrium angles (rad) and constants (kJ/mol/rad^2).
    """
    box_inv = inv3x3(box)
    v1 = pbc_shift(
        positions[angle_idx[:, 0]] - positions[angle_idx[:, 1]], box, box_inv
    )
    v2 = pbc_shift(
        positions[angle_idx[:, 2]] - positions[angle_idx[:, 1]], box, box_inv
    )
    cosang = jnp.sum(v1 * v2, axis=-1) / (
        jnp.linalg.norm(v1, axis=-1) * jnp.linalg.norm(v2, axis=-1)
    )
    theta = jnp.arccos(jnp.clip(cosang, -1.0 + 1e-12, 1.0 - 1e-12))
    return jnp.sum(0.5 * k * (theta - theta0) ** 2)


def water_bonded_terms(n_mol: int):
    """Index/parameter arrays for the MPID water bonded terms
    (examples/water_1024/mpidwater.xml:16-21, converted to A / kJ/mol)."""
    import numpy as np

    bonds = []
    angles = []
    for m in range(n_mol):
        o, h1, h2 = 3 * m, 3 * m + 1, 3 * m + 2
        bonds += [(o, h1), (o, h2)]
        angles.append((h1, o, h2))
    bond_idx = np.array(bonds, dtype=np.int32)
    angle_idx = np.array(angles, dtype=np.int32)
    r0 = np.full(len(bonds), 0.9572)
    k_bond = np.full(len(bonds), 376560.0 / 100.0)  # kJ/mol/nm^2 -> A^2
    theta0 = np.full(len(angles), 1.82421813418)
    k_angle = np.full(len(angles), 460.24)
    return bond_idx, r0, k_bond, angle_idx, theta0, k_angle
