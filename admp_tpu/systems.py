"""Synthetic example systems (no external data files required).

Provides liquid-density MPID water boxes for tests, benchmarks, and the
multi-chip dry run. Parameters are the MPID water model of the reference's
examples (examples/water_1024/mpidwater.xml; hardcoded TT/dispersion constants
from examples/water_1024/run_admp.py:66-97).
"""

from __future__ import annotations

import numpy as np

# gas-phase-ish water geometry (Angstrom)
_OH = 0.9572
_ANG = np.deg2rad(104.52)

# MPID water multipoles (engine units: dipole x10, quadrupole x300 vs XML)
MPID_WATER = dict(
    c0_O=-1.0614, c0_H=0.5307,
    dZ_O=-0.023671684 * 10,
    qXX_O=0.000150963 * 300, qYY_O=0.00008707 * 300, qZZ_O=-0.000238034 * 300,
    pol_O=0.88, thole_O=8.0,
    # dispersion sqrt-coefficients (C6, C8, C10 columns)
    c_O=(37.19677405, 85.26810658, 134.44874488),
    c_H=(7.6111103, 11.90220148, 15.05074749),
    # Tang-Toennies params
    q_O=-0.741706, q_H=0.370853,
    b_O=2.00095977, b_H=1.999519942,
    a_O=458.3777, a_H=0.0317,
)


def _water_template():
    h1 = np.array([_OH * np.sin(_ANG / 2), 0.0, _OH * np.cos(_ANG / 2)])
    h2 = np.array([-_OH * np.sin(_ANG / 2), 0.0, _OH * np.cos(_ANG / 2)])
    return np.stack([np.zeros(3), h1, h2])


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=0):
    """(positions (N,3), box (3,3)) for n_side^3 waters on a jittered lattice.

    spacing ~3.1 A gives roughly liquid density.
    """
    rng = np.random.default_rng(seed)
    tmpl = _water_template()
    length = n_side * spacing
    positions = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                center = (np.array([ix, iy, iz]) + 0.5) * spacing
                center += rng.uniform(-jitter, jitter, 3)
                rot = _rotation(rng)
                positions.append(tmpl @ rot.T + center)
    return np.concatenate(positions), np.eye(3) * length


def water_system(n_side=2, spacing=3.1, jitter=0.1, seed=0,
                 sparse_exclusions=False):
    """Full per-atom arrays for the MPID water model on a synthetic lattice.

    Returns dict with positions, box, q_cart, axis_types, axis_indices,
    covalent_map, pol, tholes, c_list, tt (a, b, q) arrays (numpy).
    ``sparse_exclusions``: return the covalent map as
    ``ops.exclusions.SparseExclusions`` instead of a dense (N, N) matrix —
    needed at ~100k atoms, where the dense map takes ~40 GB.
    """
    from admp_tpu.io.topology import build_covalent_map_from_bonds
    from admp_tpu.ops import frames as fc
    from admp_tpu.ops.exclusions import build_sparse_exclusions

    p = MPID_WATER
    positions, box = water_lattice(n_side, spacing, jitter, seed)
    nmol = n_side**3
    n = 3 * nmol
    q_cart = np.zeros((n, 10))
    q_cart[0::3, 0] = p["c0_O"]
    q_cart[0::3, 3] = p["dZ_O"]
    q_cart[0::3, 4] = p["qXX_O"]
    q_cart[0::3, 5] = p["qYY_O"]
    q_cart[0::3, 6] = p["qZZ_O"]
    q_cart[1::3, 0] = p["c0_H"]
    q_cart[2::3, 0] = p["c0_H"]
    axis_types = np.tile([fc.BISECTOR, fc.ZTHENX, fc.ZTHENX], nmol)
    axis_indices = np.zeros((n, 3), dtype=np.int32)
    bonds = []
    for m in range(nmol):
        o, h1, h2 = 3 * m, 3 * m + 1, 3 * m + 2
        axis_indices[o] = (h1, h2, -1)
        axis_indices[h1] = (o, h2, -1)
        axis_indices[h2] = (o, h1, -1)
        bonds += [(o, h1), (o, h2)]
    c_list = np.zeros((n, 3))
    c_list[0::3] = p["c_O"]
    c_list[1::3] = p["c_H"]
    c_list[2::3] = p["c_H"]
    return dict(
        positions=positions,
        box=box,
        q_cart=q_cart,
        axis_types=axis_types,
        axis_indices=axis_indices,
        covalent_map=(build_sparse_exclusions if sparse_exclusions
                      else build_covalent_map_from_bonds)(bonds, n, 6),
        pol=np.tile([p["pol_O"], 0.0, 0.0], nmol),
        tholes=np.tile([p["thole_O"], 0.0, 0.0], nmol),
        c_list=c_list,
        tt_a=np.tile([p["a_O"], p["a_H"], p["a_H"]], nmol),
        tt_b=np.tile([p["b_O"], p["b_H"], p["b_H"]], nmol),
        tt_q=np.tile([p["q_O"], p["q_H"], p["q_H"]], nmol),
    )


def write_water_pdb(path, positions, box):
    """Write a synthetic water box as a minimal PDB (O/H1/H2 per residue,
    CRYST1 orthorhombic cell) — the input format the front-end consumes."""
    names = ["O", "H1", "H2"]
    with open(path, "w") as fh:
        fh.write("REMARK  synthetic water box\n")
        fh.write(
            "CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1\n"
            % (box[0, 0], box[1, 1], box[2, 2], 90, 90, 90)
        )
        for i, p in enumerate(positions):
            fh.write(
                "HETATM%5d %-4s HOH A%4d    %8.3f%8.3f%8.3f  1.00  0.00"
                "           %s\n"
                % (i + 1, names[i % 3], i // 3 + 1, p[0], p[1], p[2],
                   names[i % 3][0])
            )
        fh.write("END\n")
