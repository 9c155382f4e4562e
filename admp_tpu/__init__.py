"""admp_tpu: a differentiable multipolar polarizable force-field engine.

Built from scratch in JAX/XLA with the capabilities of the reference ADMP
calculator (Roy-Kid/ADMP): multipolar electrostatic PME up to quadrupole with
MPID local-frame conventions, Thole-damped induced-dipole polarization with a
differentiable on-device SCF, dispersion PME (C6/C8/C10), Tang-Toennies
short-range damping, and an XML/PDB front-end exposing energies, forces,
virials and force-field parameter gradients.

Public surface mirrors the reference package so its users can switch directly:
ADMPPmeForce, ADMPDispPmeForce, Hamiltonian, generate_pairwise_interaction, ...
"""

from admp_tpu.models.dispersion import ADMPDispPmeForce, energy_disp_pme
from admp_tpu.models.pme import ADMPPmeForce, energy_pme
from admp_tpu.ops.ewald import setup_ewald_parameters
from admp_tpu.ops.harmonics import (
    convert_cart2harm,
    convert_harm2cart,
    rot_global2local,
    rot_local2global,
)
from admp_tpu.ops.neighborlist import (
    neighbor_list_cell,
    neighbor_list_dense,
    refresh_neighbor_list,
    update_neighbor_list,
)
from admp_tpu.ops.shortrange import (
    distribute_dispcoeff,
    distribute_multipoles,
    distribute_scalar,
    distribute_v3,
    generate_pairwise_interaction,
    tt_damping_qq_c6_kernel,
)
from admp_tpu.md import (
    BAR_TO_KJMOL_A3,
    MDState,
    make_langevin_step,
    make_mc_barostat,
    make_nve_step,
    run_langevin,
    run_nve,
)
from admp_tpu.settings import EngineConfig, SCFConfig
from admp_tpu.utils.constants import DIELECTRIC

# Reference-compatible alias (admp/pairwise.py:94)
TT_damping_qq_c6_kernel = tt_damping_qq_c6_kernel

__version__ = "0.1.0"

__all__ = [
    "ADMPDispPmeForce",
    "ADMPPmeForce",
    "BAR_TO_KJMOL_A3",
    "DIELECTRIC",
    "EngineConfig",
    "MDState",
    "SCFConfig",
    "make_langevin_step",
    "make_mc_barostat",
    "make_nve_step",
    "run_langevin",
    "run_nve",
    "TT_damping_qq_c6_kernel",
    "convert_cart2harm",
    "convert_harm2cart",
    "energy_disp_pme",
    "energy_pme",
    "generate_pairwise_interaction",
    "neighbor_list_cell",
    "neighbor_list_dense",
    "refresh_neighbor_list",
    "rot_global2local",
    "rot_local2global",
    "setup_ewald_parameters",
    "tt_damping_qq_c6_kernel",
    "update_neighbor_list",
]
