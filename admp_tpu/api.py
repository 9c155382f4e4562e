"""High-level force-field front-end: XML -> differentiable potential functions.

Feature parity with reference: admp/api.py (ADMPDispGenerator at api.py:120-209,
ADMPPmeGenerator at api.py:216-463, Hamiltonian at api.py:469-488), with one
deliberate architectural difference: the reference front-end is welded to OpenMM
(subclasses openmm.app.ForceField, registers parsers into
openmm.app.forcefield.parsers, api.py:213,466); this implementation is
self-contained — it parses the same XML files and PDB topologies directly, so
the engine runs anywhere JAX runs. The reference's hardcoded water dispersion /
TT parameters in the PME generator (api.py:349-382, marked "WARNING: HARD
CODE!") are *not* replicated; those constants belong to the dispersion section
of the force field.

The user-facing contract is identical: each generator exposes a pure
``potential_fn(positions, box, pairs, params)`` closed over static topology,
differentiable in everything — including the ``params`` dict, which is what
makes systematic force-field parameter optimization work
(reference: examples/openmm_api/run.py:40-46).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import jax.numpy as jnp

from admp_tpu.io.ffxml import read_ffxml
from admp_tpu.io.pdb import read_pdb
from admp_tpu.io.topology import assemble_system, build_covalent_map_from_bonds
from admp_tpu.models.dispersion import ADMPDispPmeForce
from admp_tpu.models.pme import ADMPPmeForce
from admp_tpu.ops.shortrange import (
    generate_pairwise_interaction,
    tt_damping_qq_c6_kernel,
)

# OpenMM internal-unit factors (nm-based XML attributes -> engine A-based units),
# matching reference: admp/api.py:186-192.
_HARTREE_KJ = 2625.5
_BOHR_NM = 0.0529177249


class ADMPDispGenerator:
    """Tang-Toennies short-range + dispersion PME generator
    (reference: admp/api.py:120-209)."""

    def __init__(self, element):
        self.ethresh = 1.0e-5
        self.pmax = 10
        self.params = {
            "mScales": jnp.array(
                [float(element.get("mScale1%d" % i)) for i in range(2, 7)]
            )
        }
        self.types = []
        per_atom = {k: [] for k in ("A", "B", "Q", "C6", "C8", "C10")}
        for atom in element.findall("Atom"):
            self.types.append(atom.get("type"))
            for k in per_atom:
                per_atom[k].append(float(atom.get(k)))
        for k, v in per_atom.items():
            self.params[k] = jnp.array(v)
        self.types = np.array(self.types)
        self._potential = None

    def create_force(self, system, type_map, rc):
        map_idx = np.array(
            [int(np.where(self.types == t)[0][0]) for t in type_map]
        )
        covalent_map = build_covalent_map_from_bonds(
            system.bonds, system.n_atoms, 6
        )
        # the reference-compatible front end keeps the reference's
        # heuristic grid (energies comparable with the reference's)
        force_lr = ADMPDispPmeForce(
            jnp.asarray(system.box), covalent_map, rc, self.ethresh, self.pmax,
            fft_friendly_grid=False,
        )
        self.disp_pme_force = force_lr
        pot_lr = force_lr.get_energy
        pot_sr = generate_pairwise_interaction(
            tt_damping_qq_c6_kernel, covalent_map
        )
        map_idx = jnp.asarray(map_idx)

        def potential_fn(positions, box, pairs, params):
            m_scales = params["mScales"]
            a_list = params["A"][map_idx] / _HARTREE_KJ  # kJ/mol -> Hartree
            b_list = params["B"][map_idx] * _BOHR_NM     # nm^-1 -> Bohr^-1
            q_list = params["Q"][map_idx]
            c_list = jnp.stack(
                [
                    jnp.sqrt(params["C6"][map_idx] * 1e6),
                    jnp.sqrt(params["C8"][map_idx] * 1e8),
                    jnp.sqrt(params["C10"][map_idx] * 1e10),
                ],
                axis=-1,
            )
            e_sr = pot_sr(
                positions, box, pairs, m_scales, a_list, b_list, q_list,
                c_list[:, 0],
            )
            e_lr = pot_lr(positions, box, pairs, c_list, m_scales)
            return e_sr - e_lr

        self._potential = potential_fn
        return potential_fn


class ADMPPmeGenerator:
    """Multipolar (optionally polarizable) PME generator
    (reference: admp/api.py:216-463)."""

    def __init__(self, element):
        self.ethresh = 1.0e-5
        self.lmax = int(element.get("lmax"))
        self.pmax = int(element.get("pmax"))
        self.params = {}
        for name in ("mScales", "pScales", "dScales"):
            prefix = name[0]
            self.params[name] = jnp.array(
                [float(element.get(f"{prefix}Scale1{i}")) for i in range(2, 7)]
            )
        self.lpol = len(element.findall("Polarize")) > 0
        self.ref_dip = ""
        self._potential = None

    def create_force(self, system, type_map, rc):
        from admp_tpu.ops.harmonics import convert_cart2harm

        covalent_map = build_covalent_map_from_bonds(
            system.bonds, system.n_atoms, 6
        )
        q_local = convert_cart2harm(jnp.asarray(system.q_cart), self.lmax)
        self.params["Q_local"] = q_local
        pol = jnp.asarray(system.pol)
        tholes = jnp.asarray(system.tholes)
        self.params["pol"] = pol
        self.params["tholes"] = tholes

        pme_force = ADMPPmeForce(
            jnp.asarray(system.box),
            system.axis_types,
            system.axis_indices,
            covalent_map,
            rc,
            self.ethresh,
            self.lmax,
            self.lpol,
            fft_friendly_grid=False,
        )
        self.pme_force = pme_force

        u_init = jnp.zeros((system.n_atoms, 3))
        if self.ref_dip:
            ref = np.loadtxt(self.ref_dip)[: system.n_atoms] * 10.0  # nm -> A
            u_init = jnp.asarray(ref)
        self.params["U_ind"] = u_init
        lpol = self.lpol

        def potential_fn(positions, box, pairs, params):
            m_scales = params["mScales"]
            q_loc = params["Q_local"]
            if lpol:
                return pme_force.get_energy(
                    positions, box, pairs, q_loc, params["pol"],
                    params["tholes"], m_scales, params["pScales"],
                    params["dScales"], U_init=params["U_ind"],
                )
            return pme_force.get_energy(positions, box, pairs, q_loc, m_scales)

        self._potential = potential_fn
        return potential_fn


_GENERATOR_PARSERS = {
    "ADMPDispForce": ADMPDispGenerator,
    "ADMPPmeForce": ADMPPmeGenerator,
}


class Hamiltonian:
    """XML force field -> list of differentiable potentials
    (reference: admp/api.py:469-488, decoupled from OpenMM)."""

    def __init__(self, xml_path: str):
        self.xml_path = xml_path
        root = ET.parse(xml_path).getroot()
        self._generators = []
        for child in root:
            parser = _GENERATOR_PARSERS.get(child.tag)
            if parser is not None:
                self._generators.append(parser(child))
        # atom templates for topology assembly come from the same file
        self._atom_templates, self._residue_templates = read_ffxml(xml_path)
        # primary key (residue name, atom name): atom names are only unique
        # within a residue template, and a global name->type dict would let
        # same-named atoms in different residues silently overwrite each other
        self._type_by_res_atom = {}
        for res in self._residue_templates:
            for t in res.atoms:
                self._type_by_res_atom[(res.name, t.name)] = t.type
        self._type_by_name = {t.name: t.type for t in self._atom_templates}
        self._potentials = []

    def getGenerators(self):
        return self._generators

    # snake_case alias
    get_generators = getGenerators

    def createPotential(self, topology, nonbondedCutoff: float = 10.0):
        """Build potentials for a PDB topology. ``nonbondedCutoff`` in Angstrom.

        ``topology`` is either a PDB file path or an already-parsed
        ``io.pdb.PDBData`` object (so callers can construct/patch topologies —
        extra CONECT bonds, box edits — before potential assembly, which the
        reference's path-only surface cannot, admp/api.py:474).

        Returns a list of ``potential_fn(positions, box, pairs, params)``; call
        order matches generator declaration order in the XML, as in the
        reference (admp/api.py:474-488).
        """
        pdb_data = (
            topology if hasattr(topology, "res_names") else read_pdb(topology)
        )
        system = assemble_system(
            pdb_data, self._atom_templates, self._residue_templates,
            covalent_depth=6,
        )
        type_map = []
        for res_name, name in zip(pdb_data.res_names, pdb_data.names):
            ttype = self._type_by_res_atom.get((res_name, name))
            if ttype is None:
                ttype = self._type_by_name.get(name)
            if ttype is None:
                raise KeyError(
                    f"atom {name!r} in residue {res_name!r} matches no "
                    f"template in {self.xml_path}"
                )
            type_map.append(ttype)
        self._system = system
        self._type_map = list(type_map)
        self._potentials = [
            gen.create_force(system, type_map, nonbondedCutoff)
            for gen in self._generators
        ]
        return list(self._potentials)

    create_potential = createPotential

    def createPotentialFromSystem(self, system, type_map,
                                  nonbondedCutoff: float = 10.0):
        """Build potentials for a fully custom topology: an assembled
        ``io.topology.System`` (any source — trajectory readers, generated
        structures) plus an explicit per-atom force-field ``type_map``.

        Bypasses PDB parsing and residue-template matching entirely; the
        system's ``bonds`` drive the covalent/exclusion maps.
        """
        self._system = system
        self._potentials = [
            gen.create_force(system, list(type_map), nonbondedCutoff)
            for gen in self._generators
        ]
        return list(self._potentials)

    create_potential_from_system = createPotentialFromSystem
