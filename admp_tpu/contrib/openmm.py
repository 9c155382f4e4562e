"""Optional OpenMM interop adapter.

The reference front-end subclasses ``openmm.app.ForceField`` and registers its
generators into ``openmm.app.forcefield.parsers`` so users can feed real OpenMM
topologies (reference: admp/api.py:213,466,469-488). This package's default
front-end is OpenMM-free (admp_tpu/api.py); this adapter restores the OpenMM
entry point as an *optional* layer (SURVEY §7.7: "optional adapter only") —
it converts an ``openmm.app.Topology`` into the engine's flat-array ``System``
and hands off to the same generators as the native path, so the returned
potentials are identical jittable/differentiable functions.

Import-guarded: importing this module without openmm installed raises a clear
ImportError; nothing else in admp_tpu depends on it.
"""

from __future__ import annotations

import numpy as np

try:
    import openmm  # noqa: F401
    from openmm import app as _app
except ImportError as _exc:  # pragma: no cover - exercised only sans openmm
    raise ImportError(
        "admp_tpu.contrib.openmm requires the 'openmm' package; the core "
        "engine does not — use admp_tpu.api.Hamiltonian for the "
        "OpenMM-free front-end."
    ) from _exc

from admp_tpu.api import Hamiltonian as _NativeHamiltonian
from admp_tpu.io.pdb import PDBData

_NM_TO_ANGSTROM = 10.0


def _pdb_data_from_topology(topology) -> PDBData:
    """Flatten an openmm.app.Topology into the engine's PDBData view.

    Bond connectivity comes from the topology (CONECT records, residue
    templates, or however the user built it) — this is what the native PDB
    path cannot see beyond template matching.
    """
    names, res_names, res_seqs = [], [], []
    index_of = {}
    for atom in topology.atoms():
        index_of[atom] = len(names)
        names.append(atom.name)
        res_names.append(atom.residue.name)
        res_seqs.append(atom.residue.index)
    connects = {}
    for a, b in topology.bonds():
        i, j = index_of[a], index_of[b]
        connects.setdefault(i, []).append(j)
        connects.setdefault(j, []).append(i)

    vecs = topology.getPeriodicBoxVectors()
    if vecs is None:
        raise ValueError("topology has no periodic box vectors")
    m = np.array(
        [[v.x, v.y, v.z] for v in vecs], dtype=float
    ) * _NM_TO_ANGSTROM
    # cell parameters (a, b, c, alpha, beta, gamma) from the row vectors
    la, lb, lc = (np.linalg.norm(m[i]) for i in range(3))

    def _ang(u, v):
        return float(np.degrees(np.arccos(
            np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
        )))

    n = len(names)
    data = PDBData.__new__(PDBData)
    data.names = names
    data.res_names = res_names
    data.res_seqs = res_seqs
    data.charges = [0.0] * n
    data.positions = np.zeros((n, 3))
    data.box = [la, lb, lc, _ang(m[1], m[2]), _ang(m[0], m[2]), _ang(m[0], m[1])]
    data.connects = connects
    return data


class Hamiltonian(_app.forcefield.ForceField):
    """``openmm.app.ForceField`` subclass exposing ADMP jax potentials.

    Usage mirrors the reference (examples/openmm_api/run.py:16-25)::

        H = Hamiltonian('forcefield.xml')
        potentials = H.createPotential(pdb.topology, nonbondedCutoff=4.0)
        E = potentials[0](positions, box, pairs, H.getGenerators()[0].params)

    Distances are Angstrom on the jax side (the reference's convention).
    """

    def __init__(self, *xml_files):
        # OpenMM's ForceField parses the XML for its own bookkeeping; the ADMP
        # sections are handled by the native generator parsers. Registering
        # no-op parsers keeps OpenMM from rejecting the unknown tags
        # (the reference registers its generators the same way,
        # admp/api.py:213,466).
        for tag in ("ADMPDispForce", "ADMPPmeForce"):
            _app.forcefield.parsers.setdefault(tag, lambda *a, **k: None)
        super().__init__(*xml_files)
        self._native = _NativeHamiltonian(xml_files[0])

    def getGenerators(self):
        return self._native.getGenerators()

    def createPotential(self, topology, nonbondedCutoff=10.0):
        """Build jax potentials for an OpenMM topology.

        ``nonbondedCutoff`` in Angstrom (float) or an openmm Quantity
        (converted from nm).
        """
        try:  # openmm Quantity -> Angstrom
            from openmm import unit

            if unit.is_quantity(nonbondedCutoff):
                nonbondedCutoff = (
                    nonbondedCutoff.value_in_unit(unit.nanometer)
                    * _NM_TO_ANGSTROM
                )
        except ImportError:  # pragma: no cover
            pass
        from admp_tpu.io.topology import assemble_system

        pdb_data = _pdb_data_from_topology(topology)
        system = assemble_system(
            pdb_data, self._native._atom_templates,
            self._native._residue_templates, covalent_depth=6,
        )
        type_map = []
        for res_name, name in zip(pdb_data.res_names, pdb_data.names):
            ttype = self._native._type_by_res_atom.get((res_name, name))
            if ttype is None:
                ttype = self._native._type_by_name[name]
            type_map.append(ttype)
        self._system = system
        pots = [
            gen.create_force(system, type_map, nonbondedCutoff)
            for gen in self._native.getGenerators()
        ]
        self._potentials = pots
        return pots
