"""End-to-end tests of the OpenMM-free Hamiltonian front-end
(reference surface: admp/api.py + examples/openmm_api/run.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admp_tpu import neighbor_list_dense
from admp_tpu.api import Hamiltonian
from admp_tpu.systems import water_lattice

FF_XML = "/root/reference/examples/openmm_api/forcefield.xml"


def _write_small_pdb(path, positions, box):
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


@pytest.fixture(scope="module")
def small_case(tmp_path_factory):
    if not os.path.exists(FF_XML):
        pytest.skip("reference forcefield.xml not available")
    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=2)
    pdb = tmp_path_factory.mktemp("api") / "small.pdb"
    _write_small_pdb(pdb, positions, box)
    ham = Hamiltonian(FF_XML)
    ham.getGenerators()[1].ref_dip = ""
    pots = ham.createPotential(str(pdb), nonbondedCutoff=4.0)
    nlist = neighbor_list_dense(positions, box, 4.0)
    return dict(
        ham=ham, pots=pots, pairs=jnp.asarray(nlist.pairs),
        positions=jnp.asarray(positions), box=jnp.asarray(box),
    )


def test_xml_parsing(small_case):
    gens = small_case["ham"].getGenerators()
    assert [type(g).__name__ for g in gens] == [
        "ADMPDispGenerator", "ADMPPmeGenerator"
    ]
    disp, pme = gens
    np.testing.assert_allclose(
        np.asarray(disp.params["mScales"]), [0, 0, 0, 1, 1]
    )
    assert pme.lmax == 2 and pme.pmax == 10 and pme.lpol
    # multipoles parsed from the <Atom c0=...> schema
    q = np.asarray(pme.params["Q_local"])
    assert abs(q[0, 0] + 1.0614) < 1e-12 and abs(q[1, 0] - 0.5307) < 1e-12
    np.testing.assert_allclose(np.asarray(pme.params["pol"])[0], 0.88)


def test_dispersion_potential_and_param_grad(small_case):
    pot = small_case["pots"][0]
    gen = small_case["ham"].getGenerators()[0]
    e = pot(
        small_case["positions"], small_case["box"], small_case["pairs"],
        gen.params,
    )
    assert np.isfinite(float(e))
    grads = jax.grad(pot, argnums=3)(
        small_case["positions"], small_case["box"], small_case["pairs"],
        gen.params,
    )
    assert set(grads) == set(gen.params)
    # water topology: 1-2 and 1-3 exclusions active, plus the distant-pair
    # slot (last entry, via the reference's nbonds-1 negative-index trick)
    ms = np.asarray(grads["mScales"])
    assert ms[0] != 0 and ms[1] != 0 and ms[2] == 0 and ms[3] == 0 and ms[4] != 0
    assert np.all(np.isfinite(np.asarray(grads["C6"])))


def test_create_potential_from_pdbdata_object(small_case, tmp_path):
    """createPotential accepts a parsed PDBData object (patchable topology),
    matching the path-based result exactly."""
    from admp_tpu.io.pdb import read_pdb

    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=2)
    pdb = tmp_path / "obj.pdb"
    _write_small_pdb(pdb, positions, box)
    data = read_pdb(str(pdb))
    ham = Hamiltonian(FF_XML)
    pots = ham.createPotential(data, nonbondedCutoff=4.0)
    gen = ham.getGenerators()[0]
    e_obj = pots[0](
        small_case["positions"], small_case["box"], small_case["pairs"],
        gen.params,
    )
    gen0 = small_case["ham"].getGenerators()[0]
    e_path = small_case["pots"][0](
        small_case["positions"], small_case["box"], small_case["pairs"],
        gen0.params,
    )
    np.testing.assert_allclose(float(e_obj), float(e_path), rtol=1e-12)


def test_conect_bonds_reach_covalent_map(tmp_path):
    """CONECT records add connectivity templates can't express: bonding two
    water residues through CONECT must create inter-residue exclusions."""
    from admp_tpu.io.ffxml import read_ffxml
    from admp_tpu.io.pdb import read_pdb
    from admp_tpu.io.topology import assemble_system

    if not os.path.exists(FF_XML):
        pytest.skip("reference forcefield.xml not available")
    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=2)
    pdb = tmp_path / "conect.pdb"
    _write_small_pdb(pdb, positions, box)
    # bond O of residue 1 (serial 1) to O of residue 2 (serial 4)
    lines = pdb.read_text().splitlines()
    lines.insert(-1, "CONECT    1    4")
    pdb.write_text("\n".join(lines) + "\n")

    data = read_pdb(str(pdb))
    assert data.conect_bonds() == [(0, 3)]
    atoms, residues = read_ffxml(FF_XML)
    system = assemble_system(data, atoms, residues, covalent_depth=6)
    cov = np.asarray(system.covalent_map)
    assert cov[0, 3] == 1          # the CONECT bond itself
    assert cov[0, 4] == 2          # O1 .. H of residue 2 via the new bond
    assert cov[1, 3] == 2          # H of residue 1 .. O2


def test_create_potential_from_system(small_case):
    """createPotentialFromSystem: custom topology + explicit type map
    bypasses PDB parsing; same numbers as the matched path."""
    ham = Hamiltonian(FF_XML)
    system = small_case["ham"]._system
    n = system.n_atoms
    type_map = ["380", "381", "381"] * (n // 3)
    pots = ham.createPotentialFromSystem(system, type_map, nonbondedCutoff=4.0)
    gen = ham.getGenerators()[0]
    e_sys = pots[0](
        small_case["positions"], small_case["box"], small_case["pairs"],
        gen.params,
    )
    gen0 = small_case["ham"].getGenerators()[0]
    e_path = small_case["pots"][0](
        small_case["positions"], small_case["box"], small_case["pairs"],
        gen0.params,
    )
    np.testing.assert_allclose(float(e_sys), float(e_path), rtol=1e-12)


@pytest.mark.slow
def test_polarizable_potential_and_param_grad(small_case):
    pot = small_case["pots"][1]
    gen = small_case["ham"].getGenerators()[1]
    e = pot(
        small_case["positions"], small_case["box"], small_case["pairs"],
        gen.params,
    )
    assert np.isfinite(float(e)) and float(e) != 0.0
    assert bool(gen.pme_force.lconverg)
    grads = jax.grad(pot, argnums=3)(
        small_case["positions"], small_case["box"], small_case["pairs"],
        gen.params,
    )
    # exact polarizability gradients through the SCF (implicit VJP)
    gpol = np.asarray(grads["pol"])
    assert np.any(gpol[0::3] != 0.0)
    assert np.all(np.isfinite(np.asarray(grads["Q_local"])))


def test_multi_model_pdb_reads_first_model_only(tmp_path):
    """MODEL/ENDMDL trajectories: only the first configuration is read (the
    reference's END-tolerant behavior, admp/parser.py:151-158); CONECT
    records after ENDMDL still apply."""
    from admp_tpu.io.pdb import read_pdb

    pdb = tmp_path / "multi.pdb"
    pdb.write_text(
        "CRYST1   10.000   10.000   10.000  90.00  90.00  90.00 P 1\n"
        "MODEL        1\n"
        "HETATM    1  O   HOH A   1       1.000   1.000   1.000  1.00  0.00"
        "           O\n"
        "HETATM    2  H1  HOH A   1       1.900   1.000   1.000  1.00  0.00"
        "           H\n"
        "ENDMDL\n"
        "MODEL        2\n"
        "HETATM    1  O   HOH A   1       5.000   5.000   5.000  1.00  0.00"
        "           O\n"
        "HETATM    2  H1  HOH A   1       5.900   5.000   5.000  1.00  0.00"
        "           H\n"
        "ENDMDL\n"
        "CONECT    1    2\n"
        "END\n"
    )
    data = read_pdb(str(pdb))
    assert len(data.names) == 2
    np.testing.assert_allclose(data.positions[0], [1.0, 1.0, 1.0])
    assert data.conect_bonds() == [(0, 1)]


@pytest.mark.slow
def test_hamiltonian_water1024_matches_reference_composition():
    """Pin the COMPOSED generator potential (E_TT_shortrange - E_dispPME) and
    its mScales parameter gradient on the reference water1024 box against the
    reference implementation executed in-process (the analog of reference
    examples/openmm_api/ref_out:1-3 — openmm itself is not needed: the
    composition is reference api.py:183-199, reproduced here from the
    reference's own pairwise/disp_pme modules)."""
    import sys
    import types
    import xml.etree.ElementTree as ET

    import jax

    from admp_tpu import neighbor_list_cell

    pdb_path = "/root/reference/examples/openmm_api/water1024.pdb"
    if not os.path.exists(pdb_path) or not os.path.exists(FF_XML):
        pytest.skip("reference openmm_api example not available")

    # --- reference modules in-process (same shim as test_reference_parity)
    if "jax.config" not in sys.modules:
        shim = types.ModuleType("jax.config")
        shim.config = jax.config
        sys.modules["jax.config"] = shim
    if "/root/reference" not in sys.path:
        sys.path.insert(0, "/root/reference")
    try:
        import admp.disp_pme as ref_disp
        import admp.pairwise as ref_pairwise
    except Exception as exc:  # pragma: no cover
        pytest.skip(f"reference implementation unavailable: {exc}")

    # --- our front-end on the real box
    ham = Hamiltonian(FF_XML)
    ham.getGenerators()[1].ref_dip = ""
    pots = ham.createPotential(pdb_path, nonbondedCutoff=4.0)
    disp_gen = ham.getGenerators()[0]
    positions = jnp.asarray(ham._system.positions)
    box = jnp.asarray(ham._system.box)
    n = positions.shape[0]
    assert n == 3072
    nl = neighbor_list_cell(positions, box, 4.0)
    pairs = jnp.asarray(nl.pairs)
    ours = pots[0](positions, box, pairs, disp_gen.params)
    g_ours = jax.grad(pots[0], argnums=3)(
        positions, box, pairs, disp_gen.params
    )["mScales"]

    # --- the reference composition on identical inputs
    ff_root = ET.parse(FF_XML).getroot()
    disp_el = ff_root.find("ADMPDispForce")
    m_scales = jnp.asarray(
        [float(disp_el.attrib["mScale1%d" % i]) for i in range(2, 7)]
    )
    by_type = {a.attrib["type"]: a.attrib for a in disp_el.findall("Atom")}
    # per-atom type assignment via the Hamiltonian's own template lookup
    # (covalent-map parity is independently proven elsewhere)
    type_names = ham._type_map
    a_list, b_list, q_list = [], [], []
    c6, c8, c10 = [], [], []
    for t in type_names:
        at = by_type[t]
        a_list.append(float(at["A"]))
        b_list.append(float(at["B"]))
        q_list.append(float(at["Q"]))
        c6.append(float(at["C6"]))
        c8.append(float(at["C8"]))
        c10.append(float(at["C10"]))
    covalent_map = jnp.asarray(ham._system.covalent_map)

    force = ref_disp.ADMPDispPmeForce(box, covalent_map, 4.0, 1e-5, 10)
    tt = ref_pairwise.generate_pairwise_interaction(
        ref_pairwise.TT_damping_qq_c6_kernel, covalent_map, static_args={}
    )

    def ref_potential(m):
        al = jnp.asarray(a_list) / 2625.5
        bl = jnp.asarray(b_list) * 0.0529177249
        ql = jnp.asarray(q_list)
        c6l = jnp.sqrt(jnp.asarray(c6) * 1e6)
        c8l = jnp.sqrt(jnp.asarray(c8) * 1e8)
        c10l = jnp.sqrt(jnp.asarray(c10) * 1e10)
        c_list = jnp.vstack((c6l, c8l, c10l))
        e_sr = tt(positions, box, pairs, m, al, bl, ql, c_list[0])
        e_lr = force.get_energy(positions, box, pairs, c_list.T, m)
        return e_sr - e_lr

    theirs = ref_potential(m_scales)
    g_theirs = jax.grad(ref_potential)(m_scales)

    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(g_ours), np.asarray(g_theirs), rtol=1e-6
    )
