"""Sharding-equivalence tests: the model/data-sharded energy must match the
single-device result to numerical tolerance on a virtual 8-device CPU mesh
(the reference has no distributed path at all; SURVEY.md section 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from admp_tpu import ADMPPmeForce, convert_cart2harm
from admp_tpu.parallel import (
    fft3d_pencil,
    make_sharded_batch_energy,
    make_sharded_pme_energy,
)
from tests.watergen import water_arrays

pytestmark = pytest.mark.slow

M_SCALES = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])
KAPPA = 0.62
GRID = (16, 16, 16)


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("model",))


@pytest.fixture(scope="module")
def sys64():
    # 64 waters = 192 atoms (divisible by 8)
    return water_arrays(n_side=4, spacing=3.1, jitter=0.12, seed=5)


def _padded_pairs(n, multiple):
    pairs = [[i, j] for i in range(n) for j in range(i + 1, n)]
    cap = -(-len(pairs) // multiple) * multiple
    pairs += [[n, n]] * (cap - len(pairs))
    return jnp.asarray(pairs, dtype=jnp.int32)


def test_pencil_fft_matches_fftn(mesh8):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(16, 16, 16)))

    out = jax.jit(
        jax.shard_map(
            lambda slab: fft3d_pencil(slab, "model"),
            mesh=mesh8,
            in_specs=jax.sharding.PartitionSpec("model"),
            out_specs=jax.sharding.PartitionSpec(None, "model"),
        )
    )(x)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(jnp.fft.fftn(x)), atol=1e-10
    )


def test_sharded_energy_matches_single_device(mesh8, sys64):
    sysd = sys64
    n = sysd["positions"].shape[0]
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _padded_pairs(n, 8)
    positions = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])

    sharded = make_sharded_pme_energy(
        mesh8, "model",
        grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
        covalent_map=sysd["covalent_map"],
    )
    e_sharded = jax.jit(sharded)(positions, box, pairs, q_local, M_SCALES)

    # single-device baseline through the reference-parity-tested stack
    force = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        4.0, 1e-3, 2,
    )
    force.kappa = KAPPA
    force.K1, force.K2, force.K3 = GRID
    force.refresh_calculators()
    e_single = force.get_energy(positions, box, pairs, q_local, M_SCALES)
    np.testing.assert_allclose(float(e_sharded), float(e_single), rtol=1e-9)


def test_sharded_forces_match(mesh8, sys64):
    sysd = sys64
    n = sysd["positions"].shape[0]
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _padded_pairs(n, 8)
    positions = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])

    sharded = make_sharded_pme_energy(
        mesh8, "model",
        grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
        covalent_map=sysd["covalent_map"],
    )
    f_sharded = jax.jit(jax.grad(sharded))(positions, box, pairs, q_local, M_SCALES)

    force = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        4.0, 1e-3, 2,
    )
    force.kappa = KAPPA
    force.K1, force.K2, force.K3 = GRID
    force.refresh_calculators()
    _, f_single = force.get_forces(positions, box, pairs, q_local, M_SCALES)
    np.testing.assert_allclose(
        np.asarray(f_sharded), np.asarray(f_single), atol=1e-9
    )


def test_data_model_mesh(sys64):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ("data", "model"))
    sysd = sys64
    n = sysd["positions"].shape[0]
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _padded_pairs(n, 4)
    box = jnp.asarray(sysd["box"])
    base = jnp.asarray(sysd["positions"])
    batch = jnp.stack([base, base + 0.01])
    pairs_b = jnp.stack([pairs, pairs])

    energy_b = make_sharded_batch_energy(
        mesh, "data", "model",
        grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
        covalent_map=sysd["covalent_map"],
    )
    out = jax.jit(energy_b)(batch, box, pairs_b, q_local, M_SCALES)
    assert out.shape == (2,)

    force = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        4.0, 1e-3, 2,
    )
    force.kappa = KAPPA
    force.K1, force.K2, force.K3 = GRID
    force.refresh_calculators()
    for b in range(2):
        e = force.get_energy(batch[b], box, pairs_b[b], q_local, M_SCALES)
        np.testing.assert_allclose(float(out[b]), float(e), rtol=1e-9)


def test_sharded_polarizable_matches_single_device(mesh8, sys64):
    """Sharded polarizable energy+forces+dipoles == single-device at 1e-9.

    The PCG solver composes from outside the shard_map (its matvec is one
    sharded field evaluation); this is the full north-star path: pair-sharded
    real space with Thole damping, atom-sharded spreading of q_tot, pencil
    FFT, implicit-VJP SCF.
    """
    from admp_tpu import SCFConfig
    from admp_tpu.parallel import make_sharded_pol_energy

    sysd = sys64
    n = sysd["positions"].shape[0]
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _padded_pairs(n, 8)
    positions = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])
    u0 = jnp.zeros((n, 3))
    scf = SCFConfig(max_iter=40, field_tol=1e-3)

    energy_aux = make_sharded_pol_energy(
        mesh8, "model",
        grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
        covalent_map=sysd["covalent_map"], scf_config=scf,
    )
    vga = jax.jit(jax.value_and_grad(energy_aux, has_aux=True))
    (e_sharded, (u_sharded, conv_s, _)), f_sharded = vga(
        positions, box, pairs, q_local, pol, tholes, M_SCALES, M_SCALES, u0
    )
    assert bool(conv_s)

    force = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        4.0, 1e-3, 2, lpol=True, scf_config=scf,
    )
    force.kappa = KAPPA
    force.K1, force.K2, force.K3 = GRID
    force.refresh_calculators()
    (e_single, (u_single, conv1, _)), f_single = force._value_grad_aux(
        positions, box, pairs, q_local, pol, tholes,
        M_SCALES, M_SCALES, M_SCALES, u0,
    )
    assert bool(conv1)
    np.testing.assert_allclose(float(e_sharded), float(e_single), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(u_sharded), np.asarray(u_single), atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(f_sharded), np.asarray(f_single), atol=1e-8
    )


def test_sharded_polarizable_sparse_exclusions(mesh8, sys64):
    """The sharded path accepts SparseExclusions (no dense (N,N) map) —
    required at exactly the scale sharding matters."""
    from admp_tpu.ops.exclusions import build_sparse_exclusions
    from admp_tpu.parallel import make_sharded_pme_energy as _mk

    sysd = sys64
    n = sysd["positions"].shape[0]
    bonds = [
        (3 * k, 3 * k + 1) for k in range(n // 3)
    ] + [(3 * k, 3 * k + 2) for k in range(n // 3)]
    sparse = build_sparse_exclusions(bonds, n, max_depth=4)
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _padded_pairs(n, 8)
    positions = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])

    e_sparse = jax.jit(_mk(
        mesh8, "model",
        grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
        covalent_map=sparse,
    ))(positions, box, pairs, q_local, M_SCALES)
    e_dense = jax.jit(_mk(
        mesh8, "model",
        grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
        covalent_map=sysd["covalent_map"],
    ))(positions, box, pairs, q_local, M_SCALES)
    np.testing.assert_allclose(float(e_sparse), float(e_dense), rtol=1e-12)


def test_sharded_full_ff_matches_single_device(mesh8, sys64):
    """Sharded full force field (multipolar PME + TT short range − dispersion
    PME) == the single-device composition the front-end builds (api.py sign
    convention), energies and forces, on the 8-device mesh."""
    from admp_tpu import (
        ADMPDispPmeForce,
        generate_pairwise_interaction,
        tt_damping_qq_c6_kernel,
    )
    from admp_tpu.parallel import make_sharded_ff_energy

    sysd = sys64
    n = sysd["positions"].shape[0]
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _padded_pairs(n, 8)
    positions = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    c_list = jnp.asarray(sysd["c_list"])
    tt_a = jnp.asarray(sysd["tt_a"])
    tt_b = jnp.asarray(sysd["tt_b"])
    tt_q = jnp.asarray(sysd["tt_q"])
    disp_kappa = 0.7

    ff = make_sharded_ff_energy(
        mesh8, "model",
        grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
        covalent_map=sysd["covalent_map"],
        disp_grid_shape=GRID, disp_kappa=disp_kappa, pmax=10,
    )
    e_sharded, f_sharded = jax.jit(jax.value_and_grad(ff))(
        positions, box, pairs, q_local, M_SCALES, c_list, tt_a, tt_b, tt_q
    )

    pme = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        4.0, 1e-3, 2,
    )
    pme.kappa = KAPPA
    pme.K1, pme.K2, pme.K3 = GRID
    pme.refresh_calculators()
    disp = ADMPDispPmeForce(box, sysd["covalent_map"], 4.0, 1e-3, 10)
    disp.kappa = disp_kappa
    disp.K1, disp.K2, disp.K3 = GRID
    disp.refresh_calculators()
    tt = generate_pairwise_interaction(
        tt_damping_qq_c6_kernel, sysd["covalent_map"]
    )

    def single(pos):
        e = pme.get_energy(pos, box, pairs, q_local, M_SCALES)
        e = e + tt(pos, box, pairs, M_SCALES, tt_a, tt_b, tt_q, c_list[:, 0])
        return e - disp.get_energy(pos, box, pairs, c_list, M_SCALES)

    e_single, f_single = jax.jit(jax.value_and_grad(single))(positions)
    np.testing.assert_allclose(float(e_sharded), float(e_single), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(f_sharded), np.asarray(f_single), atol=1e-9
    )


def test_sharded_full_ff_polarizable(mesh8, sys64):
    """Polarizable variant of the sharded full force field: energy, induced
    dipoles, and forces match the single-device composition."""
    from admp_tpu import (
        ADMPDispPmeForce,
        ADMPPmeForce,
        SCFConfig,
        generate_pairwise_interaction,
        tt_damping_qq_c6_kernel,
    )
    from admp_tpu.parallel import make_sharded_ff_energy

    sysd = sys64
    n = sysd["positions"].shape[0]
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _padded_pairs(n, 8)
    positions = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])
    c_list = jnp.asarray(sysd["c_list"])
    tt_a = jnp.asarray(sysd["tt_a"])
    tt_b = jnp.asarray(sysd["tt_b"])
    tt_q = jnp.asarray(sysd["tt_q"])
    u0 = jnp.zeros((n, 3))
    scf = SCFConfig(max_iter=40, field_tol=1e-3)
    disp_kappa = 0.7

    ff = make_sharded_ff_energy(
        mesh8, "model",
        grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
        covalent_map=sysd["covalent_map"],
        disp_grid_shape=GRID, disp_kappa=disp_kappa, pmax=10,
        lpol=True, scf_config=scf,
    )
    vga = jax.jit(jax.value_and_grad(ff, has_aux=True))
    (e_sharded, (u_sharded, conv, _)), f_sharded = vga(
        positions, box, pairs, q_local, pol, tholes, M_SCALES, M_SCALES,
        c_list, tt_a, tt_b, tt_q, u0,
    )
    assert bool(conv)

    pme = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        4.0, 1e-3, 2, lpol=True, scf_config=scf,
    )
    pme.kappa = KAPPA
    pme.K1, pme.K2, pme.K3 = GRID
    pme.refresh_calculators()
    disp = ADMPDispPmeForce(box, sysd["covalent_map"], 4.0, 1e-3, 10)
    disp.kappa = disp_kappa
    disp.K1, disp.K2, disp.K3 = GRID
    disp.refresh_calculators()
    tt = generate_pairwise_interaction(
        tt_damping_qq_c6_kernel, sysd["covalent_map"]
    )

    (e_pol, (u_single, conv1, _)), f_pol = pme._value_grad_aux(
        positions, box, pairs, q_local, pol, tholes,
        M_SCALES, M_SCALES, M_SCALES, u0,
    )
    assert bool(conv1)

    def rest(pos):
        e = tt(pos, box, pairs, M_SCALES, tt_a, tt_b, tt_q, c_list[:, 0])
        return e - disp.get_energy(pos, box, pairs, c_list, M_SCALES)

    e_rest, f_rest = jax.jit(jax.value_and_grad(rest))(positions)
    np.testing.assert_allclose(
        float(e_sharded), float(e_pol) + float(e_rest), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(u_sharded), np.asarray(u_single), atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(f_sharded), np.asarray(f_pol) + np.asarray(f_rest),
        atol=1e-8,
    )


def test_sharded_cell_pairs_match_single_device(mesh8):
    """Slab-decomposed pair search inside shard_map: the union of per-device
    pair blocks equals the single-device cell list (SURVEY §5 long-context
    analog: distributed neighbor search feeding the sharded real space)."""
    from admp_tpu.ops.neighborlist import (
        neighbor_list_cell,
        sharded_cell_pairs,
    )
    from admp_tpu.systems import water_system

    s = water_system(n_side=8, spacing=3.1, jitter=0.12, seed=9)
    positions = jnp.asarray(s["positions"])
    box = jnp.asarray(s["box"])
    n = positions.shape[0]
    cutoff = 3.0
    n_cells = (8, 8, 8)

    ref_nl = neighbor_list_cell(positions, box, cutoff)
    ref_pairs = np.asarray(ref_nl.pairs)
    ref_set = set(map(tuple, ref_pairs[ref_pairs[:, 0] < n].tolist()))

    cap_dev = 4096
    fn = jax.shard_map(
        lambda p, b: sharded_cell_pairs(
            p, b, cutoff, n_cells, 16, cap_dev, "model"
        ),
        mesh=mesh8,
        in_specs=(jax.sharding.PartitionSpec(), jax.sharding.PartitionSpec()),
        out_specs=(
            jax.sharding.PartitionSpec("model", None),
            jax.sharding.PartitionSpec(),
        ),
    )
    pairs_sharded, overflow = jax.jit(fn)(positions, box)
    assert not bool(overflow)
    ps = np.asarray(pairs_sharded)
    got = set(map(tuple, ps[ps[:, 0] < n].tolist()))
    assert got == ref_set, (len(got), len(ref_set))

def test_halo_spread_memory_scales_as_slab(mesh8):
    """The halo-exchange spread must never materialize a full (K1, K2, K3)
    grid per device — its largest grid-shaped intermediate is the
    (K1/P + order-1, K2, K3) slab buffer. Asserted on the traced jaxpr, not
    vibes."""
    from jax.sharding import PartitionSpec as P
    from admp_tpu.parallel.spread import sharded_spread_halo

    k = 32
    n = 64
    grid = (k, k, k)
    full_elems = k * k * k

    def body(p, b, q):
        slab, _ = sharded_spread_halo(p, b, q, grid, 2, "model", 8)
        return slab

    fn = jax.shard_map(
        body, mesh=mesh8,
        in_specs=(P(), P(), P()),
        out_specs=P("model", None, None),
    )
    jaxpr = jax.make_jaxpr(fn)(
        jnp.zeros((n, 3)), jnp.eye(3) * 10.0, jnp.zeros((n, 9))
    )

    def walk(jx, found):
        for eqn in jx.eqns:
            if eqn.primitive.name == "shard_map":
                # the shard_map eqn's own outvar is the LOGICAL global result
                # (per-device it is the K1/P slab); only its body's
                # intermediates are per-device allocations
                for sub in eqn.params.values():
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr, found)
                continue
            for v in eqn.outvars:
                aval = getattr(v, "aval", None)
                if aval is not None and hasattr(aval, "shape"):
                    size = int(np.prod(aval.shape)) if aval.shape else 1
                    if size >= full_elems and jnp.issubdtype(
                        aval.dtype, jnp.floating
                    ):
                        found.append((eqn.primitive.name, aval.shape))
            for sub in eqn.params.values():
                if hasattr(sub, "jaxpr"):
                    walk(sub.jaxpr, found)
                if isinstance(sub, (list, tuple)):
                    for s in sub:
                        if hasattr(s, "jaxpr"):
                            walk(s.jaxpr, found)
        return found

    # the per-device program: slab buffer is (k/8 + 5, k, k) = 9*32*32 < 32^3
    offenders = walk(jaxpr.jaxpr, [])
    assert not offenders, f"full-grid-sized intermediates: {offenders}"


def test_halo_spread_matches_single_device_spread(mesh8):
    """The halo-exchange spread's slabs, stacked over the 8-device mesh,
    equal the single-device flat-scatter mesh — forward and the
    position/multipole gradients through the local scatter's gather
    adjoint under shard_map."""
    from jax.sharding import PartitionSpec as P
    from admp_tpu.ops.reciprocal import spread_to_mesh
    from admp_tpu.parallel.spread import sharded_spread_halo
    from admp_tpu.systems import water_system

    s = water_system(n_side=3, spacing=3.1, jitter=0.12, seed=13)
    positions = jnp.asarray(s["positions"])
    box = jnp.asarray(s["box"])
    n = positions.shape[0]
    # pad to a multiple of 8 local atoms
    n_pad = (-n) % 8
    positions = jnp.concatenate(
        [positions, positions[:n_pad] + 0.37], axis=0
    )
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.standard_normal((positions.shape[0], 9)))
    grid = (32, 32, 32)

    def body(p, b, qq):
        slab, _ = sharded_spread_halo(p, b, qq, grid, 2, "model", 8)
        return slab

    sharded = jax.shard_map(
        body, mesh=mesh8,
        in_specs=(P(), P(), P()),
        out_specs=P("model", None, None),
        check_vma=False,
    )
    mesh_sharded = jax.jit(sharded)(positions, box, q)
    mesh_single = spread_to_mesh(positions, box, q, grid, 2)
    scale_m = float(jnp.max(jnp.abs(mesh_single)))
    assert scale_m > 0
    np.testing.assert_allclose(
        np.asarray(mesh_sharded), np.asarray(mesh_single),
        atol=1e-10 * scale_m
    )

    def loss(f):
        def inner(p, qq):
            m = f(p, qq)
            return jnp.sum(m * m)

        return jax.grad(inner, argnums=(0, 1))

    gp_s, gq_s = jax.jit(loss(lambda p, qq: sharded(p, box, qq)))(
        positions, q)
    gp_1, gq_1 = jax.jit(loss(
        lambda p, qq: spread_to_mesh(p, box, qq, grid, 2)))(positions, q)
    scale = float(jnp.max(jnp.abs(gq_1))) + 1e-30
    np.testing.assert_allclose(
        np.asarray(gq_s), np.asarray(gq_1), atol=1e-10 * scale
    )
    scale_p = float(jnp.max(jnp.abs(gp_1))) + 1e-30
    np.testing.assert_allclose(
        np.asarray(gp_s), np.asarray(gp_1), atol=1e-10 * scale_p
    )


def test_sharded_uu_matvec_matches_field_difference(mesh8, sys64):
    """The cheap sharded SCF matvec (u-quadratic energy gradient) must equal
    field(v) - field(0) from the full sharded polarizable energy."""
    from jax.sharding import PartitionSpec as P
    from admp_tpu.parallel.sharded import (
        _make_local_energy,
        _make_local_uu_energy,
    )

    sysd = sys64
    n = sysd["positions"].shape[0]
    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _padded_pairs(n, 8)
    positions = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])

    local = _make_local_energy(
        "model", 8, GRID, KAPPA, 2,
        sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        lpol=True,
    )
    energy_u = jax.shard_map(
        local, mesh=mesh8,
        in_specs=(P(), P(), P("model", None), P(), P(), P(), P(), P(), P()),
        out_specs=P(),
    )
    local_uu = _make_local_uu_energy(
        "model", 8, GRID, KAPPA, sysd["covalent_map"]
    )
    energy_uu = jax.shard_map(
        local_uu, mesh=mesh8,
        in_specs=(P(), P(), P("model", None), P(), P(), P(), P()),
        out_specs=P(),
    )

    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.normal(size=(n, 3)) * 0.01)

    def field(u):
        return jax.grad(energy_u, argnums=5)(
            positions, box, pairs, q_local, M_SCALES, u, pol, tholes, M_SCALES
        )

    a_v_field = field(v) - field(jnp.zeros_like(v))
    a_v_cheap = jax.grad(energy_uu, argnums=3)(
        positions, box, pairs, v, pol, tholes, M_SCALES
    )
    np.testing.assert_allclose(
        np.asarray(a_v_cheap), np.asarray(a_v_field), rtol=1e-8, atol=1e-10
    )


def test_sharded_water1024_reference_box(mesh8, water1024):
    """Full sharded force field on the REAL 3072-atom reference box with
    K=128 grids: the divisibility/padding story at reference scale, not at
    64 atoms."""
    from admp_tpu import (
        ADMPDispPmeForce,
        generate_pairwise_interaction,
        neighbor_list_cell,
        tt_damping_qq_c6_kernel,
    )
    from admp_tpu.parallel import make_sharded_ff_energy
    from admp_tpu.systems import water_system

    sysd = water1024
    n = sysd.positions.shape[0]
    assert n == 3072 and n % 8 == 0
    positions = jnp.asarray(sysd.positions)
    box = jnp.asarray(sysd.box)
    q_local = convert_cart2harm(jnp.asarray(sysd.q_cart), 2)
    nl = neighbor_list_cell(positions, box, 4.0)
    cap = -(-nl.pairs.shape[0] // 8) * 8
    pairs = jnp.concatenate(
        [jnp.asarray(nl.pairs),
         jnp.full((cap - nl.pairs.shape[0], 2), n, jnp.int32)]
    )
    # per-molecule TT/dispersion parameters tiled over the box (the MPID XML
    # carries no dispersion block; values from the synthetic water model)
    w = water_system(n_side=1)
    reps = n // 3
    c_list = jnp.tile(jnp.asarray(w["c_list"])[:3], (reps, 1))
    tt_a = jnp.tile(jnp.asarray(w["tt_a"])[:3], reps)
    tt_b = jnp.tile(jnp.asarray(w["tt_b"])[:3], reps)
    tt_q = jnp.tile(jnp.asarray(w["tt_q"])[:3], reps)

    kappa = 0.657065221219616
    grid = (128, 128, 128)
    ff = make_sharded_ff_energy(
        mesh8, "model",
        grid_shape=grid, kappa=kappa, lmax=2,
        axis_types=sysd.axis_types, axis_indices=sysd.axis_indices,
        covalent_map=sysd.covalent_map,
        disp_grid_shape=grid, disp_kappa=kappa, pmax=10,
    )
    e_sharded, f_sharded = jax.jit(jax.value_and_grad(ff))(
        positions, box, pairs, q_local, M_SCALES, c_list, tt_a, tt_b, tt_q
    )

    pme = ADMPPmeForce(
        box, sysd.axis_types, sysd.axis_indices, sysd.covalent_map,
        4.0, 1e-4, 2,
    )
    pme.kappa = kappa
    pme.K1, pme.K2, pme.K3 = grid
    pme.refresh_calculators()
    disp = ADMPDispPmeForce(box, sysd.covalent_map, 4.0, 1e-4, 10)
    disp.kappa = kappa
    disp.K1, disp.K2, disp.K3 = grid
    disp.refresh_calculators()
    tt = generate_pairwise_interaction(
        tt_damping_qq_c6_kernel, sysd.covalent_map
    )

    def single(pos):
        e = pme.get_energy(pos, box, pairs, q_local, M_SCALES)
        e = e + tt(pos, box, pairs, M_SCALES, tt_a, tt_b, tt_q, c_list[:, 0])
        return e - disp.get_energy(pos, box, pairs, c_list, M_SCALES)

    e_single, f_single = jax.jit(jax.value_and_grad(single))(positions)
    np.testing.assert_allclose(float(e_sharded), float(e_single), rtol=1e-9)
    scale = float(jnp.max(jnp.abs(f_single)))
    np.testing.assert_allclose(
        np.asarray(f_sharded), np.asarray(f_single), atol=1e-9 * scale
    )


def test_collective_bytes_pinned(mesh8):
    """Comm-volume accounting: the halo spread's
    all_to_all must move exactly its designed (6+T)-scalar payload per
    redistributed row (u0 + alpha + base — never the 216-value stencil or
    the mesh), and the pencil rfft's single transpose must move exactly
    itemsize*(K1/P)*K2*(K3/2+1) complex bytes per hop. Tallied from the
    traced jaxpr (admp_tpu/utils/comm.py), the same technique as the
    per-device memory assertion above."""
    from jax.sharding import PartitionSpec as P
    from admp_tpu.parallel.fft import rfft3d_pencil
    from admp_tpu.parallel.spread import sharded_spread_halo
    from admp_tpu.utils.comm import collective_bytes

    n_dev = 8
    K = 32
    float_b = jnp.zeros(()).dtype.itemsize  # 8 under the x64 test config
    cplx_b = 2 * float_b

    fft_fn = jax.shard_map(
        lambda x: rfft3d_pencil(x, "model"), mesh=mesh8,
        in_specs=(P("model", None, None),),
        out_specs=P(None, "model", None), check_vma=False,
    )
    t = collective_bytes(fft_fn, jnp.zeros((K, K, K)))
    assert t["static"]["all_to_all"] == cplx_b * (K // n_dev) * K * (K // 2 + 1)

    n = 384
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.uniform(0, 20.0, (n, 3)))
    box = jnp.eye(3) * 20.0
    q9 = jnp.asarray(rng.standard_normal((n, 9)))

    spread_fn = jax.shard_map(
        lambda p, b, q: sharded_spread_halo(p, b, q, (K, K, K), 2, "model",
                                            n_dev)[0],
        mesh=mesh8, in_specs=(P(), P(), P()),
        out_specs=P("model", None, None), check_vma=False,
    )
    t = collective_bytes(spread_fn, pos, box, q9)
    n_loc = n // n_dev
    cap = min(n_loc, int(-(-n_loc * 3.0 // n_dev)) + 8)
    T = 10  # separable spread terms at lmax=2
    int_b = jnp.zeros((), jnp.int32).dtype.itemsize
    predicted = n_dev * cap * ((3 + T) * float_b + 3 * int_b)
    assert t["static"]["all_to_all"] == predicted
    # halo fold: ceil(halo/width) ppermute hops of the (halo, K, K) tail
    width = K // n_dev
    halo = 5
    n_folds = -(-halo // width)
    assert t["static"]["ppermute"] == n_folds * halo * K * K * float_b
