"""Live numerical parity against the reference implementation.

These tests import the reference package from the read-only checkout at
/root/reference and compare energies/forces of every subsystem on identical
inputs, in double precision on CPU. This is a *stronger* gate than the shipped
golden scalars (which are stale relative to the shipped inputs — see
tests/test_golden_water.py docstring). Skipped when the reference checkout or
its JAX-version shims are unavailable.

No reference code is vendored; it is executed in place purely as a test oracle.
"""

import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests.watergen import water_arrays

pytestmark = pytest.mark.slow

KAPPA = 0.657065221219616
M_SCALES = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])


@pytest.fixture(scope="module")
def ref():
    """Import the reference package with a jax.config shim (removed in new JAX)."""
    if "jax.config" not in sys.modules:
        shim = types.ModuleType("jax.config")
        shim.config = jax.config
        sys.modules["jax.config"] = shim
    if "/root/reference" not in sys.path:
        sys.path.insert(0, "/root/reference")
    try:
        import admp.pme as ref_pme  # noqa: F401
        import admp.recip as ref_recip  # noqa: F401
        import admp.disp_pme as ref_disp  # noqa: F401
        import admp.pairwise as ref_pairwise  # noqa: F401
        import admp.multipole as ref_multipole  # noqa: F401
        import admp.spatial as ref_spatial  # noqa: F401
    except Exception as exc:  # pragma: no cover
        pytest.skip(f"reference implementation unavailable: {exc}")
    return types.SimpleNamespace(
        pme=sys.modules["admp.pme"],
        recip=sys.modules["admp.recip"],
        disp=sys.modules["admp.disp_pme"],
        pairwise=sys.modules["admp.pairwise"],
        multipole=sys.modules["admp.multipole"],
        spatial=sys.modules["admp.spatial"],
    )


@pytest.fixture(scope="module")
def small_water():
    """27 waters at liquid density in a ~9.3 A box (synthetic, stable SCF)."""
    return water_arrays(n_side=3, spacing=3.1, jitter=0.12, seed=3)


def _pairs_all(n):
    return jnp.asarray(
        [[i, j] for i in range(n) for j in range(i + 1, n)], dtype=jnp.int32
    )


def _prep(sysd, ref):
    pos = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    q_local = ref.multipole.convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    frames_ref = ref.spatial.generate_construct_local_frames(
        sysd["axis_types"], sysd["axis_indices"]
    )(pos, box)
    q_global = ref.multipole.rot_local2global(q_local, frames_ref, 2)
    return pos, box, q_local, q_global


def test_geometry_and_rotations(ref, small_water):
    from admp_tpu.ops.frames import construct_local_frames
    from admp_tpu.ops.harmonics import convert_cart2harm, rot_local2global

    sysd = small_water
    pos = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    q_local_ref = ref.multipole.convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    q_local_my = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    np.testing.assert_allclose(
        np.asarray(q_local_my), np.asarray(q_local_ref), atol=1e-14
    )
    frames_ref = ref.spatial.generate_construct_local_frames(
        sysd["axis_types"], sysd["axis_indices"]
    )(pos, box)
    frames_my = construct_local_frames(
        pos, box, jnp.asarray(sysd["axis_types"]), jnp.asarray(sysd["axis_indices"])
    )
    np.testing.assert_allclose(
        np.asarray(frames_my), np.asarray(frames_ref), atol=1e-12
    )
    qg_ref = ref.multipole.rot_local2global(q_local_ref, frames_ref, 2)
    qg_my = rot_local2global(q_local_my, frames_my, 2)
    np.testing.assert_allclose(np.asarray(qg_my), np.asarray(qg_ref), atol=1e-12)


def test_real_space_energy_and_forces(ref, small_water):
    from admp_tpu.models.pme import pme_real_energy

    sysd = small_water
    pos, box, _, q_global = _prep(sysd, ref)
    cov = sysd["covalent_map"]
    pairs = _pairs_all(pos.shape[0])

    def ref_fn(p):
        return ref.pme.pme_real(
            p, box, pairs, q_global, None, None, None,
            M_SCALES, None, None, cov, KAPPA, 2, False,
        )

    def my_fn(p):
        return pme_real_energy(
            p, box, pairs, q_global, None, None, None,
            M_SCALES, None, jnp.asarray(cov), KAPPA, 2, False,
        )

    e_ref, f_ref = jax.value_and_grad(ref_fn)(pos)
    e_my, f_my = jax.value_and_grad(my_fn)(pos)
    np.testing.assert_allclose(float(e_my), float(e_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(f_my), np.asarray(f_ref), atol=1e-8)


@pytest.mark.parametrize("lmax", [0, 2])
def test_reciprocal_energy_and_forces(ref, small_water, lmax):
    from admp_tpu.ops.influence import ck_1
    from admp_tpu.ops.reciprocal import make_pme_recip
    from admp_tpu.utils.constants import DIELECTRIC

    sysd = small_water
    pos, box, _, q_global = _prep(sysd, ref)
    q = q_global[:, : (lmax + 1) ** 2]
    k = 24
    ref_fn = ref.recip.generate_pme_recip(
        ref.recip.Ck_1, KAPPA, False, 6, k, k, k, lmax
    )
    my_fn = make_pme_recip(
        ck_1, KAPPA, False, (k, k, k), lmax, prefactor=DIELECTRIC
    )
    e_ref, f_ref = jax.value_and_grad(lambda p: ref_fn(p, box, q))(pos)
    e_my, f_my = jax.value_and_grad(lambda p: my_fn(p, box, q))(pos)
    np.testing.assert_allclose(float(e_my), float(e_ref), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(f_my), np.asarray(f_ref), atol=1e-8)


def test_dispersion_reciprocal_kernels(ref, small_water):
    from admp_tpu.ops.influence import ck_6, ck_8, ck_10
    from admp_tpu.ops.reciprocal import make_pme_recip

    sysd = small_water
    pos = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    n = pos.shape[0]
    c6 = jnp.asarray(np.tile([37.19677405, 7.6111103, 7.6111103], n // 3))[:, None]
    k = 24
    for ref_ck, my_ck in [
        (ref.recip.Ck_6, ck_6), (ref.recip.Ck_8, ck_8), (ref.recip.Ck_10, ck_10)
    ]:
        ref_fn = ref.recip.generate_pme_recip(ref_ck, KAPPA, True, 6, k, k, k, 0)
        my_fn = make_pme_recip(my_ck, KAPPA, True, (k, k, k), 0)
        e_ref, f_ref = jax.value_and_grad(lambda p: ref_fn(p, box, c6))(pos)
        e_my, f_my = jax.value_and_grad(lambda p: my_fn(p, box, c6))(pos)
        np.testing.assert_allclose(float(e_my), float(e_ref), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(f_my), np.asarray(f_ref), atol=1e-9)


def test_self_energies(ref, small_water):
    from admp_tpu.ops.selfenergy import pme_self_energy

    sysd = small_water
    _, _, _, q_global = _prep(sysd, ref)
    for lmax in (0, 1, 2):
        q = q_global[:, : (lmax + 1) ** 2]
        np.testing.assert_allclose(
            float(pme_self_energy(q, KAPPA, lmax)),
            float(ref.pme.pme_self(q, KAPPA, lmax)),
            rtol=1e-13,
        )


def test_polarizable_energy_fixed_dipoles(ref, small_water):
    """energy_pme with lpol=True at a *fixed* induced-dipole vector must agree
    (isolates the polarization energy terms from the SCF)."""
    from admp_tpu.models.pme import energy_pme as my_energy_pme
    from admp_tpu.ops.influence import ck_1
    from admp_tpu.ops.reciprocal import make_pme_recip
    from admp_tpu.utils.constants import DIELECTRIC

    sysd = small_water
    pos, box, q_local, _ = _prep(sysd, ref)
    n = pos.shape[0]
    pairs = _pairs_all(n)
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.normal(0, 0.02, (n, 3)) * (sysd["pol"] > 0)[:, None])
    k = 24

    ref_recip_fn = ref.recip.generate_pme_recip(
        ref.recip.Ck_1, KAPPA, False, 6, k, k, k, 2
    )
    construct = ref.spatial.generate_construct_local_frames(
        sysd["axis_types"], sysd["axis_indices"]
    )

    def ref_fn(u_, q_):
        return ref.pme.energy_pme(
            pos, box, pairs, q_, u_, pol, tholes,
            M_SCALES, M_SCALES, M_SCALES, sysd["covalent_map"],
            construct, ref_recip_fn, KAPPA, k, k, k, 2, True,
        )

    my_recip_fn = make_pme_recip(
        ck_1, KAPPA, False, (k, k, k), 2, prefactor=DIELECTRIC
    )

    def my_fn(u_, q_):
        return my_energy_pme(
            pos, box, pairs, q_, u_, pol, tholes,
            M_SCALES, M_SCALES, M_SCALES, jnp.asarray(sysd["covalent_map"]),
            jnp.asarray(sysd["axis_types"]), jnp.asarray(sysd["axis_indices"]),
            my_recip_fn, KAPPA, 2, True,
        )

    e_ref = float(ref_fn(u, q_local))
    e_my = float(my_fn(u, q_local))
    np.testing.assert_allclose(e_my, e_ref, rtol=1e-11)
    # gradient wrt induced dipoles (the SCF "field") must also agree
    g_ref = jax.grad(ref_fn)(u, q_local)
    g_my = jax.grad(my_fn)(u, q_local)
    np.testing.assert_allclose(np.asarray(g_my), np.asarray(g_ref), atol=1e-8)
    # parameter gradient parity (multipoles)
    gq_ref = jax.grad(ref_fn, argnums=1)(u, q_local)
    gq_my = jax.grad(my_fn, argnums=1)(u, q_local)
    np.testing.assert_allclose(np.asarray(gq_my), np.asarray(gq_ref), atol=1e-8)


def test_scf_fixed_point_matches_reference_jacobi(ref, small_water):
    """My PCG solution must satisfy the reference's field equation: plugging it
    into the reference's grad_U gives ~zero residual, and it matches the
    reference's own converged Jacobi iteration."""
    from admp_tpu import ADMPPmeForce

    sysd = small_water
    pos = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    q_local = ref.multipole.convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _pairs_all(pos.shape[0])
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])

    ref_force = ref.pme.ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        4.0, 1e-3, 2, lpol=True,
    )
    u_ref, converged, _ = ref_force.optimize_Uind(
        pos, box, pairs, q_local, pol, tholes, M_SCALES, M_SCALES, M_SCALES,
        U_init=jnp.zeros((pos.shape[0], 3)), thresh=1.0,
    )
    assert converged

    from admp_tpu import SCFConfig

    my_force = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        4.0, 1e-3, 2, lpol=True,
        scf_config=SCFConfig(field_tol=0.05, max_iter=100),
        fft_friendly_grid=False,
    )
    e_my = my_force.get_energy(
        pos, box, pairs, q_local, pol, tholes, M_SCALES, M_SCALES, M_SCALES,
        U_init=jnp.zeros((pos.shape[0], 3)),
    )
    assert bool(my_force.lconverg)
    # my PCG drives the residual below the reference's loose threshold, so the
    # two solutions agree to the linear-solve tolerance
    np.testing.assert_allclose(
        np.asarray(my_force.U_ind), np.asarray(u_ref), atol=5e-4
    )
    e_ref = float(
        ref_force.energy_fn(
            pos, box, pairs, q_local, u_ref, pol, tholes,
            M_SCALES, M_SCALES, M_SCALES,
        )
    )
    np.testing.assert_allclose(float(e_my), e_ref, atol=1e-3)


@pytest.mark.parametrize("lmax", [0, 1])
def test_real_space_lower_lmax(ref, small_water, lmax):
    """Charge-only and dipole-truncated real-space paths (the reference's
    lmax branches at admp/pme.py:304-332)."""
    from admp_tpu.models.pme import pme_real_energy

    sysd = small_water
    pos, box, _, q_global = _prep(sysd, ref)
    q = q_global[:, : (lmax + 1) ** 2]
    cov = sysd["covalent_map"]
    pairs = _pairs_all(pos.shape[0])
    e_ref = ref.pme.pme_real(
        pos, box, pairs, q, None, None, None, M_SCALES, None, None,
        cov, KAPPA, lmax, False,
    )
    e_my = pme_real_energy(
        pos, box, pairs, q, None, None, None, M_SCALES, None,
        jnp.asarray(cov), KAPPA, lmax, False,
    )
    np.testing.assert_allclose(float(e_my), float(e_ref), rtol=1e-12)


def test_jacobi_mode_matches_pcg(ref, small_water):
    """The reference-style damped-Jacobi solver mode must reach the same fixed
    point as PCG (scf/solver.py keeps it for cross-validation)."""
    from admp_tpu import ADMPPmeForce, SCFConfig

    sysd = small_water
    pos = jnp.asarray(sysd["positions"])
    box = jnp.asarray(sysd["box"])
    q_local = ref.multipole.convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pairs = _pairs_all(pos.shape[0])
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])
    sols = {}
    for method in ("pcg", "jacobi"):
        force = ADMPPmeForce(
            box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
            4.0, 1e-3, 2, lpol=True,
            scf_config=SCFConfig(method=method, field_tol=0.01, max_iter=100),
            fft_friendly_grid=False,
        )
        force.get_energy(
            pos, box, pairs, q_local, pol, tholes, M_SCALES, M_SCALES,
            M_SCALES, U_init=jnp.zeros((pos.shape[0], 3)),
        )
        assert bool(force.lconverg), method
        sols[method] = np.asarray(force.U_ind)
    np.testing.assert_allclose(sols["jacobi"], sols["pcg"], atol=1e-4)
