"""The stages of the main path on the card, at the width of the 3,000-atom
water box of chip_smoke.py phase (a): the cell-list neighbour list, the
real-space pair pass, and the reciprocal pipelines (spread -> FFT ->
influence -> gather adjoint) of the electrostatic and the dispersion PME.

Each stage runs in float32 on the card against float64 on the card (the
force tolerance of chip_smoke.py), and the neighbour list built on the card
equals the one built on the host CPU backend (chip_smoke.py phase (a)
compares float64 card and CPU results end to end). chip_smoke.py runs these
tests in its child process before the full phases; where JAX has no GPU they
skip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from admp_tpu import convert_cart2harm, neighbor_list_cell
from admp_tpu.models.pme import pme_real_energy
from admp_tpu.ops.harmonics import cart_dipole_to_harm
from admp_tpu.ops.ewald import setup_ewald_parameters
from admp_tpu.ops.influence import ck_1, ck_6, ck_8, ck_10
from admp_tpu.ops.reciprocal import make_disp_pme_recip, make_pme_recip
from admp_tpu.utils.constants import DIELECTRIC

pytestmark = pytest.mark.gpu

RC = 4.0
# |dE| of one stage relative to its own magnitude: float32 sums of these
# terms land near 1e-7 (a stage's energy is not a small difference of large
# terms, unlike the total that chip_smoke.py bounds by the self term)
STAGE_ENERGY_TOL = 1e-5
M_SCALES = (0.0, 0.0, 0.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def water():
    sysd = chip_smoke.water_box(10)
    kappa, k1, k2, k3 = setup_ewald_parameters(RC, 1e-4, sysd["box"])
    u = 0.05 * np.random.default_rng(5).standard_normal(
        sysd["positions"].shape)
    return dict(sysd, kappa=kappa, grid=(k1, k2, k3), u=u)


def _cpu():
    return jax.default_device(jax.devices("cpu")[0])


def _run(stage, water, dtype, pairs=None):
    """(energy, gradient) of ``stage`` in ``dtype`` on the default device."""
    with jax.enable_x64(dtype == jnp.float64):
        args = [jnp.asarray(water["positions"], dtype),
                jnp.asarray(water["box"], dtype)]
        fn = STAGES[stage](water, dtype, pairs)
        e, g = jax.jit(jax.value_and_grad(fn))(*args)
        return float(e), np.asarray(g, np.float64)


def _pair_pass(water, dtype, pairs):
    """Polarizable pair pass: permanent multipoles and induced dipoles."""
    q = convert_cart2harm(jnp.asarray(water["q_cart"], dtype), 2)
    u = cart_dipole_to_harm(jnp.asarray(water["u"], dtype))
    pol = jnp.asarray(water["pol"], dtype)
    tholes = jnp.asarray(water["tholes"], dtype)
    m = jnp.asarray(M_SCALES, dtype)
    cov = jnp.asarray(water["covalent_map"])
    pairs = jnp.asarray(pairs)

    def energy(pos, box):
        return pme_real_energy(pos, box, pairs, q, u, pol, tholes, m, m, cov,
                               water["kappa"], 2, True, compensated=True)

    return energy


def _recip_elec(water, dtype, _pairs):
    q = convert_cart2harm(jnp.asarray(water["q_cart"], dtype), 2)
    recip = make_pme_recip(ck_1, water["kappa"], False, water["grid"], 2,
                           DIELECTRIC, compensated=True)
    return lambda pos, box: recip(pos, box, q)


def _recip_disp(water, dtype, _pairs):
    c = jnp.asarray(water["c_list"], dtype)
    recip = make_disp_pme_recip((ck_6, ck_8, ck_10), water["kappa"],
                                water["grid"])
    return lambda pos, box: recip(pos, box, c)


STAGES = {
    "pair_pass": _pair_pass,
    "recip_elec": _recip_elec,
    "recip_disp": _recip_disp,
}


def _pairs_f64(water):
    with jax.enable_x64(True):
        nl = neighbor_list_cell(jnp.asarray(water["positions"]),
                                jnp.asarray(water["box"]), RC)
        assert not bool(nl.did_overflow)
        return np.asarray(nl.pairs)


def test_neighbor_list_card_matches_cpu(gpu, water):
    card = _pairs_f64(water)
    with _cpu():
        host = _pairs_f64(water)
    n = water["positions"].shape[0]

    def rows(p):
        p = p[p[:, 0] < n]
        return p[np.lexsort((p[:, 1], p[:, 0]))]

    assert rows(card).shape[0] > 10 * n
    np.testing.assert_array_equal(rows(card), rows(host))


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_f32_and_f64_on_card(gpu, water, stage):
    pairs = _pairs_f64(water)
    e32, g32 = _run(stage, water, jnp.float32, pairs)
    e64, g64 = _run(stage, water, jnp.float64, pairs)
    assert abs(e32 - e64) <= STAGE_ENERGY_TOL * abs(e64), (e32, e64)
    assert chip_smoke._rel_rmse(g32, g64) <= chip_smoke.FORCE_RMSE_TOL
