"""Float32 precision modes vs the float64 oracle (BASELINE.md north star:
relative force RMSE < 1e-6 in f32).

Both pipelines evaluate at identical f32-representable inputs so the numbers
measure pipeline rounding, not input rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admp_tpu import ADMPPmeForce, convert_cart2harm, neighbor_list_dense
from admp_tpu.settings import EngineConfig
from tests.watergen import water_arrays

pytestmark = pytest.mark.slow

M_SCALES = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])


@pytest.fixture(scope="module")
def case():
    sysd = water_arrays(n_side=4, spacing=3.1, jitter=0.12, seed=7)
    pos64 = jnp.asarray(sysd["positions"])
    box64 = jnp.asarray(sysd["box"])
    nl = neighbor_list_dense(pos64, box64, 4.0)
    q64 = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    # f32-representable inputs shared by both pipelines
    pos32 = pos64.astype(jnp.float32)
    box32 = box64.astype(jnp.float32)
    q32 = q64.astype(jnp.float32)

    def build(cfg, box):
        return ADMPPmeForce(
            box, sysd["axis_types"], sysd["axis_indices"],
            sysd["covalent_map"], 4.0, 1e-4, lmax=2, config=cfg,
        )

    oracle = build(None, box32.astype(jnp.float64))
    e_ref, f_ref = oracle.get_forces(
        pos32.astype(jnp.float64), box32.astype(jnp.float64),
        jnp.asarray(nl.pairs), q32.astype(jnp.float64),
        M_SCALES.astype(jnp.float64),
    )
    return dict(
        sysd=sysd, pairs=jnp.asarray(nl.pairs), pos32=pos32, box32=box32,
        q32=q32, e_ref=float(e_ref), f_ref=np.asarray(f_ref, np.float64),
        build=build,
    )


def _run(case, cfg):
    force = case["build"](cfg, case["box32"])
    e, f = force.get_forces(
        case["pos32"], case["box32"], case["pairs"], case["q32"],
        M_SCALES.astype(jnp.float32),
    )
    d = np.asarray(f, np.float64) - case["f_ref"]
    rel = float(np.sqrt((d**2).mean()) / np.sqrt((case["f_ref"]**2).mean()))
    return float(e) - case["e_ref"], rel


def test_plain_f32_baseline(case):
    d_e, rel = _run(case, EngineConfig(compensated_sums=False))
    # sanity anchor: plain f32 sits in the e-4 band (if this *improves*
    # dramatically, update the ladder; if it regresses, something broke)
    assert rel < 5e-3
    assert abs(d_e) < 5.0


def test_high_accuracy_f64_exclusions(case):
    d_e, rel = _run(case, EngineConfig.high_accuracy())
    assert rel < 5e-6, rel
    assert abs(d_e) < 0.05, d_e


def test_ultra_meets_north_star(case):
    """realspace f64-all + f64 recip: < 1e-6 relative force RMSE
    (measured 8.4e-8 on water_1024, CPU; this small box is similar)."""
    d_e, rel = _run(
        case, EngineConfig.high_accuracy(realspace_precision="f64-all")
    )
    assert rel < 1e-6, rel
    assert abs(d_e) < 1e-3, d_e


def test_exclusion_pair_list_matches_dense_semantics(case):
    """The static f64 exclusion pass must reproduce exactly the pairs the
    masked f32 pass dropped: total energy in 'f64' mode equals the plain-f32
    total to f32-rounding accuracy on a box where exclusion pairs are few."""
    from admp_tpu.ops.exclusions import exclusion_pair_list

    excl = exclusion_pair_list(jnp.asarray(case["sysd"]["covalent_map"]))
    n = case["pos32"].shape[0]
    real_rows = np.asarray(excl[excl[:, 0] < n])
    # water: each molecule contributes O-H1, O-H2 (dist 1) and H1-H2 (dist 2)
    assert real_rows.shape[0] == n  # 3 exclusion pairs per 3-atom molecule


def test_ultra_dft_mode(case):
    """'f64-dft' replaces the FFT with explicit-matmul DFTs; it must match
    the native-f64-FFT ultra result."""
    d_e, rel = _run(
        case,
        EngineConfig.high_accuracy(
            realspace_precision="f64-all", recip_precision="f64-dft"
        ),
    )
    assert rel < 1e-6, rel
    assert abs(d_e) < 1e-3, d_e
