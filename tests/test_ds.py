"""Double-single arithmetic (utils/ds.py) and the DS reciprocal engine
(ops/dsrecip.py): unit accuracy vs float64 and the end-to-end force parity
that backs the <1e-6 accuracy mode (fast, small grids; the water_1024-scale
ladder lives in test_precision.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from admp_tpu.utils import ds


def _relmax(dsv, ref):
    v = ds.to_f64(dsv)
    return np.max(np.abs(v - ref) / np.maximum(np.abs(ref), 1e-300))


def test_ds_core_ops_near_f64():
    rng = np.random.RandomState(0)
    a = rng.randn(2000) * np.exp(rng.randn(2000) * 3)
    b = rng.randn(2000) * np.exp(rng.randn(2000) * 3)
    A, B = ds.from_f64(a), ds.from_f64(b)
    # relative to the OPERANDS for add: a+b can cancel to ~0 where the DS
    # pair's own ~eps^2 absolute error is unbounded in relative terms
    add_err = np.abs(ds.to_f64(ds.add(A, B)) - (a + b))
    assert np.max(add_err / np.maximum(np.abs(a), np.abs(b))) < 1e-13
    assert _relmax(ds.mul(A, B), a * b) < 1e-13
    assert _relmax(ds.div(A, B), a / b) < 1e-13
    assert _relmax(ds.sqrt(ds.from_f64(np.abs(a))), np.sqrt(np.abs(a))) < 1e-13
    # repeated squaring over a 1e8 dynamic range: worst-case lanes carry a few
    # compounded ulps more than a single mul
    assert _relmax(ds.npow(A, 5), a ** 5) < 1e-10


def test_ds_exp_erfc():
    from scipy.special import erfc as erfc64

    x = np.linspace(-60.0, 3.0, 3000)
    assert _relmax(ds.exp(ds.from_f64(x)), np.exp(x)) < 1e-10
    y = np.concatenate([np.linspace(1e-6, 0.468, 500),
                        np.linspace(0.469, 3.99, 1500),
                        np.linspace(4.0, 7.0, 500)])
    assert _relmax(ds.erfc(ds.from_f64(y)), erfc64(y)) < 1e-10


def test_ds_sum_pairs_exact():
    rng = np.random.RandomState(1)
    a = rng.randn(4097) * np.exp(rng.randn(4097) * 4)
    s = ds.sum_pairs(ds.from_f64(a))
    assert abs(ds.to_f64(s) - a.sum()) / abs(a).sum() < 1e-14


def test_ds_fft_matches_f64():
    from admp_tpu.ops.dsrecip import ds_fft3

    rng = np.random.RandomState(2)
    m = rng.randn(8, 16, 32).astype(np.float32)
    re, im = ds.ds(jnp.asarray(m)), ds.ds(jnp.zeros_like(jnp.asarray(m)))
    R, I = ds_fft3(re, im)
    ref = np.fft.fftn(m.astype(np.float64))
    err = np.abs(ds.to_f64(R) + 1j * ds.to_f64(I) - ref)
    assert err.max() / np.abs(ref).max() < 1e-13


def test_ds_irfft3_roundtrip_and_hermitian_path():
    """ds_irfft3 (half-spectrum inverse used by the hand adjoint) must equal
    K^3 x on a rfft3 roundtrip AND match the full-spectrum route
    (hermitian_fill + ds_fft3) on a physical Hermitian product w*S."""
    from admp_tpu.ops.dsrecip import (
        _hermitian_fill, ds_fft3, ds_irfft3, ds_rfft3,
    )

    rng = np.random.RandomState(3)
    K = 16
    m64 = rng.randn(K, K, K)
    s_re, s_im = ds_rfft3(ds.from_f64(m64))
    out = ds_irfft3(s_re, s_im)
    err = np.abs(ds.to_f64(out) - K ** 3 * m64)
    assert err.max() / (K ** 3 * np.abs(m64).max()) < 1e-13

    # real-symmetric w (an influence-like grid): both backward routes agree
    kz = np.minimum(np.arange(K // 2 + 1), K - np.arange(K // 2 + 1))
    kk = np.minimum(np.arange(K), K - np.arange(K))
    w64 = np.exp(-0.05 * (kk[:, None, None] ** 2 + kk[None, :, None] ** 2
                          + kz[None, None, :] ** 2))
    w = ds.from_f64(w64)
    t_re, t_im = ds.mul(w, s_re), ds.mul(w, s_im)
    fr, fi = _hermitian_fill(t_re, t_im, K)
    p_re, _ = ds_fft3(fr, ds.neg(fi))
    ref = ds.to_f64(p_re)
    new = ds.to_f64(ds_irfft3(t_re, t_im))
    assert np.abs(new - ref).max() / np.abs(ref).max() < 1e-13


def test_ds_static_box_weight_cache_is_exact():
    """make_ds_pme_recip(static_box=...) precomputes the DS k-space weights;
    energies and forces must match the dynamic-weights engine bitwise."""
    from admp_tpu.ops.dsrecip import make_ds_pme_recip

    rng = np.random.default_rng(0)
    n = 48
    box = jnp.asarray(np.diag([12.0, 12.0, 12.0]), jnp.float32)
    pos = jnp.asarray(rng.uniform(0, 12, (n, 3)), jnp.float32)
    q = jnp.asarray(rng.standard_normal((n, 9)), jnp.float32)
    e_dyn = make_ds_pme_recip(0.6, (16, 16, 16), 2)
    e_cst = make_ds_pme_recip(0.6, (16, 16, 16), 2, static_box=box)
    assert float(e_dyn(pos, box, q)) == float(e_cst(pos, box, q))
    ga = jax.grad(lambda p: e_dyn(p, box, q))(pos)
    gb = jax.grad(lambda p: e_cst(p, box, q))(pos)
    np.testing.assert_array_equal(np.asarray(ga), np.asarray(gb))


@pytest.mark.slow
@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_ds_recip_energy_and_forces_vs_f64(lmax):
    """The DS reciprocal engine vs the f64 oracle at identical
    f32-representable inputs: energy ~1e-11, forces ~f32-output-rounding."""
    from admp_tpu.ops.dsrecip import make_ds_pme_recip
    from admp_tpu.ops.influence import ck_1
    from admp_tpu.ops.reciprocal import make_pme_recip
    from admp_tpu.utils.constants import DIELECTRIC

    rng = np.random.RandomState(0)
    n, k = 48, 16
    kappa = 0.6
    box = np.eye(3, dtype=np.float32) * 14.0
    pos = (rng.rand(n, 3) * 14.0).astype(np.float32)
    q = rng.randn(n, (lmax + 1) ** 2).astype(np.float32)

    ref = make_pme_recip(ck_1, kappa, False, (k, k, k), lmax,
                         prefactor=DIELECTRIC)
    e_ref = ref(jnp.asarray(pos, jnp.float64), jnp.asarray(box, jnp.float64),
                jnp.asarray(q, jnp.float64))
    g_ref = jax.grad(
        lambda p, qq: ref(p, jnp.asarray(box, jnp.float64), qq),
        argnums=(0, 1),
    )(jnp.asarray(pos, jnp.float64), jnp.asarray(q, jnp.float64))

    dsr = make_ds_pme_recip(kappa, (k, k, k), lmax)
    e_ds = dsr(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(q))
    assert abs(float(e_ds) - float(e_ref)) / abs(float(e_ref)) < 1e-10

    gp, gq = jax.grad(
        lambda p, qq: dsr(p, jnp.asarray(box), qq), argnums=(0, 1)
    )(jnp.asarray(pos), jnp.asarray(q))

    def relrmse(a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))

    # the DS adjoint's only loss is the final f32 rounding of the cotangents
    assert relrmse(gp, g_ref[0]) < 5e-7
    assert relrmse(gq, g_ref[1]) < 5e-7


def test_ds_recip_box_gradient_warns_and_zeros():
    from admp_tpu.ops.dsrecip import make_ds_pme_recip

    dsr = make_ds_pme_recip(0.6, (8, 8, 8), 0)
    pos = jnp.zeros((4, 3), jnp.float32) + 2.0
    box = jnp.eye(3, dtype=jnp.float32) * 8.0
    q = jnp.ones((4, 1), jnp.float32)
    with pytest.warns(UserWarning, match="box gradients"):
        g = jax.grad(lambda b: dsr(pos, b, q))(box)
    # the guarded engine contributes exactly zero, never a partial answer
    np.testing.assert_array_equal(np.asarray(g), 0.0)


def test_cached_influence_box_gradient_warns_and_zeros():
    """cache_influence engines must make box differentiation loud (warning)
    and contribute ZERO box gradient instead of a silently-partial virial
    (a hard raise breaks the implicit-SCF adjoint, which legitimately
    linearizes every input and discards the box cotangent)."""
    from admp_tpu.ops.influence import ck_1
    from admp_tpu.ops.reciprocal import make_pme_recip

    rng = np.random.RandomState(0)
    pos = jnp.asarray(rng.rand(8, 3) * 10.0)
    box = jnp.eye(3) * 10.0
    q = jnp.asarray(rng.randn(8, 9))
    recip = make_pme_recip(ck_1, 0.5, False, (8, 8, 8), 2, static_box=box)
    # position gradients keep working
    g = jax.grad(lambda p: recip(p, box, q))(pos)
    assert np.all(np.isfinite(np.asarray(g)))
    with pytest.warns(UserWarning, match="cache_influence"):
        gb = jax.grad(lambda b: recip(pos, b, q))(box)
    np.testing.assert_array_equal(np.asarray(gb), 0.0)


@pytest.mark.slow
def test_f64_near_mode_small_system():
    """realspace_precision='f64-near' + recip 'ds' on a small box: forces an
    order of magnitude closer to the f64 oracle than plain f32."""
    from admp_tpu import ADMPPmeForce, EngineConfig, convert_cart2harm
    from admp_tpu.systems import water_system

    s = water_system(n_side=2, spacing=3.1, jitter=0.1, seed=0)
    n = s["positions"].shape[0]
    pairs = [[i, j] for i in range(n) for j in range(i + 1, n)]
    cap = -(-len(pairs) // 128) * 128
    pairs += [[n, n]] * (cap - len(pairs))
    pairs = jnp.asarray(pairs, jnp.int32)
    pos32 = jnp.asarray(np.asarray(s["positions"], np.float32))
    box32 = jnp.asarray(np.asarray(s["box"], np.float32))
    q32 = jnp.asarray(np.asarray(
        convert_cart2harm(jnp.asarray(s["q_cart"]), 2), np.float32))
    m32 = jnp.asarray(np.array([0., 0., 0., 1., 1.], np.float32))

    def build(config, K=16):
        f = ADMPPmeForce(box32, s["axis_types"], s["axis_indices"],
                         s["covalent_map"], 3.0, 1e-3, lmax=2, config=config)
        f.kappa = 0.7
        f.K1 = f.K2 = f.K3 = K
        f.refresh_calculators()
        return f

    oracle = build(EngineConfig())
    _, f_ref = oracle.get_forces(
        pos32.astype(jnp.float64), box32.astype(jnp.float64), pairs,
        q32.astype(jnp.float64), m32.astype(jnp.float64),
    )
    f_ref = np.asarray(f_ref)

    def rmse(frc):
        frc = np.asarray(frc, np.float64)
        return np.sqrt(np.mean((frc - f_ref) ** 2)) / np.sqrt(np.mean(f_ref ** 2))

    _, f_plain = build(EngineConfig()).get_forces(pos32, box32, pairs, q32, m32)
    _, f_ds = build(EngineConfig.ds_accuracy()).get_forces(
        pos32, box32, pairs, q32, m32)
    assert rmse(f_ds) < rmse(f_plain) / 10
    assert rmse(f_ds) < 2e-6


def test_ds_adjoint_row_gather_matches_flat():
    """On a wide-trailing-axis grid (8, 8, 128) the DS adjoint's potential
    window is a flat per-element gather of the hi/lo potential meshes; the
    hand-written DS forces must match autodiff of the plain float64
    reciprocal engine on the same grid."""
    from admp_tpu import convert_cart2harm
    from admp_tpu.ops.dsrecip import make_ds_pme_recip
    from admp_tpu.ops.influence import ck_1
    from admp_tpu.ops.reciprocal import make_pme_recip
    from admp_tpu.systems import water_system
    from admp_tpu.utils.constants import DIELECTRIC

    s = water_system(n_side=2, spacing=3.1, jitter=0.1, seed=3)
    grid = (8, 8, 128)
    pos = np.asarray(s["positions"], np.float64)
    box = np.asarray(s["box"], np.float64)
    q = np.asarray(convert_cart2harm(jnp.asarray(s["q_cart"]), 2))

    ds_e = make_ds_pme_recip(0.7, grid, 2, DIELECTRIC)
    f64_e = make_pme_recip(ck_1, 0.7, False, grid, 2, DIELECTRIC)
    f_ds = np.asarray(jax.grad(ds_e)(
        jnp.asarray(pos, jnp.float32), jnp.asarray(box, jnp.float32),
        jnp.asarray(q, jnp.float32)), np.float64)
    f_ref = np.asarray(jax.grad(f64_e)(
        jnp.asarray(pos), jnp.asarray(box), jnp.asarray(q)))
    rel = np.sqrt(np.mean((f_ds - f_ref) ** 2) / np.mean(f_ref ** 2))
    assert np.all(np.isfinite(f_ds)) and rel < 1e-5
