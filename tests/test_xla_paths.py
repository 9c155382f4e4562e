"""The plain-XLA stages every backend runs, against independent references:

* the flat scatter-add spread (``spread_to_mesh`` for lmax 0/1/2 x B-spline
  order 4/6, and the multi-channel ``spread_to_mesh_multi``) against a numpy
  loop over each atom's stencil, with cardinal B-splines from their
  recursion and periodic wrap, atoms on and outside the cell faces of a
  triclinic box;
* the gather adjoint (grad of sum(mesh * mesh) w.r.t. the multipoles)
  against a numpy gather of the same stencils;
* the SoA real-space pair pass (permanent, polarizable, induced-induced and
  the mixed second derivative the exact SCF adjoint takes) against float64
  central differences;
* ``spectrum_sq`` in float64 against numpy's FFT.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admp_tpu import convert_cart2harm
from admp_tpu.models.pme import pme_real_energy, pme_real_uu_energy
from admp_tpu.ops.harmonics import cart_dipole_to_harm
from admp_tpu.ops.reciprocal import (
    spectrum_sq,
    spread_to_mesh,
    spread_to_mesh_multi,
)
from tests.watergen import water_arrays

RT3 = np.sqrt(3.0)
GRID = (10, 11, 12)
BOX = np.array([[9.0, 0.0, 0.0], [0.7, 9.5, 0.0], [-0.4, 0.9, 10.0]])
# fractional coordinates: interior, exactly on the faces, just inside the
# upper faces, and outside the primary cell on both sides
FRAC = np.array([
    [0.31, 0.52, 0.77],
    [0.0, 0.0, 0.0],
    [0.999999, 0.5, 0.25],
    [-0.02, 1.03, 0.5],
    [0.5, -0.001, 0.999],
    [1.0, 0.4, -0.3],
])


def _bspline(n, u):
    """Cardinal B-spline M_n(u), support [0, n], by its recursion."""
    if n == 1:
        return ((u >= 0.0) & (u < 1.0)).astype(float)
    return (u * _bspline(n - 1, u) + (n - u) * _bspline(n - 1, u - 1.0)) / (
        n - 1)


def _bspline_d(n, u, d):
    """d-th derivative: M_n' (u) = M_{n-1}(u) - M_{n-1}(u - 1)."""
    if d == 0:
        return _bspline(n, u)
    return _bspline_d(n - 1, u, d - 1) - _bspline_d(n - 1, u - 1.0, d - 1)


def _stencils(pos, box, grid, order, lmax):
    """Per atom: (mesh indices (order^3, 3), weights (order^3, H)) with the
    MPID harmonic channels — theta, its Cartesian gradient in (z, x, y)
    order, and the quadrupole combinations of its Cartesian Hessian."""
    kk = np.asarray(grid, float)
    binv = np.linalg.inv(box)
    jac = (binv * kk[None, :]).T          # dr_j / dx_c
    out = []
    for x in pos:
        r = (x @ binv) * kk
        base = np.ceil(r).astype(int) - order // 2
        idx, wts = [], []
        for off in itertools.product(range(order), repeat=3):
            g = base + np.asarray(off)
            u = g - r + order / 2.0
            b = [[_bspline_d(order, u[j], d) for d in range(3)]
                 for j in range(3)]
            theta = b[0][0] * b[1][0] * b[2][0]
            w = [theta]
            if lmax >= 1:
                d_r = np.array([
                    b[0][1] * b[1][0] * b[2][0],
                    b[0][0] * b[1][1] * b[2][0],
                    b[0][0] * b[1][0] * b[2][1],
                ]) * -1.0
                g_x = jac.T @ d_r
                w += [g_x[2], g_x[0], g_x[1]]
            if lmax >= 2:
                h_r = np.empty((3, 3))
                for j in range(3):
                    for m in range(3):
                        degs = [0, 0, 0]
                        degs[j] += 1
                        degs[m] += 1
                        h_r[j, m] = np.prod([b[a][degs[a]] for a in range(3)])
                h = jac.T @ h_r @ jac
                tr = np.trace(h)
                w += [(3.0 * h[2, 2] - tr) / 2.0, RT3 * h[0, 2],
                      RT3 * h[1, 2], RT3 / 2.0 * (h[0, 0] - h[1, 1]),
                      RT3 * h[0, 1]]
            idx.append(np.mod(g, grid))
            wts.append(w)
        out.append((np.asarray(idx), np.asarray(wts)))
    return out


def _mpid_q(q, lmax):
    q = np.array(q[:, : (lmax + 1) ** 2], float)
    if lmax >= 2:
        q[:, 4:9] /= 3.0
    return q


def _numpy_spread(pos, box, q, grid, lmax, order):
    mesh = np.zeros(grid)
    for (idx, w), qa in zip(_stencils(pos, box, grid, order, lmax),
                            _mpid_q(q, lmax)):
        np.add.at(mesh, tuple(idx.T), w @ qa)
    return mesh


def _atoms(seed, n_ch):
    rng = np.random.default_rng(seed)
    pos = FRAC @ BOX
    return pos, rng.standard_normal((pos.shape[0], n_ch))


@pytest.mark.parametrize("order", [4, 6])
@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_spread_matches_numpy_loop(lmax, order):
    pos, q = _atoms(lmax + 10 * order, 9)
    got = spread_to_mesh(jnp.asarray(pos), jnp.asarray(BOX), jnp.asarray(q),
                         GRID, lmax, order=order)
    ref = _numpy_spread(pos, BOX, q, GRID, lmax, order)
    scale = np.max(np.abs(ref))
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("order", [4, 6])
def test_spread_multi_matches_numpy_loop(order):
    pos, c = _atoms(order, 3)
    got = spread_to_mesh_multi(jnp.asarray(pos), jnp.asarray(BOX),
                               jnp.asarray(c), GRID, order)
    ref = np.stack([_numpy_spread(pos, BOX, c[:, k:k + 1], GRID, 0, order)
                    for k in range(3)])
    assert got.shape == (3,) + GRID
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-12 * np.max(np.abs(ref)))


@pytest.mark.parametrize("lmax", [0, 1, 2, "multi"])
def test_gather_adjoint_matches_numpy_gather(lmax):
    """d/dq sum(mesh^2) = 2 * sum over each atom's stencil of mesh * weight:
    the transpose of the scatter is a gather of the same flat indices."""
    multi = lmax == "multi"
    lm = 0 if multi else lmax
    pos, q = _atoms(7, 3 if multi else 9)
    pos_j, box_j = jnp.asarray(pos), jnp.asarray(BOX)
    if multi:
        def loss(qq):
            m = spread_to_mesh_multi(pos_j, box_j, qq, GRID, 6)
            return jnp.sum(m * m)
        meshes = [_numpy_spread(pos, BOX, q[:, k:k + 1], GRID, 0, 6)
                  for k in range(3)]
    else:
        def loss(qq):
            m = spread_to_mesh(pos_j, box_j, qq, GRID, lm)
            return jnp.sum(m * m)
        meshes = [_numpy_spread(pos, BOX, q, GRID, lm, 6)]
    got = np.asarray(jax.grad(loss)(jnp.asarray(q)))

    ref = np.zeros_like(q)
    for a, (idx, w) in enumerate(_stencils(pos, BOX, GRID, 6, lm)):
        if multi:
            for k, mesh in enumerate(meshes):
                ref[a, k] = 2.0 * mesh[tuple(idx.T)] @ w[:, 0]
        else:
            n_h = (lm + 1) ** 2
            ref[a, :n_h] = 2.0 * meshes[0][tuple(idx.T)] @ w
            if lm >= 2:
                ref[a, 4:9] /= 3.0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-11 * np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# SoA real-space pair pass vs float64 central differences
# ---------------------------------------------------------------------------

KAPPA = 0.7
M_SCALES = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])


@pytest.fixture(scope="module")
def pair_system():
    s = water_arrays(n_side=2, spacing=3.1, jitter=0.12, seed=21)
    n = s["positions"].shape[0]
    pairs = [[i, j] for i in range(n) for j in range(i + 1, n)]
    pairs += [[n, n]] * 8  # padding rows are masked
    q = convert_cart2harm(jnp.asarray(s["q_cart"]), 2)
    rng = np.random.default_rng(5)
    u = jnp.asarray(0.05 * rng.standard_normal((n, 3)))
    return dict(
        pos=jnp.asarray(s["positions"]), box=jnp.asarray(s["box"]),
        pairs=jnp.asarray(pairs, jnp.int32), q=q, u=u,
        pol=jnp.asarray(s["pol"]), tholes=jnp.asarray(s["tholes"]),
        cov=jnp.asarray(s["covalent_map"]),
    )


def _energies(sys_):
    def perm(pos):
        return pme_real_energy(pos, sys_["box"], sys_["pairs"], sys_["q"],
                               None, None, None, M_SCALES, None, sys_["cov"],
                               KAPPA, 2, False)

    def lpol(pos, u):
        return pme_real_energy(pos, sys_["box"], sys_["pairs"], sys_["q"],
                               cart_dipole_to_harm(u), sys_["pol"],
                               sys_["tholes"], M_SCALES, M_SCALES,
                               sys_["cov"], KAPPA, 2, True)

    def uu(pos, u):
        return pme_real_uu_energy(pos, sys_["box"], sys_["pairs"],
                                  cart_dipole_to_harm(u), sys_["pol"],
                                  sys_["tholes"], M_SCALES, sys_["cov"],
                                  KAPPA)

    return perm, lpol, uu


def _central_diff(fn, x, entries, eps):
    out = []
    x = np.asarray(x)
    for a, d in entries:
        xp, xm = x.copy(), x.copy()
        xp[a, d] += eps
        xm[a, d] -= eps
        out.append((np.asarray(fn(jnp.asarray(xp)))
                    - np.asarray(fn(jnp.asarray(xm)))) / (2.0 * eps))
    return np.asarray(out)


ENTRIES = [(0, 0), (1, 2), (5, 1), (13, 2), (22, 0)]


@pytest.mark.parametrize(
    "case", ["perm_pos", "lpol_pos", "lpol_u", "uu_u", "field_pos"])
def test_pair_pass_matches_f64_central_differences(pair_system, case):
    s = pair_system
    perm, lpol, uu = _energies(s)
    pos, u = s["pos"], s["u"]
    first_order = {
        "perm_pos": (perm, pos),
        "lpol_pos": (lambda p: lpol(p, u), pos),
        "lpol_u": (lambda v: lpol(pos, v), u),
        "uu_u": (lambda v: uu(pos, v), u),
    }
    if case in first_order:
        fn, x = first_order[case]
        grad = np.asarray(jax.jit(jax.grad(fn))(x))
        fd = _central_diff(jax.jit(fn), x, ENTRIES, 1e-5)
        got = np.array([grad[a, d] for a, d in ENTRIES])
        np.testing.assert_allclose(got, fd, rtol=1e-6,
                                   atol=1e-7 * np.max(np.abs(grad)))
        return
    # mixed second derivative d(field)/d(pos), field = dE/du: the product the
    # exact SCF adjoint pulls back through (vjp of the field w.r.t. positions)
    field = jax.jit(lambda p: jax.grad(lpol, argnums=1)(p, u))
    w = jnp.asarray(np.random.default_rng(8).standard_normal(u.shape))
    _, vjp = jax.vjp(field, pos)
    got_all = np.asarray(vjp(w)[0])
    fd = _central_diff(lambda p: jnp.sum(field(p) * w), pos, ENTRIES, 1e-5)
    got = np.array([got_all[a, d] for a, d in ENTRIES])
    np.testing.assert_allclose(got, fd, rtol=1e-6,
                               atol=1e-7 * np.max(np.abs(got_all)))


@pytest.mark.parametrize("shape", [(8, 10, 12), (9, 7, 5)])
def test_spectrum_sq_f64_matches_numpy_fft(shape):
    mesh = np.random.default_rng(len(shape) + shape[0]).standard_normal(shape)
    got = spectrum_sq(jnp.asarray(mesh))
    ref = np.abs(np.fft.fftn(mesh)[..., : shape[2] // 2 + 1]) ** 2
    assert got.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12,
                               atol=1e-12 * ref.max())
