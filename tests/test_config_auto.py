"""Auto-resolving defaults (the measured-best configuration must be the
DEFAULT, not a bench-only kwarg set):

* fft_friendly_grid='auto' resolves the same way on every backend;
* pairs_i_sorted='auto' — raw arrays take the safe unsorted path, passing
  the NeighborList OBJECT resolves the hint from its own i_sorted contract.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

from admp_tpu import ADMPPmeForce, ADMPDispPmeForce, convert_cart2harm
from admp_tpu import settings
from admp_tpu.ops.ewald import (
    next_fft_friendly,
    setup_ewald_parameters,
    setup_ewald_parameters_fft,
)
from admp_tpu.ops.neighborlist import neighbor_list_cell
from admp_tpu.settings import EngineConfig
from admp_tpu.systems import water_system


@pytest.mark.parametrize("auto", [False, True])
def test_fft_friendly_auto_resolution_ignores_backend(auto):
    """'auto' takes settings.FFT_FRIENDLY_AUTO whatever the backend; explicit
    values pass through. The 98k-atom box (n_side=32) is where the choice
    bites: the heuristic K=305 (5 x 61) rounds up to 320."""
    box = np.eye(3) * 32 * 3.104  # water_system(n_side=32)'s cell
    _, k1, _, _ = setup_ewald_parameters(4.0, 1e-4, box)
    _, kf, _, _ = setup_ewald_parameters_fft(4.0, 1e-4, box)
    assert (k1, kf) == (305, 320)
    assert next_fft_friendly(kf) == kf
    for backend in ("cpu", "gpu"):
        with mock.patch.object(settings, "FFT_FRIENDLY_AUTO", auto), \
                mock.patch("jax.default_backend", return_value=backend):
            assert EngineConfig().resolve_fft_friendly() is auto
            assert EngineConfig(fft_friendly_grid=True).resolve_fft_friendly()
            assert not EngineConfig(
                fft_friendly_grid=False).resolve_fft_friendly()


def test_pairs_auto_resolution_from_neighborlist():
    s = water_system(n_side=3, spacing=3.1, jitter=0.1, seed=0)
    pos, box = jnp.asarray(s["positions"]), jnp.asarray(s["box"])
    nl = neighbor_list_cell(np.asarray(pos), np.asarray(box), 4.0)
    assert nl.i_sorted
    q = convert_cart2harm(jnp.asarray(s["q_cart"]), 2)
    m = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])

    pme = ADMPPmeForce(
        box, s["axis_types"], s["axis_indices"], s["covalent_map"],
        4.0, 1e-4, lmax=2,
    )
    # default EngineConfig is 'auto', resolved to the safe False at init
    assert pme._pairs_auto and pme.config.pairs_i_sorted is False

    e_arr = pme.get_energy(pos, box, jnp.asarray(nl.pairs), q, m)
    assert pme.config.pairs_i_sorted is False  # raw array: stays safe
    e_nl = pme.get_energy(pos, box, nl, q, m)
    assert pme.config.pairs_i_sorted is True   # NL provenance: sorted path
    np.testing.assert_allclose(float(e_arr), float(e_nl), rtol=1e-12)

    _, f_nl = pme.get_forces(pos, box, nl, q, m)
    # forces must match the explicit-flag build bitwise-class
    pme_ref = ADMPPmeForce(
        box, s["axis_types"], s["axis_indices"], s["covalent_map"],
        4.0, 1e-4, lmax=2,
        config=EngineConfig(pairs_i_sorted=True),
    )
    _, f_ref = pme_ref.get_forces(pos, box, jnp.asarray(nl.pairs), q, m)
    np.testing.assert_allclose(
        np.asarray(f_nl), np.asarray(f_ref), rtol=0, atol=0
    )

    disp = ADMPDispPmeForce(box, s["covalent_map"], 4.0, 1e-4, pmax=10)
    e_d_arr = disp.get_energy(
        pos, box, jnp.asarray(nl.pairs), jnp.asarray(s["c_list"]), m
    )
    e_d_nl = disp.get_energy(pos, box, nl, jnp.asarray(s["c_list"]), m)
    assert disp.config.pairs_i_sorted is True
    np.testing.assert_allclose(float(e_d_arr), float(e_d_nl), rtol=1e-12)


def test_explicit_flag_still_respected():
    cfg = EngineConfig(pairs_i_sorted=False)
    s = water_system(n_side=2, spacing=3.1, jitter=0.1, seed=0)
    box = jnp.asarray(s["box"])
    pme = ADMPPmeForce(
        box, s["axis_types"], s["axis_indices"], s["covalent_map"],
        4.0, 1e-4, lmax=2, config=cfg,
    )
    assert not pme._pairs_auto
    nl = neighbor_list_cell(np.asarray(s["positions"]), np.asarray(box), 4.0)
    pos = jnp.asarray(s["positions"])
    q = convert_cart2harm(jnp.asarray(s["q_cart"]), 2)
    m = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])
    pme.get_energy(pos, box, nl, q, m)  # NL accepted, but no flip
    assert pme.config.pairs_i_sorted is False


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_rule(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX uses it and the package sets no
    directory of its own. Unset: the cache is the fixed .jax_cache inside the
    checkout, wherever the process runs from."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "ADMP_TPU_COMPILATION_CACHE")}
    env["PYTHONPATH"] = repo
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = ("import admp_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = (str(tmp_path / "cc") if env_dir
            else os.path.join(repo, ".jax_cache"))
    assert out.stdout.strip().splitlines()[-1] == want
