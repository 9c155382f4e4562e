"""chip_smoke.py at toy sizes on the CPU: every phase runs through the same
code the card runs, and its float32 result agrees with float64. The script's
device check refuses a host without a GPU, and the script refuses to run
outside a checkout of the repository."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

# At 81-375 atoms the Ewald self term is only 3e4-1e5 kJ/mol, so 1e-6 of it
# sits below the f32 rounding of the reciprocal sums themselves (measured
# |dE| ~ 2e-6 x self at n_side=3 for the full force field); the full-size
# runs hold the 1e-6 bound.
TOY_ENERGY_TOL = 1e-5

TOY = {
    "a": dict(n_side=3, n_steps=1),
    "b": dict(n_side=3, n_steps=1),
    "c": dict(n_side=3, n_steps=1),
    "d": dict(n_side=3, k=16, n_steps=1),
}


@pytest.mark.parametrize("phase", sorted(TOY))
def test_phase_runs_and_f32_matches_f64(phase):
    result = chip_smoke.PHASES[phase](**TOY[phase])
    assert result["samples"] == TOY[phase]["n_steps"]
    assert result["ms_per_step_median"] > 0
    chip_smoke.check(result, energy_tol_rel_self=TOY_ENERGY_TOL)


def test_refuses_hosts_without_gpu(tmp_path):
    """The in-process device check exits non-zero on a CPU-only JAX, and the
    script alone (no package beside it) exits non-zero without a result."""
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(chip_smoke.__file__, alone)
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
