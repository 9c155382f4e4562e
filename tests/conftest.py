"""Test configuration: CPU backend with a virtual 8-device mesh, float64 on.

Goldens from the reference were produced in double precision
(reference: admp/settings.py:5); tests verify against them on CPU. A caller
that sets JAX_PLATFORMS keeps it: chip_smoke.py runs the `gpu`-marked tests
(the float32-vs-float64 checks on the card) with the GPU visible.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The GPU JAX runs on by default; skips where there is none."""
    try:
        dev = jax.devices()[0]
    except RuntimeError as exc:  # pragma: no cover - backend init failure
        pytest.skip(f"no JAX backend: {exc}")
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


REFERENCE_ROOT = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_examples():
    """Path to the reference's example data (PDB/XML/golden outputs).

    Golden-parity tests read the water boxes straight from the read-only
    reference checkout; they are skipped when it is absent.
    """
    path = REFERENCE_ROOT / "examples"
    if not path.exists():
        pytest.skip("reference example data not available")
    return path


@pytest.fixture(scope="session")
def water1024(reference_examples):
    from admp_tpu.io import load_mpid_system

    return load_mpid_system(
        str(reference_examples / "water_1024" / "water1024.pdb"),
        str(reference_examples / "water_1024" / "mpidwater.xml"),
    )
