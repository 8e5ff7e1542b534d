"""Test harness configuration.

By default the suite runs on the host CPU with 8 virtual devices, forced
BEFORE jax initializes a backend, so:
  * every kernel runs in the Pallas interpreter (interpret=None resolves
    to True on the CPU), identically on GPU hosts and CPU-only CI;
  * multi-device sharding tests get a fake 8-device mesh (the standard
    ``xla_force_host_platform_device_count`` fake-cluster technique —
    needed because the reference has no multi-device story at all,
    SURVEY §4).

Tests marked ``gpu`` need the card: the ``_gpu_only`` fixture skips them
unless the default backend is a GPU.  ``chip_smoke.py`` runs them on the
card inside its own process (pytest in-process, one JAX process per card),
with ``RAYMARCHING_TESTS_ON_DEVICE=1`` so this file leaves the platform
alone.
"""

import os
import pathlib
import sys

if os.environ.get("RAYMARCHING_TESTS_ON_DEVICE") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENES = REPO / "scenes"


@pytest.fixture(scope="session")
def demo_scene_text():
    return (SCENES / "demo.txt").read_text()


@pytest.fixture(scope="session")
def scenes_dir():
    return SCENES


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a ``gpu``-marked test unless JAX's default backend is a GPU
    (decided here, per test, never at import or collection time)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs it on the card)")
