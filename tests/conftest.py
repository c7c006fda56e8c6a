"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the environment before jax initializes its backends, so this file
touches env vars at import time (pytest imports conftest before any test
module). Multi-device sharding tests use the 8 virtual CPU devices; the
GPU is exercised by chip_smoke.py and bench.py, and by the tests marked
``gpu``, which skip here.
"""

import os

# The unit suite runs on CPU (8 virtual devices for sharding tests); the
# platform is also pinned through jax.config before any backend
# initializes. QCMRF_TESTS_ON_GPU=1 leaves the GPU visible, for the tests
# marked ``gpu``: QCMRF_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
ON_GPU = os.environ.get("QCMRF_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


REFERENCE_ROOT = "/root/reference"


@pytest.fixture(scope="session")
def reference_root():
    if not os.path.isdir(REFERENCE_ROOT):
        pytest.skip("reference data not available")
    return REFERENCE_ROOT


@pytest.fixture()
def gpu():
    """The visible GPUs; skips the test on a host without one (decided
    here, at run time, never while modules are imported)."""
    from qcmrf_tpu.utils.device import gpu_devices

    devs = gpu_devices()
    if not devs:
        pytest.skip("needs a GPU")
    return devs


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(0)


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_cpu_compile_state():
    """XLA:CPU segfaults inside ``backend_compile_and_load`` once a
    single process has accumulated several hundred compiled executables
    (reproduced 3x on 2026-08-20, ~25-40 min into the full suite, each
    time mid-compile of a DIFFERENT — sometimes trivial — program; the
    wedged post-segfault process is what looked like a suite timeout).
    Dropping every cached executable between test modules keeps the
    process-global JIT state bounded; module-local recompiles are the
    price."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()
