"""entry() jit-compiles; dryrun_multichip rehearses the sharded paths on
a virtual CPU mesh, in-process or from a fresh interpreter."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    x, a = jax.block_until_ready(out)
    assert x.shape == (8192,)
    assert a.shape == (8192,)
    # variable draws uniform over 2^20
    assert int(np.asarray(x).min()) >= 0
    assert int(np.asarray(x).max()) < (1 << 20)


@pytest.mark.parametrize(
    "n_devices", [2, pytest.param(8, marks=pytest.mark.slow)]
)
def test_dryrun_multichip(n_devices):
    import __graft_entry__ as g

    g.dryrun_multichip(n_devices)  # asserts finite loss + sharded==dense


def test_flags_rewrite_replaces_existing_count():
    import __graft_entry__ as g

    out = g._flags_with_device_count(
        "--foo --xla_force_host_platform_device_count=8 --bar", 16
    )
    assert out.count("xla_force_host_platform_device_count") == 1
    assert "device_count=16" in out
    assert "--foo" in out and "--bar" in out


_DRIVER_CODE = (
    "import sys; sys.path.insert(0, {repo!r}); "
    "import __graft_entry__ as g; g.dryrun_multichip(8); "
    "print('dryrun ok')"
).format(repo=_REPO)


@pytest.mark.slow
def test_dryrun_driver_env():
    """Run the dryrun from a fresh interpreter with no device-count flag:
    it must bootstrap the virtual CPU mesh itself."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("QCMRF_DRYRUN_CHILD", None)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c", _DRIVER_CODE],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dryrun ok" in r.stdout


def test_bench_fails_without_gpu():
    """bench.py measures the card only: on a CPU-only host it exits
    non-zero naming the missing GPU, and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "bench.py"],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert r.stdout.strip() == ""
