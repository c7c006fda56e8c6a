"""Unified CLI, typed config, profiling utilities."""

import json
import subprocess
import sys

import numpy as np
import pytest

from qcmrf_tpu.utils.config import Config
from qcmrf_tpu.utils import profiling
from qcmrf_tpu.utils.table import format_table


def test_config_roundtrip():
    c = Config(scale=0.25, engine="noisy:torino", mesh_shape=(4, 2),
               mesh_axes=("amp", "data"))
    c2 = Config.from_json(c.to_json())
    assert c2 == c


def test_config_mesh():
    c = Config(mesh_shape=(4, 2), mesh_axes=("amp", "data"))
    mesh = c.make_mesh()
    assert mesh.shape == {"amp": 4, "data": 2}
    assert Config(mesh_shape=()).make_mesh() is None


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_helper(tmp_path, monkeypatch, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache goes
    to the fixed, git-ignored directory in the checkout on an
    accelerator, and stays off on the CPU."""
    import os

    import jax

    from qcmrf_tpu.utils import config as ucfg

    # the default is a fixed path in the checkout, git-ignored
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert ucfg.CHECKOUT_CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

    prev = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "c"))
            assert ucfg.enable_compilation_cache() == str(tmp_path / "c")
            assert jax.config.jax_compilation_cache_dir == str(
                tmp_path / "c")
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert ucfg.enable_compilation_cache() is None  # CPU: off
            monkeypatch.setattr(ucfg, "CHECKOUT_CACHE_DIR",
                                str(tmp_path / "checkout" / ".jax_cache"))
            monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
            got = ucfg.enable_compilation_cache()
            assert got == str(tmp_path / "checkout" / ".jax_cache")
            assert os.path.isdir(got)
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          prev_min)


def test_counter():
    c = profiling.Counter()
    c.add(items=100, nbytes=1e9, seconds=2.0)
    assert c.items_per_sec == 50.0
    assert c.gb_per_sec == 0.5
    r = c.report()
    assert r["items"] == 100


def test_timed():
    import jax.numpy as jnp

    dt = profiling.timed(lambda: jnp.ones(8).sum(), reps=3)
    assert dt >= 0


def test_table_format():
    s = format_table(["a", "bb"], [["1", "22"], ["333", "4"]])
    lines = s.splitlines()
    assert lines[0].startswith("+")
    assert "a" in lines[1] and "bb" in lines[1]
    assert len(lines) == 6


def test_cli_help_and_unknown():
    from qcmrf_tpu.__main__ import main

    assert main([]) == 0
    assert main(["definitely-not-a-command"]) == 2


def test_cli_eval_subcommand(reference_root, capsys):
    from qcmrf_tpu.__main__ import main

    rc = main(["eval", "--results", "result_simulation.json",
               "--scale", "0.1", "--res-root", reference_root])
    assert rc == 0
    out = capsys.readouterr().out
    assert "success rate" in out
    assert "0.928" in out  # BASELINE.md graph [[0]] delta
