"""chip_smoke.py's phases and reference comparisons at tiny sizes on the
CPU, and its refusal to report anything without a GPU or the package."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "phase", ["paper", "sampler", "gates", "inference", "training"])
def test_chip_smoke_phase_tiny(phase, tmp_path, capsys):
    cs = _chip_smoke()
    failed = cs.run(cs.TINY, [(phase, dict(cs.PHASES)[phase])],
                    str(tmp_path / "out"))
    out = capsys.readouterr().out
    assert failed == [], out
    assert "[ok]" in out and "[FAIL]" not in out


def test_chip_smoke_four_cards_on_virtual_mesh(tmp_path, capsys):
    """The four-card phase rehearsed on 4 of the 8 virtual CPU devices:
    every sharded path against its reference, the results spread over
    all four devices."""
    cs = _chip_smoke()
    failed = cs.run(cs.TINY, [("four cards", cs.phase_four_cards)],
                    str(tmp_path / "out"))
    out = capsys.readouterr().out
    assert failed == [], out
    assert out.count("[ok]") == 4
    assert "devices [0, 1, 2, 3]" in out


def test_chip_smoke_without_gpu_fails():
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=_REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert r.stdout.strip() == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
