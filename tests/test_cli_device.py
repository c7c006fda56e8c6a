"""Every CLI resolves ``--platform`` (``cpu | gpu | default``) through
``qcmrf_tpu.utils.device.resolve_platform``: ``gpu`` on a host without
one fails with a message naming the missing GPU, and ``cpu`` or a
small-model ``default`` pins the CPU.
"""

import json

import numpy as np
import pytest

from qcmrf_tpu.utils import device as udevice


@pytest.fixture()
def resolved(monkeypatch):
    """Record every (requested, selected) platform pair the CLIs resolve."""
    calls = []
    real = udevice.resolve_platform

    def spy(requested, **kw):
        out = real(requested, **kw)
        calls.append((requested, out))
        return out

    monkeypatch.setattr(udevice, "resolve_platform", spy)
    return calls


def _assert_no_gpu(excinfo):
    msg = str(excinfo.value)
    assert "no GPU found" in msg and "--platform cpu" in msg


# ---------------------------------------------------------------------------
# resolve_platform unit behavior
# ---------------------------------------------------------------------------


def test_resolve_cpu_pins_host():
    import jax

    assert udevice.resolve_platform("cpu") == "cpu"
    assert jax.default_backend() == "cpu"


def test_resolve_small_default_routes_to_cpu(capsys):
    out = udevice.resolve_platform(
        "default", small=True, small_reason="tiny", prog="t")
    assert out == "cpu"
    assert "--platform gpu" in capsys.readouterr().err


def test_resolve_default_takes_default_backend():
    import jax

    assert udevice.resolve_platform("default", prog="t") == \
        jax.default_backend()


def test_resolve_gpu_on_cpu_only_host():
    with pytest.raises(SystemExit) as e:
        udevice.resolve_platform("gpu", prog="t")
    _assert_no_gpu(e)
    assert udevice.gpu_devices() == []


def test_resolve_gpu_when_present(monkeypatch):
    monkeypatch.setattr(udevice, "gpu_devices", lambda: ["gpu:0"])
    assert udevice.resolve_platform("gpu", prog="t") == "gpu"


# ---------------------------------------------------------------------------
# one "--platform gpu fails clearly" and one "cpu is pinned" test per CLI
# ---------------------------------------------------------------------------


def test_infer_cli_bounded_failure():
    from qcmrf_tpu.runners import infer_cli

    with pytest.raises(SystemExit) as e:
        infer_cli.main(["--graph", "chain:28", "--query", "lnz",
                        "--platform", "gpu"])
    _assert_no_gpu(e)


def test_infer_cli_small_model_skips_probe(resolved, capsys):
    from qcmrf_tpu.runners import infer_cli

    r = infer_cli.main(["--graph", "chain:4", "--query", "lnz"])
    assert np.isclose(r["lnz"], 4 * np.log(2.0))  # theta=0: lnZ = n ln 2
    assert resolved == [("default", "cpu")]
    assert "--platform gpu" in capsys.readouterr().err


def test_train_cli_bounded_failure(tmp_path):
    from qcmrf_tpu.runners import train_cli

    with pytest.raises(SystemExit) as e:
        train_cli.main(["--graph", "chain:24", "--steps", "1",
                        "--platform", "gpu", "--outdir", str(tmp_path)])
    _assert_no_gpu(e)


def test_train_cli_cpu_pinned(resolved, tmp_path):
    from qcmrf_tpu.runners import train_cli

    train_cli.main(["--graph", "chain:4", "--steps", "1", "--samples",
                    "64", "--platform", "cpu", "--outdir", str(tmp_path)])
    assert resolved == [("cpu", "cpu")]


def test_run_experiment_cli_bounded_failure(tmp_path):
    from qcmrf_tpu.runners import run_experiment

    with pytest.raises(SystemExit) as e:
        run_experiment.main(["--engine", "analytic", "--platform", "gpu",
                             "--outdir", str(tmp_path)])
    _assert_no_gpu(e)


def test_run_experiment_cli_cpu_pinned(resolved, tmp_path, monkeypatch):
    from qcmrf_tpu.runners import run_experiment

    monkeypatch.setattr(run_experiment, "run_suite", lambda *a, **k: [])
    run_experiment.main(["--scale", "0.1", "--platform", "cpu",
                         "--outdir", str(tmp_path)])
    assert resolved == [("cpu", "cpu")]


def test_eval_cli_bounded_failure():
    from qcmrf_tpu.runners import eval as eval_cli

    with pytest.raises(SystemExit) as e:
        eval_cli.main(["--results", "result_simulation.json",
                       "--platform", "gpu"])
    _assert_no_gpu(e)


def test_eval_cli_cpu_pinned(resolved, monkeypatch):
    from qcmrf_tpu.runners import eval as eval_cli

    monkeypatch.setattr(eval_cli, "evaluate_suite", lambda *a, **k: [])
    monkeypatch.setattr(eval_cli, "results_table", lambda *a, **k: "")
    eval_cli.main(["--mode", "gibbs"])
    assert resolved == [("cpu", "cpu")]


def test_whisker_cli_bounded_failure():
    from qcmrf_tpu.viz import whisker

    with pytest.raises(SystemExit) as e:
        whisker.main(["--backend", "simulation", "--platform", "gpu"])
    _assert_no_gpu(e)


def test_whisker_cli_cpu_pinned(resolved, monkeypatch):
    from qcmrf_tpu.viz import whisker

    monkeypatch.setattr(whisker, "collect", lambda *a: (None, None, None))
    monkeypatch.setattr(whisker, "render", lambda *a, **k: "out.pdf")
    assert whisker.main(["--backend", "simulation"]) == "out.pdf"
    assert resolved == [("cpu", "cpu")]


# ---------------------------------------------------------------------------
# infer CLI ergonomics (round-4 verdict item 6 + advisor findings)
# ---------------------------------------------------------------------------


def test_infer_theta_inline_and_file(tmp_path):
    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.models.mrf import MRF
    from qcmrf_tpu.runners import infer_cli

    theta = [-0.3, -0.1, -0.7, -0.2, -0.5, -0.4, -0.6, -0.8]
    ref = float(ve.log_partition(
        MRF.create([[0, 1], [1, 2]], theta=np.asarray(theta))))

    inline = infer_cli.main(["--graph", "chain:3", "--query", "lnz",
                             "--theta", json.dumps(theta)])
    assert np.isclose(inline["lnz"], ref, rtol=1e-6)

    p = tmp_path / "theta.json"
    p.write_text(json.dumps(theta))
    from_file = infer_cli.main(["--graph", "chain:3", "--query", "lnz",
                                "--theta", str(p)])
    assert from_file["lnz"] == inline["lnz"]


def test_infer_theta_scale_random_init():
    from qcmrf_tpu.runners import infer_cli

    r1 = infer_cli.main(["--graph", "chain:3", "--query", "lnz",
                         "--theta-scale", "0.4", "--theta-seed", "7"])
    r2 = infer_cli.main(["--graph", "chain:3", "--query", "lnz",
                         "--theta-scale", "0.4", "--theta-seed", "7"])
    assert r1["lnz"] == r2["lnz"]          # seeded: reproducible
    assert r1["lnz"] < 3 * np.log(2.0)     # theta < 0 shrinks Z below 2^n


def test_infer_method_query_validation():
    from qcmrf_tpu.runners import infer_cli

    with pytest.raises(SystemExit) as e:
        infer_cli.main(["--graph", "chain:4", "--query", "map",
                        "--method", "ais"])
    assert "lnz, marginals and prob only" in str(e.value)
    with pytest.raises(SystemExit) as e:
        infer_cli.main(["--graph", "chain:4", "--query", "lnz",
                        "--method", "gibbs"])
    assert "sample only" in str(e.value)
    with pytest.raises(SystemExit) as e:
        infer_cli.main(["--graph", "chain:4", "--query", "sample",
                        "--method", "ais"])
    assert "lnz, marginals and prob only" in str(e.value)


def test_infer_batch_validates_methods_up_front(tmp_path, capsys):
    from qcmrf_tpu.runners import infer_cli

    q = tmp_path / "queries.jsonl"
    q.write_text(json.dumps({"query": "lnz"}) + "\n"
                 + json.dumps({"query": "map", "method": "ais"}) + "\n")
    with pytest.raises(SystemExit) as e:
        infer_cli.main(["--graph", "chain:4", "--queries", str(q)])
    assert "line 2" in str(e.value)
    # nothing was answered before the failure (validated up front)
    assert capsys.readouterr().out.strip() == ""


def test_infer_ais_chains_round_up_on_mesh():
    import jax

    from qcmrf_tpu.runners import infer_cli

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    # 10 chains over a 4-device mesh: rounded up to 12, noted, no raw
    # ValueError traceback (round-4 advisor finding)
    r = infer_cli.main(["--graph", "chain:5", "--query", "lnz",
                        "--method", "ais", "--ais-chains", "10",
                        "--ais-temps", "8", "--mesh", "4x1",
                        "--platform", "cpu"])
    assert r["ais"]["chains"] == 12
    assert "rounded up" in r["note"]


def test_infer_theta_bad_input_clean_error(tmp_path):
    from qcmrf_tpu.runners import infer_cli

    with pytest.raises(SystemExit, match="not a readable"):
        infer_cli.main(["--graph", "chain:3", "--query", "lnz",
                        "--theta", str(tmp_path / "missing.json")])
    with pytest.raises(SystemExit, match="not a readable"):
        infer_cli.main(["--graph", "chain:3", "--query", "lnz",
                        "--theta", "[not json"])
