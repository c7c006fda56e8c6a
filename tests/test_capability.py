"""models/capability.py: one source of truth for regime caps + routing.

Round-4 verdict item 9: the feasibility caps were scattered across four
modules and the CLIs re-derived routing independently. These tests pin
(a) that the historical constants are now aliases of the capability
module's, and (b) that :func:`capability.explain`'s ``selected`` backend
agrees with what the infer CLI actually routes to.
"""

import numpy as np
import pytest

from qcmrf_tpu.models import capability, elimination, moments
from qcmrf_tpu.models import sample as msample
from qcmrf_tpu.models import train as mtrain
from qcmrf_tpu.runners import infer_cli

WIDE_30 = [[i, j] for i in range(30) for j in range(i + 1, 30)]
CHAIN_6 = [[i, i + 1] for i in range(5)]


def test_caps_single_sourced():
    assert mtrain._ELIM_WIDTH_CAP is capability.ELIM_WIDTH_CAP
    assert moments._MAX_N is capability.STREAMING_MAX_N
    assert elimination._MMAP_WIDTH_CAP is capability.MMAP_WIDTH_CAP
    assert (elimination._SAMPLER_TABLE_FLOATS_CAP
            is capability.SAMPLER_TABLE_FLOATS_CAP)
    assert msample._EXACT_TABLE_HARD_N is capability.EXACT_TABLE_HARD_N


def test_explain_matches_infer_routing_bounded_width():
    r = capability.explain(CHAIN_6, 6, query="lnz")
    assert r["selected"] == "elimination"
    got = infer_cli.main(["--graph", "chain:6", "--query", "lnz"])
    assert got["backend"] == r["selected"]


def test_explain_matches_infer_routing_wide():
    # complete pairwise graph on 30 vars: width 29 > cap -> streaming
    r = capability.explain(WIDE_30, 30, query="lnz")
    assert r["selected"] == "streaming"
    assert not r["backends"]["elimination"]["feasible"]
    assert str(r["induced_width"]) in r["backends"]["elimination"]["reason"]


def test_explain_past_both_caps_selects_ais():
    wide_50 = [[i, j] for i in range(50) for j in range(i + 1, 50)]
    r = capability.explain(wide_50, 50, query="lnz")
    assert r["selected"] == "ais"
    assert not r["backends"]["streaming"]["feasible"]
    r = capability.explain(wide_50, 50, query="map")
    assert r["selected"] is None  # no backend: exactly the refusal case


def test_explain_mmap_constrained_width():
    # star graph: unconstrained width 2, but maximizing over the leaves
    # defers them past the sums — the constrained width blows up
    star = [[0, i] for i in range(1, 12)]
    r = capability.explain(star, 12, query="mmap",
                           max_vars=list(range(1, 12)))
    assert r["backends"]["elimination"]["feasible"] is (
        elimination.mmap_width(star, 12, list(range(1, 12)), {})
        <= capability.ELIM_WIDTH_CAP)
    r2 = capability.explain(star, 12, query="mmap", max_vars=[1])
    assert r2["selected"] == "elimination"


def test_explain_sample_backends():
    r = capability.explain(CHAIN_6, 6, query="sample")
    assert r["selected"] == "sampler:exact"
    assert r["backends"]["sampler:gibbs"]["feasible"]
    wide_50 = [[i, j] for i in range(50) for j in range(i + 1, 50)]
    r = capability.explain(wide_50, 50, query="sample")
    assert not r["backends"]["sampler:exact"]["feasible"]


def test_infer_explain_flag(capsys):
    import json

    r = infer_cli.main(["--graph", "chain:6", "--query", "lnz",
                        "--explain"])
    assert r["selected"] == "elimination"
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["backends"]["elimination"]["feasible"]


def test_infer_explain_never_probes(monkeypatch):
    # --explain is host-side: even for a huge model it must answer
    # without selecting a platform (no backend init anywhere)
    from qcmrf_tpu.utils import device as udevice

    def refuse(*a, **k):
        raise AssertionError("--explain resolved a platform")

    monkeypatch.setattr(udevice, "resolve_platform", refuse)
    r = infer_cli.main(["--graph", "chain:40", "--query", "lnz",
                        "--explain"])
    assert r["n"] == 40 and r["selected"] == "elimination"


def test_big_n_threshold_env(monkeypatch):
    assert capability.big_n_threshold() == 30
    monkeypatch.setenv("QCMRF_BIG_N_THRESHOLD", "5")
    assert capability.big_n_threshold() == 5
