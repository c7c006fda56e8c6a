"""Evaluation harness: fidelity / success-rate tables over a result suite.

Re-implementation of the reference's ``eval.py``
(/root/reference/eval.py): same CLI semantics (``--results``, ``--scale``,
``--mode file|gibbs|pam``), same result-format sniffing (dict with
``quasi_dists`` -> hardware with norm 1; bare list -> raw counts with norm
10 000; eval.py:55-60), same post-selection (keys with ``int(k, 2) < 2**n``,
eval.py:115-122), same aggregation (mean/std/best fidelity, success rate
``Z/norm``, fidelity clamped to [0, 1]; eval.py:123-143).

Differences by design:

* exact reference probabilities come from the vectorized JAX MRF core (one
  ``logsumexp`` instead of 2**n native ``logpot`` calls through kiopto);
* the gibbs/pam comparison modes run the jit-compiled samplers of
  :mod:`qcmrf_tpu.models.sample`;
* additionally reports KL and the theoretical success rate Z/2**n.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

import jax

from qcmrf_tpu.evaluation import metrics
from qcmrf_tpu.models import sample as msample
from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.models.suite import ModelSuite, SHOTS
from qcmrf_tpu.utils.table import format_table


@dataclasses.dataclass
class GraphResult:
    graph: List[List[int]]
    fidelities: List[float]
    successes: List[float]
    kls: List[float]

    @property
    def mean_f(self) -> float:
        return float(np.mean(self.fidelities))

    @property
    def std_f(self) -> float:
        return float(np.std(self.fidelities))

    @property
    def best_f(self) -> float:
        return float(np.max(self.fidelities))

    @property
    def mean_delta(self) -> float:
        return float(np.mean(self.successes))

    @property
    def std_delta(self) -> float:
        return float(np.std(self.successes))

    @property
    def mean_kl(self) -> float:
        return float(np.mean(self.kls))


def load_result_dists(path: str):
    """Load a result file; returns (dists, norm) with the reference's
    format sniffing (eval.py:49-62)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        results_file = json.load(f)
    try:
        dists = results_file["quasi_dists"]
        norm = 1
    except (TypeError, KeyError):
        dists = results_file
        norm = SHOTS
    return dists, norm


def _counts_from_samples(state_ids: np.ndarray, N: int) -> np.ndarray:
    return np.bincount(state_ids, minlength=N).astype(np.float64)


def _native_sample_ids(mrf: MRF, pam: bool, num: int, seed: int) -> np.ndarray:
    """Sample through the C++ engine; bits -> state ids (variable 0 MSB)."""
    from qcmrf_tpu.native import kiopto as px

    b = px.backend(mrf.cliques, np.array([2] * mrf.n))
    px.weights(b)[:] = np.asarray(mrf.theta, np.float64)
    if pam:
        S = px.sample(b, pam=True, num=num, seed=seed)
    else:
        # reference flow: thin a long chain by 10 (eval.py:96-98)
        S = px.sample(b, num=num * 10 + 10, seed=seed)[::10][1:][:num]
    weights = 1 << np.arange(mrf.n - 1, -1, -1)
    return (S * weights).sum(axis=1)


def evaluate_suite(
    suite: ModelSuite,
    dists: Optional[Sequence[Dict[str, float]]] = None,
    norm: float = SHOTS,
    mode: str = "file",
    key: Optional[jax.Array] = None,
    num_samples: int = SHOTS,
    native: bool = False,
) -> List[GraphResult]:
    """Evaluate every (graph, rep) model; returns per-graph aggregates.

    ``mode='file'`` compares against measured distributions ``dists`` (one
    per circuit, suite order); ``'gibbs'``/``'pam'`` run the classical
    samplers instead (eval.py:95-113) — the jit-compiled JAX chains by
    default, or the C++ engine (``native=True``), matching the reference's
    use of kiopto_native for these modes.
    """
    if mode == "file" and dists is None:
        raise ValueError("mode='file' requires result distributions")
    if key is None:
        key = jax.random.PRNGKey(0)

    from qcmrf_tpu.sim import batch as sbatch

    out: List[GraphResult] = []
    idx = 0
    for j, C in enumerate(suite.graphs):
        gr = GraphResult(graph=C, fidelities=[], successes=[], kls=[])
        # one vmapped jit call per graph: all reps' exact distributions
        p_all = np.asarray(
            sbatch.batched_gibbs_probs(C, np.asarray(suite.thetas[j])),
            dtype=np.float64,
        )
        for i, theta in enumerate(suite.thetas[j]):
            mrf = MRF.create(C, theta=theta)
            n, N = mrf.n, mrf.num_states
            p = p_all[i]

            if mode == "gibbs":
                if native:
                    s = _native_sample_ids(mrf, pam=False,
                                           num=num_samples, seed=idx)
                else:
                    key, sub = jax.random.split(key)
                    s = np.asarray(
                        msample.sample_gibbs(sub, mrf, num_samples,
                                             thin=10, burn=10)
                    )
                q = _counts_from_samples(s, N)
                Z = q.sum()
                # Reference semantics (eval.py:95-104): delta-hat is the
                # histogrammed-sample count over a FIXED norm of 10 000,
                # not over num_samples — with kiopto's default chain the
                # thinned count happens to equal the norm (documented in
                # native/kiopto.py), but e.g. num_samples=999 must print
                # delta-hat = 0.0999 exactly like the reference quirk.
                this_norm = SHOTS
            elif mode == "pam":
                if native:
                    s = _native_sample_ids(mrf, pam=True,
                                           num=num_samples, seed=idx)
                else:
                    key, sub = jax.random.split(key)
                    s = np.asarray(msample.sample_pam(sub, mrf, num_samples))
                q = _counts_from_samples(s, N)
                Z = q.sum()
                this_norm = SHOTS  # fixed norm, eval.py:106-113
            elif mode == "file":
                Q = dists[idx]
                q = np.zeros(N)
                Z = 0.0
                for k, v in Q.items():
                    kid = int(k, 2)
                    if kid < N:
                        q[kid] = v
                        Z += v
                this_norm = norm
            else:
                raise ValueError(f"unknown mode {mode!r}")

            q = q / Z if Z != 0 else q
            mF = float(metrics.fidelity(p, q))
            mF = max(min(mF, 1.0), 0.0)  # clamp, eval.py:125-126
            gr.fidelities.append(mF)
            gr.successes.append(float(Z / this_norm))
            gr.kls.append(float(metrics.kl(p, q)))
            idx += 1
        out.append(gr)
    return out


def results_table(results: List[GraphResult], with_kl: bool = False) -> str:
    """Render the eval table (same columns as eval.py:68, optionally +KL)."""
    header = ["graph", "fidelity", "max fidelity", "success rate"]
    if with_kl:
        header.append("KL")
    rows = []
    for r in results:
        row = [
            str(r.graph),
            "{:.3f} ±{:.3f}".format(r.mean_f, r.std_f),
            "{:.3f}".format(r.best_f),
            "{:.3f} ±{:.3f}".format(r.mean_delta, r.std_delta),
        ]
        if with_kl:
            row.append("{:.4f}".format(r.mean_kl))
        rows.append(row)
    return format_table(header, rows)
