"""Evaluation CLI — same flags and output as the reference's eval.py.

Usage parity with /root/reference/eval.py:17-22::

    python -m qcmrf_tpu.runners.eval --results result_simulation.json \
        --scale 0.1 --mode file [--res-root /root/reference] [--kl]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from qcmrf_tpu.evaluation.harness import (
    evaluate_suite,
    load_result_dists,
    results_table,
)
from qcmrf_tpu.models.suite import generate_suite, load_suite


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(
        prog="QCMRF result evaluation.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--results", type=str,
                        default="result_ehningen.json",
                        help="Result file as downloaded from backend.")
    parser.add_argument("--scale", type=str, default="0.1",
                        help="Variance of parameter prior.")
    parser.add_argument("--mode", type=str, default="file",
                        help="file or gibbs or pam.")
    parser.add_argument("--native", action="store_true",
                        help="Use the C++ engine for gibbs/pam sampling "
                             "(the reference's kiopto_native role).")
    parser.add_argument("--res-root", type=str, default=".",
                        help="Directory containing res_{scale}/ folders.")
    parser.add_argument("--kl", action="store_true",
                        help="Also report mean KL divergence.")
    parser.add_argument("--norm", type=float, default=None,
                        help="Override the counts normalization (the "
                             "reference hardcodes 10000 shots, eval.py:60; "
                             "pass the actual shot count for files produced "
                             "with --shots != 10000).")
    parser.add_argument("--platform", type=str, default="cpu",
                        choices=["cpu", "gpu", "default"],
                        help="Device for the evaluation math. The suite's "
                             "models are <= 32 states, so CPU avoids "
                             "per-graph accelerator compiles and is much "
                             "faster end-to-end.")
    parser.add_argument("--num-samples", type=int, default=10_000,
                        help="gibbs/pam modes: samples to histogram (the "
                             "success column divides by the fixed 10000 "
                             "norm, matching the reference quirk).")
    from qcmrf_tpu.utils.config import parse_with_config

    args = parse_with_config(parser, argv)

    from qcmrf_tpu.utils.device import resolve_platform
    resolve_platform(args.platform, prog="qcmrf_tpu eval")

    from qcmrf_tpu.utils.config import enable_compilation_cache
    enable_compilation_cache()

    # suite: prefer the stored models file for bit-parity, else regenerate
    res_dir = os.path.join(args.res_root, f"res_{args.scale}")
    suite = None
    for name in (f"models_{args.scale}.json", "models.json"):
        p = os.path.join(res_dir, name)
        if os.path.isfile(p):
            suite = load_suite(p, float(args.scale))
            break
    if suite is None:
        suite = generate_suite(float(args.scale))

    dists, norm = (None, 10_000)
    if args.mode == "file":
        dists, norm = load_result_dists(
            os.path.join(res_dir, args.results)
        )
    if args.norm is not None:
        norm = args.norm

    results = evaluate_suite(suite, dists=dists, norm=norm, mode=args.mode,
                             native=args.native,
                             num_samples=args.num_samples)
    table = results_table(results, with_kl=args.kl)
    print(table)
    return table


if __name__ == "__main__":
    main()
