"""Experiment driver: generate/load a suite, execute it, dump counts JSON.

Re-implementation of the reference's ``run_experiment.py``
simulation path (/root/reference/run_experiment.py:42-61): builds the 70
circuits of a suite, executes them at 10 000 shots each, and writes
``result_simulation_{scale}.json`` as a JSON list of 70 ``{bitstring:
count}`` dicts — byte-compatible schema with the stored files so the
evaluation harness (ours or the reference's) consumes either.

Execution engines:

* ``analytic`` (default): per-circuit joint outcome distribution in closed
  form + categorical shot sampling — the flagship path;
* ``statevector``: gate-level dense simulation of the compiled circuit IR,
  vmapped over each graph's draws (validation path, identical statistics);
* ``noisy:<preset>``: noise-channel emulation producing hardware-like
  counts (see :mod:`qcmrf_tpu.noise`).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

import jax

from qcmrf_tpu.models.suite import (
    SHOTS,
    ModelSuite,
    generate_suite,
    load_suite,
    reference_models_path,
)
from qcmrf_tpu.sim import batch as sbatch
from qcmrf_tpu.sim import sampler


def run_suite(
    suite: ModelSuite,
    shots: int = SHOTS,
    engine: str = "analytic",
    seed: int = 0,
    res_root: str = "/root/reference",
) -> List[Dict[str, int]]:
    """Execute every circuit of the suite; returns counts dicts in order."""
    key = jax.random.PRNGKey(seed)
    counts_list: List[Dict[str, int]] = []

    if engine.startswith("calibrated"):
        # calibrated hardware emulation: the PHYSICAL per-gate channel
        # model (noise.physical — gate-level depolarizing in the density
        # engine + readout/mitigation drift), loaded from the stored
        # calibration JSONs fitted against the reference result files;
        # reproduces the stored per-graph F-bar, delta-hat, KL and +-std
        # columns. Falls back to re-fitting the legacy statistical model
        # (noise.fit.fit_calibrated) when no stored calibration exists
        # for this backend/scale.
        from qcmrf_tpu.noise import physical as nphysical

        backend = engine.split(":", 1)[1] if ":" in engine else "torino"
        # the stored calibrations were fitted to the DEFAULT reference
        # tables; a custom --res-root points at different target data,
        # so it must trigger a fresh fit rather than silently using a
        # calibration for the wrong tables
        custom_root = os.path.realpath(res_root) != os.path.realpath(
            "/root/reference")
        try:
            if custom_root:
                raise FileNotFoundError(res_root)
            model = nphysical.load_physical(backend, suite.scale)
        except FileNotFoundError:
            from qcmrf_tpu.evaluation.harness import load_result_dists
            from qcmrf_tpu.models.suite import reference_results_path
            from qcmrf_tpu.noise import backends as nbackends
            from qcmrf_tpu.noise.fit import fit_calibrated

            dists, norm = load_result_dists(
                reference_results_path(suite.scale, backend, res_root)
            )
            legacy = fit_calibrated(backend, suite, dists, norm)
            return nbackends.run_calibrated_suite(key, suite, legacy,
                                                  shots)
        return nphysical.run_physical_suite(key, suite, model, shots)

    if engine.startswith("noisy"):
        from qcmrf_tpu.noise import backends as nbackends

        preset = engine.split(":", 1)[1] if ":" in engine else "torino"
        model = nbackends.preset(preset)
        # mitigated presets emit the full hardware result-file schema
        # ({quasi_dists, metadata}, like res_*/result_torino.json);
        # unmitigated ones a plain counts list
        return nbackends.run_noisy_suite(key, suite, model, shots)

    for j, C in enumerate(suite.graphs):
        thetas = np.asarray(suite.thetas[j], dtype=np.float32)
        n = max(v for c in C for v in c) + 1
        K = len(C)
        width = n + K + 1
        if engine == "analytic":
            keys = sbatch.batched_sample_outcomes(
                C, thetas, jax.random.fold_in(key, j), shots
            )
            for b in range(thetas.shape[0]):
                counts_list.append(
                    sampler.counts_from_samples(np.asarray(keys[b]), width)
                )
        elif engine == "statevector":
            # gate-level dense simulation, vmapped over the graph's draws
            probs_all = sbatch.batched_circuit_probs(C, thetas)
            for i in range(thetas.shape[0]):
                key, sub = jax.random.split(key)
                counts_list.append(
                    sampler.sample_counts(sub, probs_all[i], shots, width)
                )
        else:
            raise ValueError(f"unknown engine {engine!r}")
    return counts_list


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(
        prog="QCMRF experiment driver.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--scale", type=str, default="0.5",
                        help="Variance of parameter prior.")
    parser.add_argument("--shots", type=int, default=SHOTS)
    parser.add_argument("--engine", type=str, default="analytic",
                        help="analytic | statevector | noisy:<preset> | "
                             "calibrated:<hw backend> (fit to stored "
                             "hardware tables)")
    parser.add_argument("--res-root", type=str, default="/root/reference",
                        help="Root holding res_{scale}/result_*.json for "
                             "the calibrated engine's fit targets.")
    parser.add_argument("--models", type=str, default=None,
                        help="Load suite from this models_*.json instead of "
                             "regenerating from seed 1984.")
    parser.add_argument("--outdir", type=str, default=".")
    # dest matches Config.sample_seed (Config.seed is the SUITE-generation
    # seed, a reference-parity constant — binding it here would silently
    # change the sampling stream instead)
    parser.add_argument("--sample-seed", "--seed", dest="sample_seed",
                        type=int, default=0)
    parser.add_argument("--platform", type=str, default="default",
                        choices=["cpu", "gpu", "default"],
                        help="Force a device. The reference suite's models "
                             "are tiny (<= 10 qubits); 'cpu' avoids "
                             "per-circuit accelerator dispatch for the "
                             "noisy/statevector engines.")
    from qcmrf_tpu.utils.config import (
        dump_effective_config,
        parse_with_config,
    )

    args = parse_with_config(parser, argv)

    from qcmrf_tpu.utils.device import resolve_platform
    resolve_platform(args.platform, prog="qcmrf_tpu run_experiment")

    from qcmrf_tpu.utils.config import enable_compilation_cache
    enable_compilation_cache()

    if args.models:
        suite = load_suite(args.models, float(args.scale))
    else:
        ref = reference_models_path(float(args.scale))
        if os.path.isfile(ref):
            suite = load_suite(ref, float(args.scale))
        else:
            suite = generate_suite(float(args.scale))

    os.makedirs(args.outdir, exist_ok=True)
    models_path = os.path.join(args.outdir, f"models_{args.scale}.json")
    suite.save(models_path)
    dump_effective_config(
        args, os.path.join(args.outdir, f"config_run_{args.scale}.json")
    )

    from qcmrf_tpu.utils import profiling

    ctr = profiling.Counter()
    with profiling.stopwatch(ctr, sync=jax):
        counts = run_suite(suite, shots=args.shots, engine=args.engine,
                           seed=args.sample_seed, res_root=args.res_root)
    tag = args.engine.replace(":", "_")
    out_path = os.path.join(
        args.outdir, f"result_{tag}_{args.scale}.json"
    )
    with open(out_path, "w") as f:
        f.write(json.dumps(counts, indent=4))
    num = (len(counts["quasi_dists"])
           if isinstance(counts, dict) else len(counts))
    ctr.add(items=float(num) * args.shots)
    print(f"wrote {out_path} ({num} circuits, {args.shots} shots; "
          f"{ctr.seconds:.1f}s, {ctr.items_per_sec:,.0f} shots/sec "
          "end-to-end)")
    return out_path


if __name__ == "__main__":
    main()
