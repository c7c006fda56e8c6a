"""Scaling run: synthetic n=24-31 qubit grid MRFs on a sharded mesh.

BASELINE.json config 5: "Synthetic n=24-28 qubit grid MRFs: sharded
statevector with all-to-all qubit remap, repeated-estimation throughput
run". This driver builds grid MRFs beyond the reference's 10-qubit ceiling,
shards the exact-inference state table over every available device, and
repeatedly estimates ln Z / success rate / clique marginals from sharded
circuit samples, reporting throughput as JSON.

Run ``python -m qcmrf_tpu.runners.scaling --n 24`` (one GPU: use
``--devices 1``; several GPUs or the virtual CPU mesh shard automatically).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(prog="qcmrf_tpu scaling")
    parser.add_argument("--n", type=int, default=24,
                        help="target qubit count (grid rows*cols)")
    parser.add_argument("--devices", type=int, default=None)
    parser.add_argument("--shots", type=int, default=1 << 20)
    parser.add_argument("--estimations", type=int, default=5,
                        help="repeated-estimation iterations")
    parser.add_argument("--gate-level", action="store_true",
                        help="also run the sharded gate-level statevector "
                             "engine (targeted ppermute qubit exchanges) "
                             "on a QCMRF circuit of ~n qubits")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from qcmrf_tpu.utils.config import enable_compilation_cache
    enable_compilation_cache()

    from qcmrf_tpu.models.mrf import grid_mrf
    from qcmrf_tpu.parallel import sharded

    # exact factorization: rows x cols == n (a 1 x n grid is a chain),
    # so --n 25/26/27 really benchmark 25/26/27 qubits
    rows = next(r for r in range(int(np.sqrt(args.n)), 0, -1)
                if args.n % r == 0)
    cols = args.n // rows
    template = grid_mrf(rows, cols)
    rng = np.random.RandomState(0)
    mrf = template.with_theta(
        jnp.asarray(-np.abs(rng.randn(template.dimension)).astype(np.float32)
                    * 0.1)
    )
    mesh = sharded.make_mesh(args.devices)
    D = mesh.devices.size

    out = {"n": mrf.n, "cliques": template.num_cliques, "devices": D,
           "backend": jax.default_backend(),
           "states": mrf.num_states,
           "state_table_mb": round(mrf.num_states * 4 / 1e6, 1)}

    # sharded exact lnZ (one state-table pass, psum-logsumexp)
    t0 = time.perf_counter()
    lnZ = float(sharded.sharded_log_partition(mrf, mesh))
    out["lnZ"] = round(lnZ, 6)
    out["lnZ_first_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    for _ in range(3):
        lnZ2 = sharded.sharded_log_partition(mrf, mesh)
    jax.block_until_ready(lnZ2)
    out["lnZ_ms"] = round((time.perf_counter() - t0) / 3 * 1e3, 2)

    # repeated estimation loop: sample -> estimate delta & lnZ-hat.
    # The whole loop is ONE jitted dispatch (lax.scan over the fused
    # sampler): per-iteration host round-trips would otherwise dominate
    _ = jax.block_until_ready(sharded.sharded_estimate_delta(
        jax.random.PRNGKey(99), mrf, mesh, args.shots, args.estimations
    ))  # warm-up compile outside the timed region
    t0 = time.perf_counter()
    deltas = np.asarray(jax.block_until_ready(
        sharded.sharded_estimate_delta(
            jax.random.PRNGKey(0), mrf, mesh, args.shots, args.estimations
        )
    ))
    dt = (time.perf_counter() - t0) / args.estimations
    out["est_shots_per_sec"] = round(args.shots / dt)
    delta_hat = float(np.mean(deltas))
    out["delta_hat"] = delta_hat
    out["lnZ_hat"] = round(float(np.log(max(delta_hat, 1e-300))
                                 + mrf.n * np.log(2.0)), 6)
    out["lnZ_abs_err"] = round(abs(out["lnZ_hat"] - lnZ), 6)

    if args.gate_level:
        # sharded gate-level statevector: a chain QCMRF circuit of width
        # 2v == ~n qubits (v variables + v-1 ancillas + workspace); the
        # ancilla H/X sandwich gates land on device bits, driving the
        # targeted exchange collectives
        from qcmrf_tpu.circuits.compiler import compile_qcmrf
        from qcmrf_tpu.models.mrf import MRF

        v = max(args.n // 2, 2)
        gl_template = MRF.create([[i, i + 1] for i in range(v - 1)])
        gl = gl_template.with_theta(jnp.asarray(
            -np.abs(rng.randn(gl_template.dimension)).astype(np.float32)
            * 0.1
        ))
        circ = compile_qcmrf(gl, with_measurements=False)
        # first call includes shard_map trace + XLA compile; report it
        # separately and time a warm call for the steady-state number
        # (same first/steady split as the lnZ metric above)
        t0 = time.perf_counter()
        re, im = sharded.run_statevector_sharded(circ, mesh)
        norm = float(jax.block_until_ready(
            (re * re + im * im).sum()
        ))
        out["gate_level_first_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        re, im = sharded.run_statevector_sharded(circ, mesh)
        jax.block_until_ready((re, im))
        out["gate_level_qubits"] = circ.num_qubits
        out["gate_level_gates"] = len(circ.gates)
        out["gate_level_s"] = round(time.perf_counter() - t0, 3)
        out["gate_level_remaps"] = sharded.LAST_REMAP_COUNT
        out["gate_level_norm_err"] = abs(norm - 1.0)
        assert abs(norm - 1.0) < 1e-4, "sharded gate-level norm drifted"

    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>20}: {v}")
    return out


if __name__ == "__main__":
    main()
