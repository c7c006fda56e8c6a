"""Micro-benchmarks on the GPU: sampling throughput, plane-pass bandwidth,
exact inference.

``python -m qcmrf_tpu bench [--n 20] [--json]`` reports, on the GPU (it
exits with an error naming the missing GPU on a host without one):

* outcome-sampler throughput (shots/sec) — the headline metric;
* log-potential table time and effective write bandwidth (GB/s);
* gate-apply bandwidth for a low- and a high-qubit Hadamard (GB/s),
  beside a same-run copy pass moving the same bytes;
* exact partition-function latency;
* the 70-circuit reference suite through the vmapped dense engine.

Every number is a smoke reading of the card named in the output, not a
benchmark cell.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Callable, List, Optional

import numpy as np

from qcmrf_tpu.utils import profiling


def _time(fn: Callable, reps: int = 10) -> float:
    """Average seconds/call; varies the dummy arg so jit can't hoist the
    call out of the loop (why this isn't plain profiling.timed)."""
    import jax

    jax.block_until_ready(fn(0))
    t0 = time.perf_counter()
    for i in range(reps):
        out = fn(i)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# -- shared benchmark bodies (also used by the repo-root bench.py) ---------


#: passes per dispatch for the donated-chain timing method: long enough
#: that the per-dispatch overhead is a small fraction of device time at
#: n >= 24, short enough to keep the bench quick
_PASS_CHAIN = 32


def _donated_chain_pass_ms(make_call: Callable, n: int,
                           passes: int = _PASS_CHAIN,
                           reps: int = 3) -> float:
    """Per-pass milliseconds of ``make_call(re, im) -> (re, im)`` from a
    donated ``passes``-long chain: one jitted step applies the call
    ``passes`` times, with an optimization barrier after each so XLA
    can neither fuse nor simplify across passes, timed wall-clock around
    the dispatch (best of ``reps``)."""
    import jax
    import jax.numpy as jnp

    rows = (1 << n) // 128

    @jax.jit
    def init(s):
        re = jnp.zeros((rows, 128), jnp.float32).at[0, 0].set(
            1.0 + 0.0 * s)
        return re, jnp.zeros((rows, 128), jnp.float32)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(re, im):
        for _ in range(passes):
            re, im = jax.lax.optimization_barrier(make_call(re, im))
        return re, im

    re, im = init(0)
    re, im = jax.block_until_ready(step(re, im))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        re, im = jax.block_until_ready(step(re, im))
        best = min(best, time.perf_counter() - t0)
    return best / passes * 1e3


def _pass_ms_to_gbps(pass_ms: float, n: int,
                     traversals: int = 4) -> float:
    """Effective GB/s of a pass moving ``traversals`` f32 planes."""
    return traversals * (1 << n) * 4 / (pass_ms * 1e-3) / 1e9


def gate_apply_gbps(n: int) -> tuple:
    """(low_gbps, high_gbps): effective rates of chained Hadamards on
    qubit 3 and qubit n-2 of the n-qubit planes (donated-chain method).
    Use n >= 24 so per-pass device time dominates dispatch overhead."""
    from qcmrf_tpu.ops import kernels
    from qcmrf_tpu.sim import dense

    H = dense.GATES_1Q["h"]
    low = _pass_ms_to_gbps(_donated_chain_pass_ms(
        lambda r, i_: kernels.apply_1q(r, i_, H, 3, n), n), n)
    high = _pass_ms_to_gbps(_donated_chain_pass_ms(
        lambda r, i_: kernels.apply_1q(r, i_, H, n - 2, n), n), n)
    return low, high


def copy_gbps(n: int) -> float:
    """Same-run bandwidth reference: a pass moving the SAME bytes as a
    gate apply (both planes in and out, negated so it is not elided)."""
    return _pass_ms_to_gbps(
        _donated_chain_pass_ms(lambda r, i_: (-r, -i_), n), n)


def make_suite70(scale: float = 0.1) -> Callable:
    """Jitted one-dispatch gate-level execution of the whole 70-circuit
    reference suite (the vmapped dense engine, one batch per graph)."""
    import jax
    import jax.numpy as jnp

    from qcmrf_tpu.circuits.params import theta_to_gamma
    from qcmrf_tpu.models.suite import generate_suite
    from qcmrf_tpu.sim import batch as sbatch

    suite = generate_suite(scale)
    graphs = [tuple(tuple(int(v) for v in C) for C in G)
              for G in suite.graphs]
    gammas = [jnp.asarray(np.asarray(theta_to_gamma(
        np.asarray(suite.thetas[j], np.float64))), jnp.float32)
        for j in range(len(graphs))]

    @jax.jit
    def suite_fused(s):
        return [sbatch._batched_circuit_probs(C, g + 0.0 * s)
                for C, g in zip(graphs, gammas)]

    return suite_fused


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(prog="qcmrf_tpu bench")
    parser.add_argument("--n", type=int, default=20,
                        help="grid qubits (rows*cols closest to n)")
    parser.add_argument("--shots", type=int, default=1 << 27)
    parser.add_argument("--trace", type=str, default=None,
                        help="emit a jax.profiler trace of the sampler "
                             "benchmark into this directory")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    from qcmrf_tpu.utils.device import require_gpu

    devs = require_gpu("qcmrf_tpu bench")

    import jax
    import jax.numpy as jnp

    from qcmrf_tpu.utils.config import enable_compilation_cache
    enable_compilation_cache()

    from qcmrf_tpu.models.mrf import grid_mrf
    from qcmrf_tpu.ops import kernels
    from qcmrf_tpu.sim import analytic

    rows = max(2, int(np.sqrt(args.n)))
    cols = max(2, args.n // rows)
    template = grid_mrf(rows, cols)
    n = template.n
    rng = np.random.RandomState(0)
    mrf = template.with_theta(
        jnp.asarray(-np.abs(rng.randn(template.dimension)).astype(np.float32)
                    * 0.3)
    )
    out = {"n": n, "cliques": template.num_cliques,
           "platform": devs[0].platform, "device_kind": devs[0].device_kind,
           "device_count": len(devs)}

    fn = jax.jit(lambda s: analytic.sample_outcome_parts(
        jax.random.PRNGKey(s), mrf, args.shots))
    dt = _time(fn)
    out["sampler_shots_per_sec"] = round(args.shots / dt)
    if args.trace:
        with profiling.trace(args.trace):
            jax.block_until_ready(fn(1))
        out["trace_dir"] = args.trace

    # log-potential table: writes 2^n float32
    lp_fn = jax.jit(lambda s: kernels.all_log_potentials(mrf).sum() + s)
    dt = _time(lp_fn)
    out["logpot_ms"] = round(dt * 1e3, 3)
    out["logpot_write_gbps"] = round((1 << n) * 4 / dt / 1e9, 2)

    lnz_fn = jax.jit(lambda s: kernels.log_partition(mrf) + 0 * s)
    out["lnZ_ms"] = round(_time(lnz_fn) * 1e3, 3)

    bw_n = max(n, 24)
    low, high = gate_apply_gbps(bw_n)
    out["gate_bw_n"] = bw_n
    out["gate_low_qubit_gbps"] = round(low, 2)
    out["gate_high_qubit_gbps"] = round(high, 2)
    out["copy_gbps"] = round(copy_gbps(bw_n), 2)

    out["suite70_gate_level_ms"] = round(_time(make_suite70(0.1)) * 1e3, 2)

    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>24}: {v}")
    return out


if __name__ == "__main__":
    main()
