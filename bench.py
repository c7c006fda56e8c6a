"""Benchmark: QCMRF sampling throughput at n=20 on one GPU, plus the
gate-level, exact-inference and training timings.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": R, ...}

with the platform, device kind and device count it ran on. It measures
the card only: on a host without a GPU it exits non-zero naming the
missing GPU, and prints no result.

Task (BASELINE.json north-star config): sample full measurement outcomes of
the QCMRF circuit for an n=20 (4x5) grid MRF — 52 qubits worth of circuit
(20 variables + 31 edge-clique ancillas + workspace), far beyond any dense
statevector simulator (Aer would need 2^52 amplitudes), executed here via
the factorized outcome law P(x, a) = 2^-n * prod_k Bernoulli terms
(qcmrf_tpu.sim.analytic, exactness proven in tests against the gate-level
engine).

``vs_baseline`` is the speedup over the best *CPU numpy* implementation of
the same sampler (the honest classical stand-in for the reference's
C++ Aer backend, which cannot run this workload at all — see BASELINE.md).
"""

import json
import time

import numpy as np


def numpy_baseline(theta_tab, offsets, shifts_a, shifts_b, n, shots, reps):
    """Vectorized numpy version of the factorized sampler (pairwise grid).

    Takes the BEST (fastest) of ``reps`` runs so the reported speedup is
    conservative against host timing jitter."""
    rng = np.random.RandomState(0)
    K = len(offsets)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        x = rng.randint(0, 1 << n, size=shots).astype(np.int64)
        ba = (x[:, None] >> shifts_a) & 1
        bb = (x[:, None] >> shifts_b) & 1
        yidx = (ba << 1) | bb
        c2 = np.exp(theta_tab[np.arange(K)[None, :], yidx])
        u = rng.random_sample((shots, K))
        abits = (u >= c2).astype(np.int64)
        keys = x + ((abits << np.arange(K, dtype=np.int64)).sum(1) << (n + 1))
        best = min(best, time.perf_counter() - t0)
    return shots / best, keys


def _chain(nn: int):
    """The n=nn QCMRF chain model (width 2*nn gate-level circuit)."""
    from qcmrf_tpu.models.mrf import MRF

    return MRF.create(
        [[i, i + 1] for i in range(nn - 1)],
        theta=-np.abs(np.random.RandomState(0).randn(4 * (nn - 1))) * 0.3,
    )


def main():
    from qcmrf_tpu.utils.device import require_gpu

    devs = require_gpu("bench.py")

    import jax
    import jax.numpy as jnp

    from qcmrf_tpu.utils.config import enable_compilation_cache
    enable_compilation_cache()

    from qcmrf_tpu.circuits.compiler import compile_qcmrf
    from qcmrf_tpu.models.mrf import MRF, grid_mrf
    from qcmrf_tpu.ops import kernels
    from qcmrf_tpu.runners.bench import (_donated_chain_pass_ms, copy_gbps,
                                         gate_apply_gbps, make_suite70)
    from qcmrf_tpu.sim import analytic
    from qcmrf_tpu.sim import tpu as stpu

    def best_of(f, reps=10, trials=3):
        """Best-of-trials average seconds per call (dummy arg varied)."""
        best = float("inf")
        out = None
        for _ in range(trials):
            t0 = time.perf_counter()
            for i in range(reps):
                out = f(i)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / reps)
        return best, out

    def _t(fn, reps=10):
        jax.block_until_ready(fn(0))  # compile (set-up, not timed)
        return best_of(fn, reps=reps)[0]

    # 2^27 shots per call, as callers estimating delta batch them
    # (sharded_estimate_delta); per-call dispatch is then negligible
    SHOTS = 1 << 27
    template = grid_mrf(4, 5)
    n, K = template.n, template.num_cliques
    rng = np.random.RandomState(0)
    theta = -np.abs(rng.randn(template.dimension)).astype(np.float32) * 0.3
    mrf = template.with_theta(jnp.asarray(theta))

    # --- headline: the XLA outcome sampler ------------------------------
    fn = jax.jit(lambda s: analytic.sample_outcome_parts(
        jax.random.PRNGKey(s), mrf, SHOTS))
    jax.block_until_ready(fn(0))  # compile
    dt, out = best_of(fn, reps=8, trials=5)
    rate = SHOTS / dt

    # write cost of the same draw: accept flags written out (1 B/shot)
    # vs only their count (a sum fused into the sampler)
    fc = jax.jit(lambda s: jnp.sum(analytic.sample_postselected(
        jax.random.PRNGKey(s), mrf, SHOTS)[1]))
    ff = jax.jit(lambda s: analytic.sample_postselected(
        jax.random.PRNGKey(s), mrf, SHOTS)[1])
    dt_c = _t(fc, reps=8)
    dt_f = _t(ff, reps=8)
    no_output_rate = SHOTS / dt_c
    flags_rate = SHOTS / dt_f

    # --- CPU numpy baseline --------------------------------------------
    offsets = np.asarray(template.theta_offsets)
    theta_tab = np.stack(
        [theta[o: o + 4] for o in offsets]
    )  # (K, 4) pairwise tables
    sa = np.array([n - 1 - C[0] for C in template.cliques], dtype=np.int64)
    sb = np.array([n - 1 - C[1] for C in template.cliques], dtype=np.int64)
    cpu_rate, _ = numpy_baseline(
        theta_tab, offsets, sa, sb, n, shots=1 << 17, reps=7
    )

    # sanity: acceptance rate matches Z/2^n (reduced on device)
    acc = float(jnp.mean((out[1] == 0).astype(jnp.float32)))
    expected = float(mrf.success_rate())
    assert abs(acc - expected) < max(0.2 * expected, 1e-4), (acc, expected)
    del out, fn, fc, ff

    extra = {}
    # --- same-run reference rates: a plane copy and a bf16 matmul ------
    bw_n = 24
    extra["gate_bw_n"] = bw_n
    low, high = gate_apply_gbps(bw_n)
    extra["gate_low_qubit_gbps"] = round(low, 1)
    extra["gate_high_qubit_gbps"] = round(high, 1)
    cp = copy_gbps(bw_n)
    extra["copy_gbps"] = round(cp, 1)
    extra["gate_low_copy_ratio"] = round(low / cp, 3)
    extra["gate_high_copy_ratio"] = round(high / cp, 3)
    A_mm = jnp.ones((8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda s: jnp.max(A_mm @ A_mm) + 0.0 * s)
    extra["bf16_matmul_tflops"] = round(
        2 * 8192**3 / _t(mm, reps=4) / 1e12, 1)

    # --- gate-level QCMRF chain circuits, widths 20..30 -----------------
    for nn in (10, 12, 13, 14, 15):
        w = 2 * nn
        circ_w = compile_qcmrf(_chain(nn), with_measurements=False)
        ops_w = stpu.fuse_ops(circ_w)

        @jax.jit
        def run_w(s, ops_w=ops_w, w=w):
            rows = (1 << w) // 128
            re_w = jnp.zeros((rows, 128), jnp.float32).at[0, 0].set(
                1.0 + 0.0 * s)
            im_w = jnp.zeros((rows, 128), jnp.float32)
            return stpu._apply_ops(re_w, im_w, ops_w, w)

        extra[f"qcmrf{w}_gate_level_ms"] = round(_t(run_w, reps=5) * 1e3, 3)
        extra[f"qcmrf{w}_fused_passes"] = len(ops_w)
        extra[f"qcmrf{w}_gates"] = len(circ_w.gates)

    # per-op-class time of the w=28 circuit, each class as its own chain
    ops28 = stpu.fuse_ops(compile_qcmrf(_chain(14), with_measurements=False))
    by_class = {}
    for op in ops28:
        by_class.setdefault(op[0], []).append(op)
    extra["qcmrf28_class_ms"] = {
        f"{kind}_x{len(klops)}": round(_donated_chain_pass_ms(
            lambda r, i_, klops=klops: stpu._apply_ops(r, i_, klops, 28),
            28, passes=8, reps=3), 3)
        for kind, klops in sorted(by_class.items())}

    # the sharded engine on a one-device mesh (the sharding layer's cost)
    from qcmrf_tpu.parallel import sharded

    mesh1 = sharded.make_mesh(1)
    for nn in (12, 14):
        circ_s = compile_qcmrf(_chain(nn), with_measurements=False)
        extra[f"qcmrf{2 * nn}_sharded_gate_level_ms"] = round(_t(
            lambda s, c=circ_s: sharded.run_statevector_sharded(c, mesh1),
            reps=5) * 1e3, 3)

    # --- the 70-circuit reference suite and its KL ---------------------
    extra["suite70_gate_level_ms"] = round(
        _t(make_suite70(0.1), reps=5) * 1e3, 2)
    from qcmrf_tpu.evaluation import metrics as emetrics
    from qcmrf_tpu.models.suite import generate_suite

    suite = generate_suite(0.1)

    def suite_max_kl(shots):
        kls = []
        for j, C in enumerate(suite.graphs):
            m = MRF.create(C, theta=suite.thetas[j][0])
            xs, accepted = analytic.sample_postselected(
                jax.random.fold_in(jax.random.PRNGKey(5), j), m, shots)
            xs, accepted = np.asarray(xs), np.asarray(accepted)
            q = np.bincount(xs[accepted], minlength=m.num_states
                            ).astype(np.float64)
            q /= max(q.sum(), 1.0)
            kls.append(float(emetrics.kl(
                np.asarray(m.gibbs_probs(), np.float64), q)))
        return round(max(kls), 6)

    extra["kl_suite_max_10k_shots"] = suite_max_kl(10_240)
    extra["kl_suite_max_1m_shots"] = suite_max_kl(1 << 20)

    # --- n=28 repeated estimation, one dispatch for all rounds ---------
    g28 = grid_mrf(4, 7)
    m28 = g28.with_theta(jnp.asarray(
        -np.abs(np.random.RandomState(0).randn(g28.dimension))
        .astype(np.float32) * 0.1))
    est_shots, est_iters = 1 << 26, 5
    dt28 = _t(lambda s: sharded.sharded_estimate_delta(
        jax.random.PRNGKey(s), m28, mesh1, est_shots, est_iters),
        reps=3) / est_iters
    extra["est_n28_shots_per_sec"] = round(est_shots / dt28)

    # --- exact lnZ: grids n=24/28/30 and the n=34 chain ----------------
    models = [grid_mrf(4, 6), grid_mrf(4, 7), grid_mrf(5, 6),
              MRF.create([[i, i + 1] for i in range(33)])]
    for g in models:
        gm = g.with_theta(jnp.asarray(
            -np.abs(np.random.RandomState(1).randn(g.dimension))
            .astype(np.float32) * 0.1))
        extra[f"lnZ_n{g.n}_ms"] = round(_t(
            jax.jit(lambda s, m=gm: kernels.log_partition(m) + 0 * s),
            reps=5) * 1e3, 3)

    # --- exact-MLE training step past elimination's cap (K27) ----------
    import optax

    from qcmrf_tpu.models import moments as mmo
    from qcmrf_tpu.models import train as mtrain

    nW = 27
    kW = MRF.create([[i, j] for i in range(nW) for j in range(i + 1, nW)])
    rsW = np.random.RandomState(11)
    kW = kW.with_theta(jnp.asarray(
        -np.abs(rsW.randn(kW.dimension)).astype(np.float32) * 0.02))
    muW = jnp.asarray(rsW.uniform(0.1, 0.5, kW.dimension), jnp.float32)
    optW = optax.adam(5e-2)
    rawW = mtrain._from_theta(kW.theta, True)
    stepW = mtrain.make_moment_train_step(kW, optW, muW)
    stW = optW.init(rawW)
    extra["train_wide_k27_step_ms"] = round(_t(
        lambda s: stepW(rawW + 0.0 * s, stW)[2], reps=3) * 1e3, 1)

    # --- the moment sweep alone (K24 complete graph) -------------------
    kM = MRF.create([[i, j] for i in range(24) for j in range(i + 1, 24)])
    kM = kM.with_theta(jnp.asarray(
        -np.abs(np.random.RandomState(11).randn(kM.dimension))
        .astype(np.float32) * 0.02))
    lnZ_k = kernels.log_partition(kM)
    extra["moments_k24_ms"] = round(_t(jax.jit(
        lambda s: mmo.clique_moments_streaming(kM, lnZ_k + 0.0 * s)),
        reps=5) * 1e3, 2)

    # --- perturb-and-MAP at n=24 and exact sampling at n=40 ------------
    from qcmrf_tpu.models import elimination as velim
    from qcmrf_tpu.models import sample as msample
    from qcmrf_tpu.models.mrf import chain_mrf

    cl_p = ([[i, i + 1] for i in range(23)]
            + [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(6)])
    mp = MRF.create(cl_p, theta=-np.abs(np.random.RandomState(7).randn(
        MRF.create(cl_p).dimension)).astype(np.float32) * 0.5)
    msample.sample_pam_streaming(jax.random.PRNGKey(0), mp, 16)
    best_p = float("inf")
    for t_i in range(3):
        t0 = time.perf_counter()
        msample.sample_pam_streaming(jax.random.PRNGKey(t_i), mp, 16)
        best_p = min(best_p, time.perf_counter() - t0)
    extra["pam_n24_ms_per_sample"] = round(best_p * 1e3 / 16, 2)

    ce = chain_mrf(40, theta=-np.abs(
        np.random.RandomState(9).randn(4 * 39)).astype(np.float32))
    n_draw = 65536
    velim.sample_exact_elim(jax.random.PRNGKey(0), ce, n_draw
                            ).block_until_ready()
    best_e = float("inf")
    for t_i in range(3):
        t0 = time.perf_counter()
        velim.sample_exact_elim(jax.random.PRNGKey(t_i + 1), ce,
                                n_draw).block_until_ready()
        best_e = min(best_e, time.perf_counter() - t0)
    extra["exact_sample_n40_per_sec"] = round(n_draw / best_e)

    print(json.dumps({
        "metric": "qcmrf outcome sampling, n=20 grid (20 vars + 31 ancillas)",
        "value": round(rate),
        "unit": "shots/sec",
        "vs_baseline": round(rate / cpu_rate, 1),
        "sampler_no_output_shots_per_sec": round(no_output_rate),
        "sampler_flags_shots_per_sec": round(flags_rate),
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        **extra,
    }))


if __name__ == "__main__":
    main()
