"""Smoke test of the main paths on the GPU, each against the repo's plain
reference.

    python chip_smoke.py               # one card: the five phases below
    python chip_smoke.py --four-cards  # only the sharded paths, 4-GPU mesh

Phases on one card (sizes are users' sizes; weights come from seeds):

1. the paper's experiment end to end through the CLIs: ``run`` with the
   analytic, statevector and calibrated:torino engines at scale 0.1 and
   10 000 shots, then ``eval --kl`` on each result file;
2. the outcome sampler on the n=20 grid at 2^27 shots per call, and the
   sharded delta estimator on a one-card mesh at n=28;
3. the gate-level plane engine on QCMRF chain circuits of width 24, 28
   and 30;
4. streaming exact inference: lnZ on an n=28 grid and an n=34 chain, MAP
   on the n=28 grid;
5. streaming moments on K24, (lnZ, moments) and three exact-MLE steps on
   K27, and the ``train`` CLI on an 8x8 grid.

It prints the card's name and power limit first, one line per check
(size, result against the reference with its tolerance and reason,
first-call seconds including compilation, and the process's
``peak_bytes_in_use``), and as its last line one JSON object with the
device as JAX reports it. It exits non-zero, and prints no result, when
JAX finds no GPU, when the package is not next to this script, or when
any check fails. Everything runs in this one process: a second JAX
process could not get the card's memory.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

#: sizes of the real run, and of the CPU rehearsal the tests make
FULL = dict(
    platform="gpu", paper_shots=10_000,
    grid=(4, 5), shots=1 << 27,
    est_grid=(4, 7), est_shots=1 << 26, est_iters=4,
    gate_dense=(24, 28), gate_law=(30,),
    lnz_grid=(4, 7), lnz_chain=34,
    moments_k=24, train_k=27, train_graph="grid:8x8",
    four_chain=34, four_grid=(4, 7), four_width=30, four_shots=1 << 26,
)
TINY = dict(
    platform="cpu", paper_shots=10_000,
    grid=(3, 4), shots=1 << 18,
    est_grid=(3, 4), est_shots=1 << 16, est_iters=2,
    gate_dense=(14,), gate_law=(16,),
    lnz_grid=(3, 4), lnz_chain=14,
    moments_k=8, train_k=10, train_graph="grid:3x3",
    four_chain=14, four_grid=(3, 4), four_width=24, four_shots=1 << 16,
)

#: stored ibm_torino columns at scale 0.1 (BASELINE.md: per-graph mean
#: fidelity, mean success rate, mean KL) that the calibrated engine's
#: stored calibration was fitted to reproduce
TORINO_01 = (
    (0.995, 0.989, 0.0098), (0.993, 0.760, 0.0147), (0.989, 0.290, 0.0223),
    (0.968, 0.198, 0.0668), (0.996, 0.634, 0.0078), (0.945, 0.294, 0.1194),
    (0.986, 0.525, 0.0270),
)


def card_line() -> str:
    """The card's name and power limit, read by a child process that
    stays off JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return r.stdout.strip() or f"nvidia-smi: {r.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not available ({type(e).__name__})"


class Smoke:
    """Runs phases, prints one line per check, remembers failures."""

    def __init__(self, cfg: dict, out: str):
        self.cfg = cfg
        self.out = out
        self.failed = []
        self._t0 = time.perf_counter()

    def start(self):
        self._t0 = time.perf_counter()

    def check(self, name: str, size: str, result: str, ok: bool,
              tol: str, reason: str):
        import jax

        secs = time.perf_counter() - self._t0
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", "not measured")
        print(f"[{'ok' if ok else 'FAIL'}] {name} | {size} | {result} | "
              f"tol {tol} ({reason}) | first call {secs:.1f} s | "
              f"peak_bytes_in_use {peak}", flush=True)
        if not ok:
            self.failed.append(name)
        self.start()

    def run(self, name: str, fn):
        self.start()
        try:
            fn(self)
        except Exception:  # recorded: the run still exits non-zero
            traceback.print_exc()
            print(f"[FAIL] {name} | raised, see the traceback on stderr",
                  flush=True)
            self.failed.append(name)


def _mrf(cliques, seed: int, scale: float):
    import jax.numpy as jnp
    import numpy as np

    from qcmrf_tpu.models.mrf import MRF

    dim = MRF.create(cliques).dimension
    theta = -np.abs(np.random.RandomState(seed).randn(dim)) * scale
    return MRF.create(cliques, theta=jnp.asarray(theta, jnp.float32))


def _grid(rows: int, cols: int, seed: int, scale: float):
    from qcmrf_tpu.models.mrf import grid_mrf

    return _mrf([list(C) for C in grid_mrf(rows, cols).cliques], seed, scale)


def _chain_circuit(w: int):
    """The width-w QCMRF chain circuit (n = w/2 variables, w/2 - 1
    cliques, one workspace qubit), as the benchmark builds it."""
    import numpy as np

    from qcmrf_tpu.circuits.compiler import compile_qcmrf
    from qcmrf_tpu.models.mrf import MRF

    nn = w // 2
    chain = MRF.create(
        [[i, i + 1] for i in range(nn - 1)],
        theta=-np.abs(np.random.RandomState(0).randn(4 * (nn - 1))) * 0.3)
    return chain, compile_qcmrf(chain, with_measurements=False)


def _five_sigma(est: float, exact: float, count: int) -> float:
    sigma = (max(exact * (1.0 - exact), 1e-12) / max(count, 1)) ** 0.5
    return abs(est - exact) / sigma


# --------------------------------------------------------------------------
# phase 1: the paper's experiment through the CLIs
# --------------------------------------------------------------------------


def phase_paper(s: Smoke):
    import numpy as np

    from qcmrf_tpu.evaluation.harness import evaluate_suite, load_result_dists
    from qcmrf_tpu.models.mrf import MRF
    from qcmrf_tpu.models.suite import load_suite
    from qcmrf_tpu.runners import eval as eval_cli
    from qcmrf_tpu.runners import run_experiment

    cfg = s.cfg
    root = os.path.join(s.out, "paper")
    res = os.path.join(root, "res_0.1")
    shots = cfg["paper_shots"]
    for engine in ("analytic", "statevector", "calibrated:torino"):
        path = run_experiment.main([
            "--scale", "0.1", "--shots", str(shots), "--engine", engine,
            "--platform", cfg["platform"], "--outdir", res])
        eval_cli.main(["--results", os.path.basename(path), "--scale",
                       "0.1", "--res-root", root, "--kl",
                       "--platform", cfg["platform"]])
        suite = load_suite(os.path.join(res, "models_0.1.json"), 0.1)
        dists, norm = load_result_dists(path)
        results = evaluate_suite(suite, dists=dists, norm=norm)
        size = f"scale 0.1, 70 circuits x {shots} shots"
        if engine.startswith("calibrated"):
            worst = [0.0, 0.0, 0.0]
            ok = True
            for r, (f_t, d_t, kl_t) in zip(results, TORINO_01):
                e = (abs(r.mean_f - f_t), abs(r.mean_delta - d_t),
                     abs(r.mean_kl - kl_t))
                worst = [max(a, b) for a, b in zip(worst, e)]
                ok &= (e[0] <= 0.012 and e[1] <= 0.03
                       and e[2] <= max(0.35 * kl_t, 0.012))
            s.check(f"paper {engine}", size,
                    f"max |dF| {worst[0]:.4f}, |d delta| {worst[1]:.4f}, "
                    f"|dKL| {worst[2]:.4f} vs the stored torino columns",
                    ok, "|dF|<=0.012, |d delta|<=0.03, "
                    "|dKL|<=max(35%,0.012)",
                    "the stored calibration's own fit tolerances")
            continue
        f_min = min(r.mean_f for r in results)
        z = []
        idx = 0
        for j, C in enumerate(suite.graphs):
            for i, theta in enumerate(suite.thetas[j]):
                exact = float(MRF.create(C, theta=theta).success_rate())
                z.append(_five_sigma(results[j].successes[i], exact, shots))
                idx += 1
        zmax = float(np.max(z))
        s.check(f"paper {engine}", size,
                f"min graph F {f_min:.5f}, max |delta-hat - Z/2^n| "
                f"{zmax:.2f} sigma", f_min >= 0.9985 and zmax <= 5.0,
                "F>=0.999 (3 decimals), 5 sigma",
                "BASELINE.md simulation table; binomial shot noise")


# --------------------------------------------------------------------------
# phase 2: the outcome sampler and the sharded estimator
# --------------------------------------------------------------------------


def phase_sampler(s: Smoke):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.parallel import sharded
    from qcmrf_tpu.sim import analytic

    cfg = s.cfg
    mrf = _grid(*cfg["grid"], seed=0, scale=0.3)
    n, shots = mrf.n, cfg["shots"]
    cl = np.asarray(mrf.cliques)  # pairwise grid edges

    @jax.jit
    def count(x, a, m):  # accepted shots whose bits under mask m are all 1
        return jnp.sum(((a == 0) & ((x & m) == m)).astype(jnp.int32))

    x, a = analytic.sample_outcome_parts(jax.random.PRNGKey(0), mrf, shots)
    bit = [1 << (n - 1 - v) for v in range(n)]
    n_acc = float(count(x, a, 0))
    single = np.asarray([float(count(x, a, b)) for b in bit])
    pair = np.asarray([float(count(x, a, bit[u] | bit[v])) for u, v in cl])
    del x, a
    delta = float(np.exp(float(ve.log_partition(mrf)) - n * np.log(2.0)))
    z_acc = _five_sigma(n_acc / shots, delta, shots)
    exact = np.asarray(ve.clique_marginals(mrf), np.float64).reshape(-1, 4)
    p11 = pair / n_acc
    p10 = single[cl[:, 0]] / n_acc - p11
    p01 = single[cl[:, 1]] / n_acc - p11
    est = np.stack([1.0 - p11 - p10 - p01, p01, p10, p11], axis=1)
    sig = np.sqrt(np.maximum(exact * (1 - exact), 1e-12) / n_acc)
    z_marg = float(np.max(np.abs(est - exact) / sig))
    s.check("sampler sample_outcome_parts",
            f"n={n} grid, {shots} shots/call, {int(n_acc)} accepted",
            f"acceptance {z_acc:.2f} sigma from Z/2^n; clique marginals "
            f"max {z_marg:.2f} sigma from elimination",
            z_acc <= 5.0 and z_marg <= 5.0, "5 sigma",
            "binomial sampling noise")

    m28 = _grid(*cfg["est_grid"], seed=0, scale=0.1)
    delta28 = float(np.exp(float(ve.log_partition(m28))
                           - m28.n * np.log(2.0)))
    rates = np.asarray(sharded.sharded_estimate_delta(
        jax.random.PRNGKey(1), m28, sharded.make_mesh(1),
        cfg["est_shots"], cfg["est_iters"]), np.float64)
    z = max(_five_sigma(r, delta28, cfg["est_shots"]) for r in rates)
    s.check("sampler sharded_estimate_delta",
            f"n={m28.n} grid, mesh of 1, {cfg['est_iters']} rounds x "
            f"{cfg['est_shots']} shots",
            f"max round {z:.2f} sigma from exact delta {delta28:.6g}",
            z <= 5.0, "5 sigma", "binomial sampling noise")


# --------------------------------------------------------------------------
# phase 3: the gate-level plane engine
# --------------------------------------------------------------------------


def phase_gates(s: Smoke):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qcmrf_tpu.sim import analytic, dense
    from qcmrf_tpu.sim import tpu as stpu

    cfg = s.cfg
    for w in tuple(cfg["gate_dense"]) + tuple(cfg["gate_law"]):
        chain, circ = _chain_circuit(w)
        t0 = time.perf_counter()
        p = jax.block_until_ready(stpu.simulate_probs(circ))
        t_engine = time.perf_counter() - t0
        if w in cfg["gate_dense"]:
            with jax.default_matmul_precision("highest"):
                ref = dense.simulate_probs(circ)
            what = "dense complex64 engine"
        else:
            ref = analytic.joint_outcome_probs(chain)
            what = "closed-form law"
        tvd = float(0.5 * jnp.sum(jnp.abs(p - ref)))
        got = float(jnp.sum(p[: 1 << chain.n]))
        exact = float(chain.success_rate())
        rel = abs(got - exact) / exact
        del p, ref
        s.check(f"gates simulate_probs w={w}",
                f"{1 << w} amplitudes, {len(stpu.fuse_ops(circ))} fused ops",
                f"TVD {tvd:.3g} vs the {what}; delta rel err {rel:.3g}; "
                f"engine first call {t_engine:.1f} s",
                tvd <= 1e-4 and rel <= 1e-4, "1e-4",
                "float32 planes: ~1e-6 relative rounding per pass")


# --------------------------------------------------------------------------
# phase 4: streaming lnZ and MAP
# --------------------------------------------------------------------------


def phase_inference(s: Smoke):
    import numpy as np

    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.ops import kernels

    cfg = s.cfg
    grid = _grid(*cfg["lnz_grid"], seed=1, scale=0.1)
    nc = cfg["lnz_chain"]
    chain = _mrf([[i, i + 1] for i in range(nc - 1)], seed=1, scale=0.1)
    for name, m in (("grid", grid), ("chain", chain)):
        got = float(kernels.log_partition(m))
        want = float(ve.log_partition(m))
        rel = abs(got - want) / abs(want)
        s.check(f"inference log_partition {name}", f"n={m.n}",
                f"lnZ {got:.7f} vs elimination {want:.7f}, rel {rel:.3g}",
                rel <= 1e-5, "1e-5", "float32 sums over 2^n states")

    mg = _grid(*cfg["lnz_grid"], seed=2, scale=0.3)
    sid, val = kernels.map_state_streaming(mg)
    bits = np.asarray(ve.map_state_bits(mg))
    want_id = int(sum(int(b) << (mg.n - 1 - v) for v, b in enumerate(bits)))
    want_val = float(mg.beta * mg.log_potential(np.int32(want_id)))
    ok = sid == want_id or abs(val - want_val) <= 1e-5 * max(1.0,
                                                             abs(want_val))
    s.check("inference map_state_streaming", f"n={mg.n} grid",
            f"id {sid} vs elimination {want_id}, logpot {val:.6f} vs "
            f"{want_val:.6f}", ok, "same id, or 1e-5 on a tie",
            "a tie may pick either maximiser")


# --------------------------------------------------------------------------
# phase 5: moments and training
# --------------------------------------------------------------------------


def _dense_pairwise(m):
    """(lnZ, theta-layout moments) of a pairwise MRF from the dense 2^n
    table: gather-based log-potentials in chunks, then the bit Gram
    matrix of the Gibbs weights at HIGHEST precision."""
    import jax
    import jax.numpy as jnp

    n = m.n
    chunk = 1 << min(n, 16)
    starts = jnp.arange((1 << n) // chunk, dtype=jnp.int32) * chunk
    table = jax.lax.map(
        lambda s0: m.beta * m.log_potential(
            s0 + jnp.arange(chunk, dtype=jnp.int32)), starts)
    lnz = jax.scipy.special.logsumexp(table)

    def gram(G, args):
        s0, lp = args
        x = s0 + jnp.arange(chunk, dtype=jnp.int32)
        B = ((x[:, None] >> (n - 1 - jnp.arange(n))) & 1).astype(
            jnp.float32)
        w = jnp.exp(lp - lnz)
        return G + jnp.matmul(B.T, B * w[:, None],
                              precision=jax.lax.Precision.HIGHEST), None

    G = jax.lax.scan(gram, jnp.zeros((n, n), jnp.float32),
                     (starts, table))[0]
    u = jnp.asarray([C[0] for C in m.cliques])
    v = jnp.asarray([C[1] for C in m.cliques])
    p11, pu, pv = G[u, v], G[u, u], G[v, v]
    mom = jnp.stack([1.0 - pu - pv + p11, pv - p11, pu - p11, p11], 1)
    return lnz, mom.reshape(-1)


def phase_training(s: Smoke):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from qcmrf_tpu.models import moments as mmo
    from qcmrf_tpu.models import train as mtrain
    from qcmrf_tpu.ops import kernels
    from qcmrf_tpu.runners import train_cli

    cfg = s.cfg

    def complete(k, seed):
        return _mrf([[i, j] for i in range(k) for j in range(i + 1, k)],
                    seed=seed, scale=0.02)

    kM = complete(cfg["moments_k"], 11)
    got = mmo.clique_moments_streaming(kM, kernels.log_partition(kM))
    jax.block_until_ready(got)
    _, want = _dense_pairwise(kM)
    err = float(jnp.max(jnp.abs(got - want)))
    s.check("training clique_moments_streaming",
            f"K{kM.n} complete graph, {kM.num_cliques} cliques",
            f"max |moment - dense table| {err:.3g}", err <= 2e-5, "2e-5",
            "float32 sums over 2^n states at HIGHEST precision")

    kW = complete(cfg["train_k"], 11)
    lnz, mu = mmo.lnz_and_moments_streaming(kW)
    jax.block_until_ready(mu)
    lnz_ref, mu_ref = _dense_pairwise(kW)
    rel = abs(float(lnz) - float(lnz_ref)) / abs(float(lnz_ref))
    err = float(jnp.max(jnp.abs(mu - mu_ref)))
    s.check("training lnz_and_moments_streaming",
            f"K{kW.n} complete graph, past the elimination cap",
            f"lnZ rel {rel:.3g}, max |moment - dense table| {err:.3g}",
            rel <= 1e-5 and err <= 2e-5, "1e-5 / 2e-5",
            "float32 sums over 2^n states at HIGHEST precision")

    rs = np.random.RandomState(11)
    mu_hat = jnp.asarray(rs.uniform(0.1, 0.5, kW.dimension), jnp.float32)
    opt = optax.adam(5e-2)
    raw = mtrain._from_theta(kW.theta, True)
    step = mtrain.make_moment_train_step(kW, opt, mu_hat)
    st = opt.init(raw)
    losses = []
    for _ in range(3):
        raw, st, loss = step(raw, st)
        losses.append(float(loss))
    ok = bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0]
    s.check("training make_moment_train_step", f"K{kW.n}, 3 adam steps",
            "losses " + ", ".join(f"{v:.5f}" for v in losses), ok,
            "finite and falling", "exact-MLE gradient descent")

    path = train_cli.main(["--graph", cfg["train_graph"], "--steps", "3",
                           "--platform", cfg["platform"], "--outdir",
                           os.path.join(s.out, "train")])
    with open(path) as f:
        nll = json.load(f)["final_nll"]
    s.check("training train CLI", f"--graph {cfg['train_graph']} "
            "--steps 3", f"final NLL {nll:.5f}", bool(np.isfinite(nll)),
            "finite", "the CLI's own exact NLL")


PHASES = (("paper", phase_paper), ("sampler", phase_sampler),
          ("gates", phase_gates), ("inference", phase_inference),
          ("training", phase_training))


# --------------------------------------------------------------------------
# four cards: the sharded paths only
# --------------------------------------------------------------------------


def phase_four_cards(s: Smoke):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.parallel import sharded
    from qcmrf_tpu.sim import analytic

    cfg = s.cfg
    mesh = sharded.make_mesh(4)
    nc = cfg["four_chain"]
    chain = _mrf([[i, i + 1] for i in range(nc - 1)], seed=1, scale=0.1)
    got = float(sharded.sharded_log_partition(chain, mesh))
    want = float(ve.log_partition(chain))
    rel = abs(got - want) / abs(want)
    s.check("four cards sharded_log_partition", f"n={nc} chain, 4 devices",
            f"lnZ {got:.7f} vs elimination {want:.7f}, rel {rel:.3g}",
            rel <= 1e-5, "1e-5", "float32 sums over 2^n states")

    mg = _grid(*cfg["four_grid"], seed=2, scale=0.3)
    sid, val = sharded.sharded_map_state(mg, mesh)
    bits = np.asarray(ve.map_state_bits(mg))
    want_id = int(sum(int(b) << (mg.n - 1 - v) for v, b in enumerate(bits)))
    want_val = float(mg.beta * mg.log_potential(np.int32(want_id)))
    s.check("four cards sharded_map_state", f"n={mg.n} grid, 4 devices",
            f"id {sid} vs elimination {want_id}", sid == want_id or abs(
                val - want_val) <= 1e-5 * max(1.0, abs(want_val)),
            "same id, or 1e-5 on a tie", "a tie may pick either maximiser")

    w = cfg["four_width"]
    chain_w, circ = _chain_circuit(w)
    p = sharded.sharded_outcome_probs(circ, mesh)
    jax.block_until_ready(p)
    print(f"    sharding of the w={w} result: {p.sharding}; devices "
          f"{sorted(d.id for d in p.sharding.device_set)}", flush=True)
    ref = analytic.joint_outcome_probs(chain_w)
    tvd = float(0.5 * jnp.sum(jnp.abs(p - ref)))
    s.check("four cards sharded_outcome_probs", f"w={w}, 4 devices",
            f"TVD {tvd:.3g} vs the closed-form law on one card",
            tvd <= 1e-4 and len(p.sharding.device_set) == 4, "1e-4",
            "float32 planes: ~1e-6 relative rounding per pass")
    del p, ref

    m28 = _grid(*cfg["four_grid"], seed=0, scale=0.1)
    delta = float(np.exp(float(ve.log_partition(m28))
                         - m28.n * np.log(2.0)))
    shots = cfg["four_shots"]
    rates = sharded.sharded_estimate_delta(
        jax.random.PRNGKey(1), m28, mesh, shots, 4)
    print(f"    sharded_estimate_delta ran on {mesh.devices.size} devices: "
          f"{[d.id for d in mesh.devices.flat]}", flush=True)
    z = max(_five_sigma(float(r), delta, shots) for r in np.asarray(rates))
    s.check("four cards sharded_estimate_delta", f"n={m28.n} grid, "
            f"4 devices, 4 rounds x {shots} shots",
            f"max round {z:.2f} sigma from exact delta {delta:.6g}",
            z <= 5.0, "5 sigma", "binomial sampling noise")


def run(cfg: dict, phases, out: str) -> list:
    """Run ``phases`` at the sizes ``cfg`` into ``out``; returns the names
    of the failed checks."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    s = Smoke(cfg, out)
    for name, fn in phases:
        s.run(name, fn)
    return s.failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded paths on a 4-GPU mesh")
    args = p.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import qcmrf_tpu
    except ImportError:
        qcmrf_tpu = None
    if qcmrf_tpu is None or not os.path.abspath(
            qcmrf_tpu.__file__).startswith(HERE + os.sep):
        print("chip_smoke.py: the qcmrf_tpu package is not next to this "
              "script", file=sys.stderr)
        return 2

    from qcmrf_tpu.utils.device import require_gpu

    devs = require_gpu("chip_smoke.py")
    want = 4 if args.four_cards else 1
    if len(devs) < want:
        print(f"chip_smoke.py: needs {want} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2

    import jax

    from qcmrf_tpu.utils.config import enable_compilation_cache

    print(f"card: {card_line()}", flush=True)
    d0 = jax.devices()[0]
    print(f"jax: platform {d0.platform}, device_kind {d0.device_kind}, "
          f"device count {len(jax.devices())}", flush=True)
    print(f"compile cache: {enable_compilation_cache()}", flush=True)

    phases = ((("four cards", phase_four_cards),) if args.four_cards
              else PHASES)
    failed = run(FULL, phases, os.path.join(HERE, "smoke_out"))
    if failed:
        print(f"chip_smoke.py: failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
