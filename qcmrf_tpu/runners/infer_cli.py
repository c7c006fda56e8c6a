"""``python -m qcmrf_tpu infer`` — serve inference queries on a model.

The serving counterpart of the reference oracle's query API
(``px.infer(b, task=...)`` / ``px.sample(b)``, exercised at
/root/reference/eval.py:92-113): load a model — typically the train
CLI's ``fitted_model.json`` — and answer the standard query set:

    lnz        log-partition (or evidence log-mass with ``--evidence``);
               ``--method ais`` estimates it by annealed importance
               sampling with an ESS/stderr report — the no-cap route
               for wide structures past the streaming sweeps' n <= 47
    prob       P(x_v = b | evidence)         (``--of v=b``)
    map        evidence-constrained MAP/MPE state
    mmap       marginal MAP over ``--max-vars`` (sum out the rest)
    marginals  clique-marginal tables E[phi | evidence] (theta layout)
    sample     conditional samples as bit rows (exact / gibbs / pam)

Backends route by structure, mirroring the training stack: bounded
induced width goes through differentiable variable elimination (any n);
wide structures go through the streaming sweeps (structural cap
n <= 47), which also shard over a device mesh with ``--mesh AxB``.
Output is one JSON object on stdout (plus ``--out`` to write a file).
``--queries file.jsonl`` serves a BATCH: one line of per-query
overrides each, answered in one process so compiled backends are
reused across queries (JSONL out, ``index`` echoes the line order).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def _parse_assignments(spec: str) -> dict:
    """'0=1,5=0' -> {0: 1, 5: 0} (also accepts ';' separators).
    A variable assigned twice is rejected — silently keeping the last
    value would accept conflicting evidence like '0=1,0=0'."""
    out = {}
    for part in spec.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        v, _, b = part.partition("=")
        try:
            v, b = int(v), int(b)
        except ValueError:
            raise SystemExit(
                f"bad assignment {part!r}: expected var=bit, e.g. 0=1")
        if v in out and out[v] != b:
            raise SystemExit(
                f"variable {v} assigned twice ({out[v]} and {b})")
        out[v] = b
    return out


def _bits_to_id(bits) -> int:
    """Variable-0-as-MSB state id from a bit row (arbitrary precision)."""
    x = 0
    for b in bits:
        x = (x << 1) | int(b)
    return x


def _logpot_from_bits(mrf, bits) -> float:
    """beta * theta^T phi(bits) on the host — id-width-free (n > 63 ok)."""
    total, off = 0.0, 0
    theta = np.asarray(mrf.theta, np.float64)
    for C in mrf.cliques:
        c = len(C)
        y = 0
        for s, v in enumerate(C):
            y |= int(bits[int(v)]) << (c - 1 - s)
        total += theta[off + y]
        off += 1 << c
    return float(mrf.beta) * total


def _validate_method(query: str, method: str, where: str = "") -> None:
    """Reject method/query combinations up front (round-4 advisor: an
    ignored '--method ais' on an exact query silently answered with the
    exact backend while reporting success)."""
    if method == "ais" and query not in ("lnz", "marginals", "prob"):
        raise SystemExit(
            f"{where}--method ais serves --query lnz, marginals and "
            f"prob only (the stochastic no-cap estimator has no "
            f"{query!r} form); drop --method or change --query")
    if method in ("gibbs", "pam") and query != "sample":
        raise SystemExit(
            f"{where}--method {method} applies to --query sample only "
            f"(--query {query} is answered by its exact backend)")


def _ais_chains(args, mesh) -> tuple:
    """(chains, note): the chain count actually run — rounded UP to a
    multiple of the mesh's device count so a sharded request never dies
    with a raw divisibility traceback (round-4 advisor finding)."""
    chains = int(args.ais_chains)
    if mesh is None:
        return chains, None
    from qcmrf_tpu.parallel.sharded import _sweep_mesh

    d = _sweep_mesh(mesh).devices.size
    if chains % d == 0:
        return chains, None
    rounded = -(-chains // d) * d
    return rounded, (f"--ais-chains {chains} rounded up to {rounded} "
                     f"(a multiple of the {d}-device mesh)")


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(prog="qcmrf_tpu infer")
    parser.add_argument("--model", type=str, default=None,
                        help="model JSON with {'cliques', 'theta'} — the "
                             "train CLI's fitted_model.json loads directly")
    parser.add_argument("--graph", type=str, default=None,
                        help="alternative to --model: 'chain:N' | "
                             "'grid:RxC' | clique-list JSON (theta "
                             "defaults to zeros unless --theta is given)")
    parser.add_argument("--theta", type=str, default=None,
                        help="theta for --graph: an inline JSON list "
                             "('[-0.5, -0.1, ...]') or the path of a "
                             "JSON file holding one")
    parser.add_argument("--theta-scale", type=float, default=None,
                        help="with --graph and no --theta: draw theta ~ "
                             "-|N(0,1)| * scale (seeded by --theta-seed) "
                             "instead of zeros — quick serving demos")
    parser.add_argument("--theta-seed", type=int, default=0)
    parser.add_argument("--beta", type=float, default=None,
                        help="inverse temperature (default: model file's "
                             "value or 1.0)")
    parser.add_argument("--query", type=str, default="lnz",
                        choices=["lnz", "prob", "map", "mmap",
                                 "marginals", "sample"])
    parser.add_argument("--evidence", type=str, default="",
                        help="clamped variables, e.g. '0=1,5=0'")
    parser.add_argument("--of", type=str, default=None,
                        help="the queried assignment for --query prob, "
                             "e.g. '3=1'")
    parser.add_argument("--max-vars", type=str, default=None,
                        help="comma-separated variables maximized over "
                             "for --query mmap (the rest are summed out)")
    parser.add_argument("--num-samples", type=int, default=100)
    parser.add_argument("--method", type=str, default="exact",
                        choices=["exact", "gibbs", "pam", "ais"],
                        help="sampler for --query sample; 'ais' on "
                             "--query lnz/marginals/prob estimates by "
                             "annealed importance sampling (any "
                             "structure/size)")
    parser.add_argument("--ais-chains", type=int, default=256)
    parser.add_argument("--ais-temps", type=int, default=128)
    parser.add_argument("--sample-seed", type=int, default=0)
    parser.add_argument("--mesh", type=str, default=None,
                        help="AxB: shard the streaming sweeps over a "
                             "device mesh")
    parser.add_argument("--queries", type=str, default=None,
                        help="JSONL file of per-query overrides (keys: "
                             "query/evidence/of/max_vars/num_samples/"
                             "method/sample_seed) answered in one process "
                             "— compiled backends are reused across lines")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the result JSON to this path "
                             "(JSONL with --queries)")
    parser.add_argument("--explain", action="store_true",
                        help="print the capability matrix — which "
                             "backends can answer this (structure, "
                             "evidence, query) and why (models/"
                             "capability.py) — instead of answering; "
                             "host-side only, never touches a device")
    parser.add_argument("--platform", type=str, default="default",
                        choices=["cpu", "gpu", "default"],
                        help="'default' routes small models (n <= 26, no "
                             "--mesh) to cpu — the serving math beats the "
                             "per-query accelerator compile there — and "
                             "takes the default backend for the rest; "
                             "'gpu' requires a GPU")
    from qcmrf_tpu.utils.config import parse_with_config
    args = parse_with_config(parser, argv)

    from qcmrf_tpu.runners.train_cli import parse_graph

    # ---- model spec (host-side JSON/numpy only: the platform is not
    #      resolved yet, and MRF.create would initialize a backend) -------
    beta = args.beta
    if args.model:
        with open(args.model) as f:
            spec = json.load(f)
        cliques = spec["cliques"]
        theta = np.asarray(spec["theta"], np.float64)
        if beta is None:
            beta = float(spec.get("beta", 1.0))
    elif args.graph:
        cliques = parse_graph(args.graph)
        dim = sum(1 << len(C) for C in cliques)
        if args.theta:
            # inline JSON list or a file path holding one (sniff the '[')
            s = args.theta.strip()
            try:
                if s.startswith("["):
                    theta = np.asarray(json.loads(s), np.float64)
                else:
                    with open(args.theta) as f:
                        theta = np.asarray(json.load(f), np.float64)
            except (OSError, json.JSONDecodeError) as e:
                raise SystemExit(
                    f"--theta {args.theta!r}: not a readable JSON file "
                    f"nor an inline JSON list ({e})")
        elif args.theta_scale is not None:
            rng = np.random.RandomState(args.theta_seed)
            theta = -np.abs(rng.randn(dim)) * float(args.theta_scale)
        else:
            theta = np.zeros((dim,))
        if beta is None:
            beta = 1.0
    else:
        raise SystemExit("pass --model fitted_model.json or --graph ...")

    _validate_method(args.query, args.method)
    if args.queries:
        # validate every batch line BEFORE answering any (and before the
        # platform/backend spin-up): bad input fails fast and clean
        with open(args.queries) as f:
            batch_specs = [json.loads(line) for line in f if line.strip()]
        allowed = {"query", "evidence", "of", "max_vars", "num_samples",
                   "method", "sample_seed"}
        for i, spec in enumerate(batch_specs):
            bad = set(spec) - allowed
            if bad:
                raise SystemExit(
                    f"--queries line {i + 1}: unknown keys {sorted(bad)} "
                    f"(allowed: {sorted(allowed)})")
            _validate_method(spec.get("query", args.query),
                             spec.get("method", args.method),
                             where=f"--queries line {i + 1}: ")

    n_vars = 1 + max(v for C in cliques for v in C)

    if args.explain:
        # capability matrix: answered host-side, before any platform or
        # backend work (one source of truth for the regime caps that
        # used to surface only as ValueErrors — models/capability.py)
        from qcmrf_tpu.models import capability

        mv = None
        if args.max_vars:
            mv = [int(v) for v in
                  args.max_vars.replace(";", ",").split(",") if v.strip()]
        report = capability.explain(
            cliques, n_vars, evidence=_parse_assignments(args.evidence),
            query=args.query, max_vars=mv, mesh=args.mesh is not None)
        line = json.dumps(report)
        print(line)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
        return report

    # ---- platform (qcmrf_tpu.utils.device) -----------------------------
    from qcmrf_tpu.utils.device import resolve_platform
    resolve_platform(
        args.platform,
        small=n_vars <= 26 and args.mesh is None,
        small_reason=f"n={n_vars} serves fastest on the host",
        prog="qcmrf_tpu infer")
    from qcmrf_tpu.utils.config import enable_compilation_cache
    enable_compilation_cache()

    from qcmrf_tpu.models.mrf import MRF
    from qcmrf_tpu.runners.train_cli import _make_mesh
    mrf = MRF.create(cliques, theta=theta, beta=beta)

    mesh = _make_mesh(args.mesh) if args.mesh else None

    if args.queries:
        # batch serving: one JSONL line of per-query overrides each
        # ("query"/"evidence"/"of"/"max_vars"/"num_samples"/"method"/
        # "sample_seed"), answered in-process so every compiled backend
        # (elimination plans, streaming kernels, samplers) is reused
        # across queries instead of re-jitted per CLI invocation
        import copy

        results = []
        for i, spec in enumerate(batch_specs):  # pre-validated above
            qargs = copy.copy(args)
            for k, v in spec.items():
                # JSON-native forms coerce to the flag formats:
                # evidence {"0": 1} -> "0=1", max_vars [1, 2] -> "1,2"
                if k == "evidence" and isinstance(v, dict):
                    v = ",".join(f"{u}={b}" for u, b in v.items())
                elif k in ("max_vars", "of") and isinstance(v, (list, dict)):
                    v = (",".join(f"{u}={b}" for u, b in v.items())
                         if isinstance(v, dict)
                         else ",".join(str(u) for u in v))
                setattr(qargs, k, v)
            res = _answer(mrf, qargs, mesh, beta)
            res["index"] = i
            results.append(res)
        out_f = open(args.out, "w") if args.out else None
        for res in results:
            line = json.dumps(res)
            print(line)
            if out_f:
                out_f.write(line + "\n")
        if out_f:
            out_f.close()
        return results

    result = _answer(mrf, args, mesh, beta)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


def _answer(mrf, args, mesh, beta) -> dict:
    """Answer one query namespace against a loaded model (the body of
    ``main``; split out so ``--queries`` batches reuse it per line)."""
    import jax

    from qcmrf_tpu.models import elimination, moments
    from qcmrf_tpu.models import sample as msample
    from qcmrf_tpu.models import train as mtrain

    evidence = _parse_assignments(args.evidence)
    elimination._validate_evidence(mrf.n, evidence)

    # ---- backend routing (mirrors models.train._nll) ----------------------
    width = elimination.induced_width(mrf.cliques, mrf.n)
    wide = width > mtrain._ELIM_WIDTH_CAP
    ais_q = args.method == "ais" and args.query in ("lnz", "marginals",
                                                    "prob")
    if (wide or mesh is not None) and mrf.n > moments._MAX_N \
            and args.query not in ("mmap", "sample") and not ais_q:
        # mmap routes on its own (constrained) width below, sample
        # feasibility is per-method on the REDUCED model (the bit-array
        # Gibbs chain serves any size), and AIS lnz/marginals have no
        # width or n cap at all — all exempt (round-4 reviews)
        raise SystemExit(
            f"n={mrf.n} needs the streaming sweep (induced width {width} "
            f"> elimination cap {mtrain._ELIM_WIDTH_CAP}, or --mesh), "
            f"which caps at n={moments._MAX_N}")
    use_streaming = wide or mesh is not None

    result = {"query": args.query, "n": mrf.n,
              "num_cliques": mrf.num_cliques, "beta": float(beta),
              "evidence": {str(v): b for v, b in evidence.items()},
              "backend": "streaming" if use_streaming else "elimination"}

    if args.query == "lnz":
        if ais_q:
            # stochastic estimate for ANY structure/size (the regime
            # where both exact backends refuse): AIS on the evidence-
            # reduced model, ln mass = beta*const + lnZ(reduced)
            from qcmrf_tpu.models import ais as mais

            chains, chains_note = _ais_chains(args, mesh)
            red, const = (moments.reduce_evidence(mrf, evidence)
                          if evidence else (mrf, 0.0))
            if red is not None:
                lnz_red, diag = mais.ais_log_partition(
                    jax.random.PRNGKey(args.sample_seed), red,
                    num_chains=chains, num_temps=args.ais_temps,
                    return_diagnostics=True, mesh=mesh)
            else:  # every variable observed: mass is the clamped const
                lnz_red = 0.0
                diag = {"ess": float(chains), "stderr": 0.0}
            val = float(beta) * float(const) + float(lnz_red)
            result["backend"] = "ais"
            result["ais"] = {"chains": chains,
                             "temps": args.ais_temps,
                             "seed": args.sample_seed,
                             "ess": float(diag["ess"]),
                             "stderr": float(diag["stderr"])}
            if chains_note:
                result["note"] = chains_note
        elif use_streaming:
            val = moments.log_partition_clamped_streaming(
                mrf, evidence, mesh)
        else:
            val = elimination.log_partition_clamped(mrf, evidence)
        result["lnz" if not evidence else "log_mass"] = float(val)
    elif args.query == "prob":
        if not args.of:
            raise SystemExit("--query prob needs --of v=b")
        of = _parse_assignments(args.of)
        if len(of) != 1:
            raise SystemExit("--of takes exactly one assignment")
        (v, b), = of.items()
        if ais_q:
            # stochastic P(x_v = b | evidence) in the same no-cap
            # regime as AIS lnz/marginals: weighted indicator of the
            # final chain states on the evidence-reduced model
            from qcmrf_tpu.models import ais as mais

            chains, chains_note = _ais_chains(args, mesh)
            result["backend"] = "ais"
            if v in evidence:
                p = 1.0 if evidence[v] == b else 0.0
                diag = {"ess": float(chains)}
            else:
                red, _ = (moments.reduce_evidence(mrf, evidence)
                          if evidence else (mrf, 0.0))
                if red is None:  # every variable observed, v not among
                    raise SystemExit("--query prob: all variables are "
                                     "observed but the queried one is "
                                     "not in the evidence — impossible")
                free = [u for u in range(mrf.n)
                        if u not in {int(w) for w in evidence}]
                p, diag = mais.ais_event_prob(
                    jax.random.PRNGKey(args.sample_seed), red,
                    free.index(v), b, num_chains=chains,
                    num_temps=args.ais_temps,
                    return_diagnostics=True, mesh=mesh)
            result["ais"] = {"chains": chains, "temps": args.ais_temps,
                             "seed": args.sample_seed,
                             "ess": float(diag["ess"])}
            if chains_note:
                result["note"] = chains_note
        else:
            fn = (moments.conditional_prob_streaming if use_streaming
                  else elimination.conditional_prob)
            p = (fn(mrf, v, b, evidence, mesh) if use_streaming
                 else fn(mrf, v, b, evidence))
        result["of"] = f"{v}={b}"
        result["prob"] = float(p)
    elif args.query == "map":
        if use_streaming:
            sid, val = msample.map_state_clamped(mrf, evidence, mesh)
            bits = [(sid >> (mrf.n - 1 - v)) & 1 for v in range(mrf.n)]
        else:
            red, _ = moments.reduce_evidence(mrf, evidence)
            bits = [0] * mrf.n
            for v, b in evidence.items():
                bits[int(v)] = int(b)
            if red is not None:
                free = [v for v in range(mrf.n) if v not in
                        {int(u) for u in evidence}]
                rbits = np.asarray(elimination.map_state_bits(red))
                for j, v in enumerate(free):
                    bits[v] = int(rbits[j])
            sid, val = _bits_to_id(bits), _logpot_from_bits(mrf, bits)
        result["state_id"] = sid
        result["state_bits"] = bits
        result["beta_logpot"] = float(val)
    elif args.query == "mmap":
        if not args.max_vars:
            raise SystemExit("--query mmap needs --max-vars v1,v2,...")
        try:
            req = sorted({int(v) for v in
                          args.max_vars.replace(";", ",").split(",")
                          if v.strip()})
        except ValueError:
            raise SystemExit(
                f"bad --max-vars {args.max_vars!r}: expected "
                "comma-separated variable indices")
        # mmap routes on the CONSTRAINED (sum-first, max-last)
        # elimination width, NOT the plain induced width: deferring the
        # max variables can blow the width up exponentially (star graph:
        # unconstrained 2, constrained |leaves|+1), and conversely a
        # bounded constrained width beats 2^|M| sharded sweeps even when
        # --mesh was passed (round-4 review findings)
        M = [v for v in req if v not in evidence]
        cw = elimination.mmap_width(mrf.cliques, mrf.n, M, evidence)
        if cw <= mtrain._ELIM_WIDTH_CAP:
            result["backend"] = "elimination"
            if mesh is not None:
                result["note"] = ("--mesh unused: constrained width "
                                  f"{cw} fits single-pass elimination")
            assignment, val = elimination.marginal_map(
                mrf, req, evidence)
        else:
            # 2^|M| clamped sweeps: enumeration over the max set is the
            # only exact route past elimination widths — cap the blowup.
            # Each sweep clamps evidence AND the max-set bits, so the
            # feasibility unit is the SWEPT size n - |ev| - |M|, not the
            # full n (round-4 review finding)
            swept = mrf.n - len(evidence) - len(M)
            if swept > moments._MAX_N:
                raise SystemExit(
                    f"mmap constrained elimination width {cw} > cap "
                    f"{mtrain._ELIM_WIDTH_CAP} and each clamped sweep "
                    f"covers {swept} free variables > streaming cap "
                    f"{moments._MAX_N}: no exact backend; reduce "
                    "--max-vars or add evidence")
            if len(M) > 16:
                raise SystemExit(
                    f"mmap constrained elimination width {cw} > cap "
                    f"{mtrain._ELIM_WIDTH_CAP}, and streaming mmap "
                    f"enumerates 2^{len(M)} clamped sweeps (cap 2^16) — "
                    "reduce --max-vars")
            result["backend"] = "streaming"
            assignment, val = moments.marginal_map_streaming(
                mrf, req, evidence, mesh)
        result["max_vars"] = {str(v): b for v, b in assignment.items()}
        result["log_mass"] = float(val)
    elif args.query == "marginals":
        if ais_q:
            # stochastic marginals in the same no-cap regime as AIS lnz:
            # weighted scatter of the final chain states, re-embedded
            # through the evidence reduction like the exact routes
            from qcmrf_tpu.models import ais as mais

            chains, chains_note = _ais_chains(args, mesh)
            red, _ = (moments.reduce_evidence(mrf, evidence)
                      if evidence else (mrf, 0.0))
            rmom, diag = mais.ais_clique_marginals(
                jax.random.PRNGKey(args.sample_seed), red,
                num_chains=chains, num_temps=args.ais_temps,
                return_diagnostics=True, mesh=mesh) if red is not None \
                else (np.zeros((0,)), {"ess": float(chains)})
            mu = (moments.embed_clamped_marginals(mrf, evidence, rmom)
                  if evidence else rmom)
            result["backend"] = "ais"
            result["ais"] = {"chains": chains,
                             "temps": args.ais_temps,
                             "seed": args.sample_seed,
                             "ess": float(diag["ess"])}
            if chains_note:
                result["note"] = chains_note
        elif use_streaming:
            mu = moments.clique_marginals_clamped_streaming(
                mrf, evidence, mesh)
        elif evidence:
            # elimination route: clamp exactly, then bounded-treewidth
            # marginals on the reduced model, re-embedded the same way
            red, _ = moments.reduce_evidence(mrf, evidence)
            rmom = (elimination.clique_marginals(red)
                    if red is not None else np.zeros((0,)))
            mu = moments.embed_clamped_marginals(mrf, evidence, rmom)
        else:
            mu = elimination.clique_marginals(mrf)
        result["marginals"] = np.asarray(mu, np.float64).tolist()
    elif args.query == "sample":
        key = jax.random.PRNGKey(args.sample_seed)
        method = args.method
        notes = []
        # feasibility is set by the REDUCED model the sampler sees:
        # exact draws come from elimination's ancestral sampler at any
        # n for bounded reduced width, or from the 2^nf logits table
        # while it fits; the bit-array Gibbs chain serves any n
        nf = mrf.n - len(evidence)
        table_cap = msample._EXACT_TABLE_HARD_N  # one shared 2^26 cap
        if method == "exact" and nf > table_cap:
            red, _ = moments.reduce_evidence(mrf, evidence)
            infeasible = red is not None and (
                elimination.induced_width(red.cliques, red.n)
                > mtrain._ELIM_WIDTH_CAP
                or elimination.plan_table_floats(red.cliques, red.n)
                > elimination._SAMPLER_TABLE_FLOATS_CAP)
            if infeasible:
                method = "pam"
                notes.append(
                    f"method 'exact' needs an enumerable table (2^{nf} "
                    f"free states > cap 2^{table_cap}) or a bounded "
                    f"reduced elimination plan (width cap "
                    f"{mtrain._ELIM_WIDTH_CAP}, stored-factor cap "
                    f"{elimination._SAMPLER_TABLE_FLOATS_CAP:.3g} "
                    f"floats); routed to 'pam'")
        if mesh is not None and method != "pam":
            notes.append(f"--mesh shards the 'pam' sampler only; "
                         f"'{method}' runs single-device")
        try:
            bits = msample.sample_conditional(
                key, mrf, args.num_samples, evidence, method=method,
                mesh=mesh if method == "pam" else None)
        except ValueError as e:
            # a sampler with no feasible backend explains its limits;
            # surface them as a clean CLI error, not a traceback
            raise SystemExit(str(e))
        result["method"] = method
        if notes:
            result["note"] = "; ".join(notes)
        result["samples"] = np.asarray(bits, np.int32).tolist()

    return result


if __name__ == "__main__":
    main(sys.argv[1:])
