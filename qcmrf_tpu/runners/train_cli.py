"""Training CLI: fit an MRF by exact MLE, with checkpoint/resume.

``python -m qcmrf_tpu train --graph chain:8 --samples 20000 --steps 500``

Generates (or loads) data, fits theta by gradient descent on the exact
NLL, periodically checkpoints the parameters and optimizer state as
numpy arrays (``<outdir>/ckpt/<step>/state.npz``, the two newest kept),
and writes the fitted model as JSON ``{"cliques": ..., "theta": ...}``.
Resume with ``--resume`` picks up from the newest checkpoint (SURVEY.md
§5: the reference's only checkpointing is its JSON artifacts; training
state checkpointing is a new subsystem). ``--mesh AxB`` runs the sharded
(amp x data) training step over a device mesh
(models.train.make_sharded_train_step). ``--learn-structure`` selects
the clique set itself by group-lasso MLE over ``--candidates`` before
the final fit (models/structure.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from qcmrf_tpu.utils.config import dump_effective_config, parse_with_config


def parse_graph(spec: str):
    """'chain:N' | 'grid:RxC' | path to a JSON [[...], ...] clique list."""
    if spec.startswith("chain:"):
        n = int(spec.split(":")[1])
        return [[i, i + 1] for i in range(n - 1)]
    if spec.startswith("grid:"):
        r, c = spec.split(":")[1].split("x")
        from qcmrf_tpu.models.mrf import grid_mrf

        return [list(C) for C in grid_mrf(int(r), int(c)).cliques]
    with open(spec) as f:
        return json.load(f)


def _ckpt_steps(root: str) -> List[int]:
    """Steps with a complete checkpoint under ``root``, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root) if d.isdigit()
                  and os.path.isfile(os.path.join(root, d, "state.npz")))


def _save_ckpt(root: str, step: int, tree, keep: int = 2) -> None:
    """Write ``tree``'s leaves as ``<root>/<step>/state.npz`` (renamed into
    place, so a crash never leaves a partial step) and keep the newest
    ``keep`` steps."""
    import shutil

    import jax

    d = os.path.join(root, str(step))
    tmp = d + ".partial"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "state.npz"),
             *[np.asarray(x) for x in jax.tree.leaves(tree)])
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp, d)
    for old in _ckpt_steps(root)[:-keep]:
        shutil.rmtree(os.path.join(root, str(old)))


def _restore_ckpt(root: str, step: int, like):
    """The pytree saved at ``step``, in the structure of ``like``."""
    import jax
    import jax.numpy as jnp

    with np.load(os.path.join(root, str(step), "state.npz")) as f:
        leaves = [jnp.asarray(f[f"arr_{i}"]) for i in range(len(f.files))]
    return jax.tree.unflatten(jax.tree.structure(like), leaves)


def _make_mesh(spec: str):
    """'AxB' -> a 2-D (amp, data) Mesh over the first A*B devices."""
    import jax
    from jax.sharding import Mesh

    a, b = (int(x) for x in spec.split("x"))
    devs = jax.devices()
    if len(devs) < a * b:
        raise SystemExit(
            f"--mesh {spec} needs {a * b} devices, {len(devs)} visible"
        )
    return Mesh(np.array(devs[: a * b]).reshape(a, b), ("amp", "data"))


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(prog="qcmrf_tpu train")
    parser.add_argument("--graph", type=str, default="chain:6")
    parser.add_argument("--samples", type=int, default=20_000)
    parser.add_argument("--data", type=str, default=None,
                        help="JSON list of observed state ids (else sampled "
                             "from a random ground-truth model)")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--lr", type=float, default=0.05)
    # dest distinct from Config.seed (the suite-generation
    # constant): this seed drives data generation only
    parser.add_argument("--data-seed", "--seed",
                        dest="data_seed", type=int, default=0)
    parser.add_argument("--outdir", type=str, default="./train_out")
    parser.add_argument("--checkpoint-every", type=int, default=100)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--grad", type=str, default="exact",
                        choices=["exact", "shots", "ais"],
                        help="model-moment term of the NLL gradient: "
                             "exact inference, post-selected circuit "
                             "shots (quantum-in-the-loop training), or "
                             "annealed-importance-sampling moments — "
                             "the no-structural-cap route for models "
                             "past BOTH exact backends (induced width > "
                             "elimination cap AND n > streaming cap)")
    parser.add_argument("--grad-shots", type=int, default=1 << 14,
                        help="shots per step for --grad shots")
    parser.add_argument("--ais-chains", type=int, default=256,
                        help="--grad ais: importance chains per step")
    parser.add_argument("--ais-temps", type=int, default=64,
                        help="--grad ais: annealing rungs per step "
                             "(raise under strong coupling / low ESS)")
    parser.add_argument("--ais-ess-frac", type=float, default=0.1,
                        help="--grad ais: skip a step whose effective "
                             "sample size falls below this fraction of "
                             "--ais-chains (collapsed weights give "
                             "noise-dominated gradients)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="AxB: run the sharded train step on an "
                             "(amp=A, data=B) device mesh; with --grad "
                             "shots, shots shard over all A*B devices")
    parser.add_argument("--platform", type=str, default="default",
                        choices=["cpu", "gpu", "default"],
                        help="'default' routes small fits (n <= 20, no "
                             "--mesh) to cpu and takes the default "
                             "backend for the rest; 'gpu' requires a GPU")
    parser.add_argument("--learn-structure", action="store_true",
                        help="select the clique structure itself by "
                             "group-lasso MLE over --candidates before "
                             "the final fit (models/structure.py); "
                             "--graph then only sets n and the synthetic "
                             "ground truth")
    parser.add_argument("--candidates", type=str, default="pairs",
                        help="'pairs' (all n*(n-1)/2 edges) or a JSON "
                             "clique-list path; size >= 2 only")
    parser.add_argument("--l1", type=float, default=0.02,
                        help="group-lasso strength for --learn-structure")
    parser.add_argument("--prune-tol", type=float, default=0.05,
                        help="absolute interaction-norm prune cut")
    args = parse_with_config(parser, argv)

    # graph spec first (host-side JSON only): the platform decision needs
    # n, and resolving the platform must precede any backend init
    cliques = parse_graph(args.graph)
    n_vars = 1 + max(v for C in cliques for v in C)

    from qcmrf_tpu.utils.device import resolve_platform
    resolve_platform(
        args.platform,
        small=n_vars <= 20 and not args.mesh,
        small_reason=f"n={n_vars} fits train fastest on the host",
        prog="qcmrf_tpu train")

    from qcmrf_tpu.utils.config import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import optax

    from qcmrf_tpu.models import sample as msample
    from qcmrf_tpu.models import train as mtrain
    from qcmrf_tpu.models.mrf import MRF

    template = MRF.create(cliques)
    # past the int32 state-id ceiling, data travels as per-variable bit
    # arrays and training runs on the sufficient statistics with the
    # differentiable-elimination lnZ (exact for bounded treewidth at any
    # n; models/elimination.py) or, past the induced-width cap, the
    # streaming custom-VJP lnZ (arbitrary structure; models/moments.py)
    # QCMRF_BIG_N_THRESHOLD exists so tests can drive the big-n code
    # path (bit-array data, moment-target training) at tiny widths
    from qcmrf_tpu.models.capability import big_n_threshold
    big = template.n > big_n_threshold()
    wide = False
    if big:
        from qcmrf_tpu.models import elimination, moments

        wide = (elimination.induced_width(template.cliques, template.n)
                > mtrain._ELIM_WIDTH_CAP)
        if wide and template.n > moments._MAX_N and args.grad != "ais":
            raise SystemExit(
                f"n={template.n} with induced width past the elimination "
                f"cap needs the streaming sweep, which tops out at "
                f"n={moments._MAX_N} (int32 block ids) — pass --grad ais "
                "to train on AIS moment estimates (ESS-gated, no "
                "structural cap)")
    if (big and args.mesh and not wide and args.grad != "ais"
            and not args.learn_structure):
        # structure learning is exempt: ITS width is the candidate
        # template's (singletons + candidates), not --graph's, and the
        # selection sweep shards over the mesh when that template is wide
        raise SystemExit("--mesh is for the enumerated state table "
                         "(n <= 30), wide structures (streaming sweep), "
                         "or --grad ais (sharded chains); elimination "
                         "training is single-device")
    if big and args.grad == "shots":
        raise SystemExit("--grad shots needs the circuit sampler's int32 "
                         "state ids (n <= 30)")
    if args.learn_structure and args.grad != "exact":
        raise SystemExit("--learn-structure selects by the exact NLL "
                         "gradient (--grad exact); shots/ais gradients "
                         "serve fixed structures. The selection itself "
                         "scales wherever exact training does: "
                         "elimination at any n for bounded width, the "
                         "streaming sweep (mesh-shardable) to n=47 for "
                         "wide candidate sets")
    os.makedirs(args.outdir, exist_ok=True)
    dump_effective_config(args, os.path.join(args.outdir, "train_config.json"))

    rng = np.random.RandomState(args.data_seed)
    if args.data:
        with open(args.data) as f:
            loaded = json.load(f)
        if big:
            data = np.asarray(loaded, np.uint8)
            if data.ndim != 2 or data.shape[1] != template.n:
                raise SystemExit(
                    f"--data for n={template.n} > 30 must be a JSON list "
                    f"of {template.n}-bit arrays (one list of 0/1 per "
                    f"sample); got shape {data.shape}"
                )
        else:
            data = jnp.asarray(loaded, jnp.int32)
    elif big:
        # ground truth at large n, as bit arrays: exact MAP of
        # Gumbel-perturbed models (perturb-and-MAP, elimination.sample_pam)
        # for bounded treewidth; wide structures — where elimination's
        # width makes PAM intractable — fall back to the any-n bit-array
        # Gibbs chain (approximate: a finite chain mixes, it does not
        # sample exactly; fine for synthetic ground truth, pass --data
        # for exactness-critical fits)
        from qcmrf_tpu.models import elimination

        true = template.with_theta(
            jnp.asarray(-np.abs(rng.randn(template.dimension)), jnp.float32)
        )
        if wide:
            data = np.asarray(msample.sample_gibbs_bits(
                jax.random.PRNGKey(args.data_seed), true, args.samples,
                thin=10, burn=100
            ), np.uint8)
        else:
            data = np.asarray(elimination.sample_pam(
                jax.random.PRNGKey(args.data_seed), true, args.samples
            ), np.uint8)
        with open(os.path.join(args.outdir, "data.json"), "w") as f:
            json.dump(data.tolist(), f)
    else:
        true = template.with_theta(
            jnp.asarray(-np.abs(rng.randn(template.dimension)), jnp.float32)
        )
        if template.n > 22:
            # no 2^n table at this size: draw data with the Gibbs chain
            # (thin=10 matches the reference's chain convention,
            # eval.py:96-98; short thinning risks autocorrelated moments)
            data = msample.sample_gibbs(
                jax.random.PRNGKey(args.data_seed), true, args.samples,
                thin=10, burn=100,
            )
        else:
            data = msample.sample_exact(
                jax.random.PRNGKey(args.data_seed), true, args.samples
            )
        with open(os.path.join(args.outdir, "data.json"), "w") as f:
            json.dump(np.asarray(data).tolist(), f)

    if args.learn_structure:
        from qcmrf_tpu.models import structure as mstruct

        if args.candidates == "pairs":
            cands = mstruct.candidate_pairs(template.n)
        else:
            with open(args.candidates) as f:
                cands = json.load(f)
        mesh = _make_mesh(args.mesh) if args.mesh else None
        try:
            fit = mstruct.fit_structure(
                cands, data, template.n, lam=args.l1, steps=args.steps,
                learning_rate=args.lr, prune_tol=args.prune_tol,
                mesh=mesh)
        except ValueError as e:
            # the lnZ router's past-both-caps refusal, as a clean CLI
            # error (reduce the candidate set or n)
            raise SystemExit(str(e))
        out_path = os.path.join(args.outdir, "fitted_model.json")
        with open(out_path, "w") as f:
            json.dump(
                {"cliques": [list(C) for C in fit.mrf.cliques],
                 "theta": np.asarray(fit.mrf.theta, np.float64).tolist(),
                 "final_nll": fit.nll,
                 "structure": {
                     "selected": fit.selected,
                     "candidates": [list(C) for C in cands],
                     "interaction_norm": fit.group_norm.tolist(),
                     "template_cliques": fit.cliques,
                     "threshold": fit.threshold,
                     "l1": args.l1,
                 }},
                f, indent=2,
            )
        print(f"selected {len(fit.selected)}/{len(cands)} candidates "
              f"(cut {fit.threshold:.4g}); wrote {out_path}")
        return out_path

    opt = optax.adam(args.lr)
    init = template.with_theta(jnp.full((template.dimension,), -0.5))
    raw = mtrain._from_theta(init.theta, True)
    opt_state = opt.init(raw)
    start = 0

    ckpt = os.path.abspath(os.path.join(args.outdir, "ckpt"))
    steps = _ckpt_steps(ckpt)
    if args.resume and steps:
        start = steps[-1]
        raw, opt_state = _restore_ckpt(ckpt, start, (raw, opt_state))
        print(f"resumed from step {start}")

    mesh = None
    if args.mesh:
        mesh = _make_mesh(args.mesh)
        # keep inputs UNCOMMITTED (host round-trip): pre-committing them
        # to the mesh (device_put with NamedSharding) intermittently
        # deadlocks XLA-CPU's subgroup all-reduce rendezvous (SIGABRT
        # after its 40 s termination timeout, ~50% repro on the 8-device
        # host platform), while uncommitted inputs — data/raw produced by
        # samplers or checkpoint restore land committed to device 0
        # otherwise — dispatch cleanly and the step shards them itself.
        raw = jnp.asarray(np.asarray(raw))
        opt_state = jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x)), opt_state
        )
        data = jnp.asarray(np.asarray(data))

    loss_label = "nll"
    ais_skips = [0]
    if args.grad == "ais":
        # stochastic AIS moments: the only gradient with no structural
        # cap — serves the regime where induced width exceeds the
        # elimination cap AND n exceeds the streaming cap (the round-4
        # verdict's missing training route; oracle-moments role of
        # /root/reference/eval.py:84-93)
        if big:
            mu_hat = mtrain.empirical_moments_from_bits(template, data)
        else:
            from qcmrf_tpu.evaluation.estimators import (
                clique_marginals_from_samples)

            mu_hat = jnp.asarray(clique_marginals_from_samples(
                template, np.asarray(data)), jnp.float32)
        data = jnp.zeros((), jnp.int32)  # unused by the moment step
        ais_step = mtrain.make_ais_train_step(
            template, opt, mu_hat, num_chains=args.ais_chains,
            num_temps=args.ais_temps, ess_min_frac=args.ais_ess_frac,
            mesh=mesh)
        loss_label = "ess"

        def step_fn(raw, opt_state, _data, _key=[jax.random.PRNGKey(
                args.data_seed + 2)]):
            _key[0], sub = jax.random.split(_key[0])
            raw, opt_state, info = ais_step(raw, opt_state, sub)
            if info["skipped"]:
                ais_skips[0] += 1
                print(
                    f"warning: AIS ESS {info['ess']:.1f} < "
                    f"{args.ais_ess_frac:.2f} * {args.ais_chains} — step "
                    "skipped (collapsed importance weights; raise "
                    "--ais-temps)", file=sys.stderr)
            return raw, opt_state, info["ess"]
    elif big:
        mu_hat = mtrain.empirical_moments_from_bits(template, data)
        data = jnp.zeros((), jnp.int32)  # unused by the moment step
        # wide structures accept --mesh: the streaming moment sweep
        # shards its block range over the device mesh (a multi-axis
        # AxB mesh is flattened inside the sharded sweep entry points,
        # parallel.sharded._sweep_mesh)
        step_fn = mtrain.make_moment_train_step(
            template, opt, mu_hat, mesh=mesh)
    elif args.mesh and args.grad != "shots":
        if template.num_states % mesh.shape["amp"]:
            raise SystemExit("amp axis must divide the state-table size")
        if data.shape[0] % mesh.shape["data"]:
            kept = data.shape[0] - data.shape[0] % mesh.shape["data"]
            print(
                f"warning: --mesh data axis {mesh.shape['data']} does not "
                f"divide the {data.shape[0]} samples; training on the "
                f"first {kept} (the dropped tail changes the objective "
                "slightly vs a single-device fit)",
                file=sys.stderr,
            )
            data = data[:kept]
            # provenance must reflect what was actually trained on
            args.effective_samples = kept
            dump_effective_config(
                args, os.path.join(args.outdir, "train_config.json")
            )
        step_fn = mtrain.make_sharded_train_step(template, opt, mesh)
    elif args.grad == "shots":
        from qcmrf_tpu.evaluation.estimators import (
            clique_marginals_from_samples)

        if mesh is not None:
            # shot parallelism uses every mesh device, whatever the AxB
            # split (parallel.sharded_shot_moments flattens multi-axis
            # meshes itself — pure data parallelism, one (d,)-sized psum
            # per step)
            n_dev = mesh.devices.size
            if args.grad_shots % n_dev:
                raise SystemExit(
                    f"--grad-shots ({args.grad_shots}) must be divisible "
                    f"by the mesh size ({n_dev})"
                )
        data_marg = clique_marginals_from_samples(template,
                                                  np.asarray(data))
        shots_step = mtrain.make_shots_train_step(
            template, opt, args.grad_shots, data_marg, mesh=mesh)

        def step_fn(raw, opt_state, _data, _key=[jax.random.PRNGKey(
                args.data_seed + 1)]):
            _key[0], sub = jax.random.split(_key[0])
            raw_pre = raw  # delta-hat below is estimated at these params
            raw, opt_state, delta = shots_step(raw, opt_state, sub)
            # report the NLL estimated from the same shots:
            # lnZ_hat = ln(delta) + n ln 2; the data term uses the SAME
            # (pre-update) theta the shots were drawn at, so both terms
            # of the logged loss refer to one parameter vector
            nll = float(np.log(max(delta, 1e-300)) + template.n
                        * np.log(2.0)) - float(
                template.beta * jnp.mean(
                    template.with_theta(
                        mtrain._to_theta(raw_pre, True)).log_potential(
                            _data)))
            return raw, opt_state, nll
    else:
        step_fn = mtrain.make_train_step(template, opt)
    loss = float("nan")
    for s in range(start, args.steps):
        raw, opt_state, loss = step_fn(raw, opt_state, data)
        if (s + 1) % args.checkpoint_every == 0 or s + 1 == args.steps:
            _save_ckpt(ckpt, s + 1, (raw, opt_state))
            print(f"step {s + 1}: {loss_label}={float(loss):.4f} "
                  "(checkpointed)")

    theta = mtrain._to_theta(raw, True)
    out_path = os.path.join(args.outdir, "fitted_model.json")
    out_doc = {"cliques": cliques,
               "theta": np.asarray(theta, np.float64).tolist()}
    if args.grad == "ais":
        # no exact NLL exists in this regime; record the estimator's
        # health diagnostics instead
        out_doc["final_ess"] = float(loss)
        out_doc["ais_skipped_steps"] = ais_skips[0]
    else:
        out_doc["final_nll"] = float(loss)
    with open(out_path, "w") as f:
        json.dump(out_doc, f, indent=2)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
