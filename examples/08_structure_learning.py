"""Learn the clique structure itself from data (group-lasso MLE).

A capability with no reference counterpart (the reference evaluates
fixed random structures only — run_experiment.py:20-38): given samples
and a candidate clique set, `fit_structure` fits a group-penalized exact
MLE, prunes candidates with no interaction content, and refits the
survivors. The penalty acts on each block's order>=2 Walsh component —
gauge shifts and single-variable effects (carried by always-kept
singleton cliques) don't register, so a non-edge can't survive by
absorbing marginal biases. See `python -m qcmrf_tpu train
--learn-structure` for the CLI version.

    python examples/08_structure_learning.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# tiny model + a host-side optimization loop: per-step dispatch latency
# on an accelerator dwarfs the compute, so run on CPU (must happen
# before backend initialization)
jax.config.update("jax_platforms", "cpu")

import numpy as np

from qcmrf_tpu import MRF, candidate_pairs, fit_structure, kl
from qcmrf_tpu.models import sample as msample

SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))

# ground truth: a ring of 6 variables with guaranteed coupling strength
# (a raw random block can carry near-zero interaction content by chance,
# which no method could detect)
n = 6
edges = [[i, (i + 1) % n] for i in range(n)]
rng = np.random.RandomState(1)
blocks = []
for _ in edges:
    w = 0.8 + 0.6 * rng.rand()           # coupling in [0.8, 1.4]
    blk = -w * np.array([0, 1, 1, 0.0])  # agree-favoring interaction
    blk += -np.abs(rng.randn()) * np.array([0, 1, 0, 1.0])  # unary part
    blocks.append(blk - blk.max())
truth = MRF.create([sorted(e) for e in edges],
                   theta=np.concatenate(blocks), n=n)

data = msample.sample_exact(
    jax.random.PRNGKey(0), truth, 2048 if SMOKE else 20_000)

# candidates: all 15 pairs; the planted ring is 6 of them
fit = fit_structure(candidate_pairs(n), data, n,
                    steps=200 if SMOKE else 500)

print(f"candidates: {len(candidate_pairs(n))} pairs; "
      f"selected: {fit.selected}")
planted = sorted(sorted(e) for e in edges)
assert sorted(fit.selected) == planted, (fit.selected, planted)

d = float(kl(np.asarray(truth.gibbs_probs(), np.float64),
             np.asarray(fit.mrf.gibbs_probs(), np.float64)))
print(f"refit NLL {fit.nll:.4f}; KL(truth || refit) = {d:.5f}")
assert d < (0.08 if SMOKE else 0.02)

# the selection report: per-candidate interaction norms show the
# planted/spurious separation the absolute prune cut relies on
norms = fit.group_norm[n:]
spurious = [g for C, g in zip(candidate_pairs(n), norms)
            if sorted(C) not in planted]
print(f"interaction norms: planted >= "
      f"{min(g for C, g in zip(candidate_pairs(n), norms) if sorted(C) in planted):.3f}, "
      f"spurious <= {max(spurious):.4f} (cut {fit.threshold})")
