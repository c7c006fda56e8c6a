"""Exact-MLE training for structures variable elimination can't touch.

Every other exact route has a hard wall: the enumerated 2^n table stops
fitting around n=22, and variable elimination (any n) needs bounded
treewidth. The streaming custom-VJP lnZ (models/moments.py) has neither
— d lnZ/d theta = beta * E_p[phi] comes from a chunked state sweep on
the deduplicated bit-monomial basis, so exact MLE runs for ANY clique
structure up to the n <= 47 structural cap (a K27 complete graph —
elimination scope 27 — trains at 266 ms/step on one H100 at its 700 W
limit; see PERF.md). The reference never trains at all (its exact oracle,
kiopto_native, only evaluates fixed draws — /root/reference/eval.py:84).

This example runs the same code path on a toy complete graph so it
converges in seconds on CPU: the width cap is lowered so the streaming
branch engages at K10 exactly as it would automatically for width > 25.

    python examples/06_wide_structure_training.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# force the streaming branch at toy width (it engages automatically for
# induced width > 25, i.e. complete graphs past n=26); must be set
# before qcmrf_tpu.models.train is imported
os.environ.setdefault("QCMRF_ELIM_WIDTH_CAP", "3")

import jax

# host-side optimization loop: per-step dispatch latency on an
# accelerator dwarfs the toy compute, so run on CPU (before backend init)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import optax

from qcmrf_tpu import MRF, kl
from qcmrf_tpu.models import elimination, sample as msample, train as mtrain

SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))

# ground truth: a complete graph (every pair is a clique) — the worst
# case for elimination: its per-step table scope here is all n vars
n = 8 if SMOKE else 10
cliques = [[i, j] for i in range(n) for j in range(i + 1, n)]
probe = MRF.create(cliques)
rng = np.random.RandomState(0)
truth = MRF.create(cliques, theta=-np.abs(
    rng.randn(probe.dimension)).astype(np.float32) * 0.4)
width = elimination.induced_width(truth.cliques, truth.n)
print(f"K{n}: {len(cliques)} cliques, elimination table scope {width} "
      f"(> cap {mtrain._ELIM_WIDTH_CAP} -> streaming branch)")

# data reduces to its sufficient statistics once — past n=30 the CLI
# ships samples as (S, n) bit arrays for exactly this reason
ids = np.asarray(msample.sample_exact(
    jax.random.PRNGKey(0), truth, 4_000 if SMOKE else 20_000))
bits = (ids[:, None] >> (n - 1 - np.arange(n))) & 1
mu_hat = mtrain.empirical_moments_from_bits(truth, bits)

# the moment-target step: loss = lnZ(theta) - beta * theta^T mu_hat,
# with lnZ's gradient from the streaming monomial sweep (custom VJP)
opt = optax.adam(0.1)
step = mtrain.make_moment_train_step(truth, opt, mu_hat)
raw = mtrain._from_theta(jnp.full((truth.dimension,), -0.5), True)
state = opt.init(raw)
steps = 120 if SMOKE else 400
for i in range(steps):
    raw, state, loss = step(raw, state)
    if (i + 1) % (steps // 4) == 0:
        print(f"step {i + 1}: nll {float(loss):.4f}")

fitted = truth.with_theta(mtrain._to_theta(raw, True))
d = float(kl(np.asarray(truth.gibbs_probs(), np.float64),
             np.asarray(fitted.gibbs_probs(), np.float64)))
print(f"KL(truth || fitted) = {d:.5f}")
assert d < (0.15 if SMOKE else 0.05)

# conditional queries on the fitted model use the same streaming
# machinery: evidence is clamped by exact clique-table reduction, so
# P(x_v | evidence) never needs elimination's bounded treewidth
from qcmrf_tpu.models import moments

ev = {0: 1, 3: 0}
p = float(moments.conditional_prob_streaming(fitted, 1, 1, ev))
p_true = float(elimination.conditional_prob(truth, 1, 1, ev))
print(f"P(x1=1 | x0=1, x3=0): fitted {p:.4f}, truth {p_true:.4f}")
assert abs(p - p_true) < (0.15 if SMOKE else 0.05)

# the same step shards over a device mesh (per-device block-range
# sweeps, one psum per gradient): pass mesh=... here, or --mesh AxB to
# `python -m qcmrf_tpu train --graph k27.json --data bits.json`
