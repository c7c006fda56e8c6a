"""Fit an MRF to data by exact maximum likelihood (autodiff).

A capability with no reference counterpart: the NLL's gradient is the
moment gap E_data[phi] - E_model[phi]; model moments come from the exact
(enumerated or sharded) distribution, so gradient descent on theta is
exact MLE. See runners/train_cli.py for the checkpointed CLI version.

    python examples/04_training.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# tiny model + a host-side optimization loop: per-step dispatch latency
# on an accelerator dwarfs the compute, so run on CPU (must happen
# before backend initialization)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from qcmrf_tpu import MRF, fit_mle, kl
from qcmrf_tpu.models import sample as msample

# ground truth: a 6-variable chain
truth = MRF.create([[i, i + 1] for i in range(5)])
rng = np.random.RandomState(0)
truth = truth.with_theta(jnp.asarray(
    -np.abs(rng.randn(truth.dimension)).astype(np.float32)
))

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run (fewer steps and
# shots; convergence tolerances widen accordingly)
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))

data = msample.sample_exact(jax.random.PRNGKey(0), truth, 20_000)

init = truth.with_theta(jnp.full((truth.dimension,), -0.5))
fitted, nll = fit_mle(init, data, steps=80 if SMOKE else 300,
                      learning_rate=0.1)

d = float(kl(np.asarray(truth.gibbs_probs(), np.float64),
             np.asarray(fitted.gibbs_probs(), np.float64)))
print(f"final NLL {float(nll):.4f}; KL(truth || fitted) = {d:.5f}")
assert d < (0.05 if SMOKE else 0.01)

# quantum-in-the-loop variant: the gradient's model moments come from
# post-selected circuit samples instead of exact inference (see
# `python -m qcmrf_tpu train --grad shots` for the checkpointed CLI)
from qcmrf_tpu import fit_mle_shots

fitted_q, delta = fit_mle_shots(init, data, jax.random.PRNGKey(3),
                                steps=50 if SMOKE else 200,
                                shots=1 << (12 if SMOKE else 14),
                                learning_rate=0.1)
dq = float(kl(np.asarray(truth.gibbs_probs(), np.float64),
              np.asarray(fitted_q.gibbs_probs(), np.float64)))
print(f"shot-gradient fit: KL = {dq:.5f} (delta-hat {delta:.3f})")
assert dq < (0.1 if SMOKE else 0.02)
