"""Build an MRF, compile its QCMRF circuit, sample, compare to exact Gibbs.

The minimum end-to-end loop of the framework (the reference's QCMRF.py +
run_experiment.py workflow, /root/reference/QCMRF.py:199-243, in a dozen
lines). Runs on CPU or GPU.

    python examples/01_build_and_sample.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run (fewer shots,
# CPU pinned pre-backend-init so the tests never touch a GPU)
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))

import jax

if SMOKE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from qcmrf_tpu import MRF, compile_qcmrf, fidelity
from qcmrf_tpu.evaluation.metrics import extract_probs
from qcmrf_tpu.sim import analytic, sampler

# a triangle MRF over 3 binary variables; theta <= 0 (one weight per
# clique state, binary-counting order with y[0] slowest)
rng = np.random.RandomState(0)
mrf = MRF.create([[0, 1, 2]], theta=-np.abs(rng.randn(8)) * 0.4)

# the compiled circuit (n variables + 1 ancilla/clique + 1 workspace)
circ = compile_qcmrf(mrf)
print(f"circuit: {circ.num_qubits} qubits, {len(circ.gates)} gates")

# closed-form outcome law: post-selected distribution == Gibbs, and the
# acceptance rate delta == Z / 2^n
p_exact = np.asarray(mrf.gibbs_probs())
p_circ, delta = analytic.postselected_probs(mrf)
print(f"delta = {float(delta):.4f}  (Z/2^n = "
      f"{float(mrf.success_rate()):.4f})")

# shot sampling + the reference's extract_probs post-selection
keys = analytic.sample_outcomes(
    jax.random.PRNGKey(0), mrf, 2_000 if SMOKE else 10_000
)
counts = sampler.counts_from_samples(np.asarray(keys), circ.num_qubits)
q, delta_hat = extract_probs(counts, mrf.n, mrf.num_cliques + 1)
print(f"fidelity(exact, sampled) = {fidelity(p_exact, q):.4f}, "
      f"delta_hat = {delta_hat:.4f}")
