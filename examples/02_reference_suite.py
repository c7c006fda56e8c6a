"""Run the reference's 70-circuit suite and evaluate it — pure library use.

Mirrors the CLI pipeline (`python -m qcmrf_tpu run` + `eval`) in code:
execute the scale-0.1 suite with the analytic engine, then compute the
per-graph fidelity/success table against exact inference — the same
numbers as /root/reference's eval.py on its stored result files
(BASELINE.md scale 0.1: F 0.999-1.000, success 0.757-0.936).

    python examples/02_reference_suite.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run (fewer shots,
# CPU pinned pre-backend-init so the tests never touch a GPU)
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
if SMOKE:
    import jax

    jax.config.update("jax_platforms", "cpu")

from qcmrf_tpu.evaluation.harness import evaluate_suite, results_table
from qcmrf_tpu.models.suite import load_suite, reference_models_path
from qcmrf_tpu.runners.run_experiment import run_suite

SHOTS = 1_000 if SMOKE else 10_000
suite = load_suite(reference_models_path(0.1), 0.1)
counts = run_suite(suite, shots=SHOTS, engine="analytic", seed=0)
results = evaluate_suite(suite, dists=counts, norm=SHOTS)
print(results_table(results))
