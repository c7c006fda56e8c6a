"""Emulate IBM hardware: calibrated noise, mitigation, whisker figure.

The reference ran its suite on real IBM backends (ibm_torino etc.,
/root/reference/run_experiment.py:63-82) and shipped the result files.
This example reproduces that pipeline without a cloud account: load the
stored PHYSICAL per-gate noise calibration (gate-level depolarizing in
an exact density-matrix engine + readout/mitigation calibration drift,
noise/physical.py), emulate the suite shot-by-shot (sampling + tensored
readout mitigation -> negative quasi-probs), and compare the emulated
per-graph mean fidelity/success/KL against the real hardware's. Finishes
with the reference's whisker figure rendered from the stored results.

    python examples/05_hardware_emulation.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# the suite models are tiny (<= 10 qubits): host CPU beats paying an
# accelerator compile per circuit shape (same choice as the whisker CLI's
# --platform default). Must happen before any backend initialization.
jax.config.update("jax_platforms", "cpu")

from qcmrf_tpu.evaluation.harness import evaluate_suite, load_result_dists
from qcmrf_tpu.models.suite import (load_suite, reference_models_path,
                                    reference_results_path)
from qcmrf_tpu.noise.physical import load_physical, run_physical_suite

suite = load_suite(reference_models_path(0.1), 0.1)

# the stored ibm_torino result file the calibration was fitted to is the
# comparison baseline
hw_dists, hw_norm = load_result_dists(
    reference_results_path(0.1, "torino", "/root/reference"))
model = load_physical("torino", 0.1)

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run — 2 graphs x 3
# reps at 4k shots (the sliced means are too noisy for the full-suite
# tolerance assertions below, so those only run at full size)
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
if SMOKE:
    import dataclasses

    reps = 3
    suite = dataclasses.replace(
        suite,
        graphs=suite.graphs[:2],
        thetas={j: suite.thetas[j][:reps] for j in (0, 1)},
    )
    hw_dists = [hw_dists[j * 10 + i] for j in (0, 1) for i in range(reps)]

result = run_physical_suite(jax.random.PRNGKey(0), suite, model,
                            shots=4_000 if SMOKE else 10_000)
emu = evaluate_suite(suite, dists=result["quasi_dists"], norm=1)
hw = evaluate_suite(suite, dists=hw_dists, norm=hw_norm)

print(f"{'graph':>34}  {'F(hw)':>6} {'F(emu)':>6}  "
      f"{'d(hw)':>6} {'d(emu)':>6}  {'KL(hw)':>7} {'KL(emu)':>7}")
for e, h in zip(emu, hw):
    print(f"{str(h.graph):>34}  {h.mean_f:6.3f} "
          f"{e.mean_f:6.3f}  {h.mean_delta:6.3f} "
          f"{e.mean_delta:6.3f}  {h.mean_kl:7.4f} {e.mean_kl:7.4f}")
    if not SMOKE:  # sliced-suite means are shot/rep-noise-dominated
        assert abs(e.mean_f - h.mean_f) <= 0.02
        assert abs(e.mean_delta - h.mean_delta) <= 0.05
        # KL is never fitted anywhere — it emerges from the gate-level
        # channel structure
        assert abs(e.mean_kl - h.mean_kl) <= max(0.35 * h.mean_kl, 0.012)

# the reference's success_{backend}.pdf from the stored tables
from qcmrf_tpu.viz import whisker

out = whisker.main(["--backend", "torino", "--res-root", "/root/reference",
                    "--out", "/tmp/success_torino.pdf",
                    "--platform", "default"])
