"""qcmrf_tpu — a quantum-circuit-MRF framework in JAX, run on the GPU.

Built from scratch in JAX/XLA with the capabilities of the reference
``np84/qcmrf`` research artifact (circuit compiler, statevector simulation,
exact classical inference, evaluation + figures), re-designed for an
accelerator: vectorized gathers instead of per-state Python loops, fused
diagonal-phase passes instead of AND-gate workspace qubits, statevectors
sharded over a device mesh for models beyond one device's memory, and
autodiff-based MRF training.
"""

from qcmrf_tpu.circuits.compiler import QCMRF, compile_qcmrf
from qcmrf_tpu.circuits.ir import Circuit, Gate
from qcmrf_tpu.circuits.lower import basis_gate_counts, lower
from qcmrf_tpu.circuits.params import gamma_to_theta, theta_to_gamma
from qcmrf_tpu.evaluation.estimators import (
    clique_marginals_exact,
    estimate_from_circuit,
    log_partition_from_counts,
)
from qcmrf_tpu.evaluation.metrics import KL, extract_probs, fidelity, kl
from qcmrf_tpu.models.mrf import MRF, chain_mrf, grid_mrf
from qcmrf_tpu.models.suite import GRAPHS, ModelSuite, generate_suite, load_suite
from qcmrf_tpu.models.elimination import (
    clique_marginals as elimination_marginals,
    log_partition as elimination_log_partition,
    marginal_map,
    sample_exact_elim,
)
from qcmrf_tpu.models.ais import (
    ais_clique_marginals,
    ais_event_prob,
    ais_log_partition,
)
from qcmrf_tpu.models.capability import explain as explain_capabilities
from qcmrf_tpu.models.sample import (
    map_state_clamped,
    sample_conditional,
)
from qcmrf_tpu.models.structure import (
    StructureFit,
    candidate_pairs,
    fit_structure,
    interaction_norms,
)
from qcmrf_tpu.models.train import fit_mle, fit_mle_sharded, fit_mle_shots
from qcmrf_tpu.noise.fit import (
    CalibratedNoiseModel,
    fit_calibrated,
    fit_noise_model,
)

__version__ = "0.1.0"

__all__ = [
    "QCMRF",
    "compile_qcmrf",
    "Circuit",
    "Gate",
    "MRF",
    "chain_mrf",
    "grid_mrf",
    "fidelity",
    "kl",
    "KL",
    "extract_probs",
    "theta_to_gamma",
    "gamma_to_theta",
    "GRAPHS",
    "ModelSuite",
    "generate_suite",
    "load_suite",
    "lower",
    "basis_gate_counts",
    "fit_mle",
    "fit_mle_sharded",
    "fit_mle_shots",
    "fit_structure",
    "candidate_pairs",
    "interaction_norms",
    "StructureFit",
    "estimate_from_circuit",
    "clique_marginals_exact",
    "log_partition_from_counts",
    "elimination_log_partition",
    "elimination_marginals",
    "marginal_map",
    "sample_exact_elim",
    "ais_log_partition",
    "ais_clique_marginals",
    "ais_event_prob",
    "explain_capabilities",
    "map_state_clamped",
    "sample_conditional",
    "CalibratedNoiseModel",
    "fit_calibrated",
    "fit_noise_model",
]
