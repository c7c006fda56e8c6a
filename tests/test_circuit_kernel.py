"""The vmapped dense suite path (sim.batch.batched_circuit_probs) vs the
per-circuit dense engine."""

import numpy as np
import pytest

from qcmrf_tpu.circuits.compiler import compile_qcmrf
from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.sim import batch as circuit_kernel
from qcmrf_tpu.sim import dense


GRAPHS = [
    [[0]],                              # width 3
    [[0, 1]],                           # width 4
    [[0, 1], [1, 2], [2, 3]],           # width 8
    [[0, 1, 2]],                        # width 5
    [[0, 1, 2], [2, 3, 4]],             # width 8
    [[0, 1, 2, 3]],                     # width 6
    [[0, 1], [1, 2], [2, 3], [3, 4]],   # width 10
]


@pytest.mark.parametrize("cliques", GRAPHS)
def test_fused_circuit_matches_dense(cliques):
    rng = np.random.RandomState(3)
    template = MRF.create(cliques)
    thetas = -np.abs(rng.randn(4, template.dimension)).astype(np.float32) * 0.5
    probs = np.asarray(circuit_kernel.batched_circuit_probs(cliques, thetas))
    for b in range(4):
        mrf = MRF.create(cliques, theta=thetas[b])
        want = np.asarray(dense.simulate_probs(compile_qcmrf(mrf)))
        np.testing.assert_allclose(probs[b], want, atol=2e-5)


def test_fused_circuit_zero_theta():
    """theta = 0: no phases fire; post-selected dist is uniform and
    delta = 1."""
    cliques = [[0, 1], [1, 2]]
    thetas = np.zeros((1, 8), dtype=np.float32)
    probs = np.asarray(
        circuit_kernel.batched_circuit_probs(cliques, thetas)
    )[0]
    n = 3
    np.testing.assert_allclose(probs[: 1 << n], 1.0 / (1 << n), atol=1e-6)
    assert probs[1 << n:].sum() < 1e-6


def test_fused_circuit_beta():
    cliques = [[0, 1]]
    rng = np.random.RandomState(5)
    thetas = -np.abs(rng.randn(1, 4)).astype(np.float32)
    probs = np.asarray(
        circuit_kernel.batched_circuit_probs(cliques, thetas, beta=2.0)
    )[0]
    mrf = MRF.create(cliques, theta=thetas[0], beta=2.0)
    want = np.asarray(dense.simulate_probs(compile_qcmrf(mrf)))
    np.testing.assert_allclose(probs, want, atol=2e-5)
