"""Domain guards: theta > 0 and size limits must
raise loudly instead of silently producing wrong distributions."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.sim import analytic, dense, tpu as stpu
from qcmrf_tpu.circuits.ir import Circuit


def test_positive_theta_rejected_at_sampling_entry_points():
    bad = MRF.create([[0, 1]], theta=[0.5, -0.2, -0.2, -0.1])
    with pytest.raises(ValueError, match="theta"):
        analytic.sample_postselected(jax.random.PRNGKey(0), bad, 128)
    with pytest.raises(ValueError, match="theta"):
        analytic.sample_outcome_parts(jax.random.PRNGKey(0), bad, 128)
    with pytest.raises(ValueError, match="theta"):
        analytic.joint_outcome_probs(bad)
    with pytest.raises(ValueError, match="theta"):
        analytic.postselected_probs(bad)


def test_positive_theta_rejected_in_circuit_kernel():
    from qcmrf_tpu.sim import batch as circuit_kernel

    with pytest.raises(ValueError, match="theta"):
        circuit_kernel.batched_circuit_probs(
            [[0, 1]], np.array([[0.5, -0.2, -0.2, -0.1]]))


def test_circuit_kernel_width_guard():
    from qcmrf_tpu.sim import batch as circuit_kernel

    # 11 vars + 11 cliques -> width 23 > MAX_SUITE_WIDTH
    cliques = [[i, i + 1] for i in range(10)] + [[0, 10]]
    dim = 4 * len(cliques)
    with pytest.raises(ValueError, match="width"):
        circuit_kernel.batched_circuit_probs(
            cliques, -np.abs(np.random.RandomState(0).randn(1, dim)))


def test_outcome_probs_wide_clbit_register_matches_dense():
    """num_clbits > num_qubits must NOT take the |psi|^2 shortcut."""
    c = Circuit(7, num_clbits=8)
    c.h(0)
    c.h(3)
    for q in range(7):
        c.measure(q, q)
    re, im = stpu.run_statevector(c)
    got = np.asarray(stpu.outcome_probs(c, re, im))
    want = np.asarray(dense.simulate_probs(c))
    assert got.shape == want.shape == (256,)
    np.testing.assert_allclose(got, want, atol=1e-6)
