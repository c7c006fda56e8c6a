"""Cross-engine fuzz: random circuits must agree across every engine.

The strongest correctness statement in the suite: arbitrary gate sequences
(not just QCMRF-shaped) through the dense complex engine, the basis-gate
lowering, the real/imag-plane engine, and the sharded
engine (4-device mesh) all produce the same statevector.
"""

import numpy as np
import pytest

from qcmrf_tpu.circuits.ir import Circuit
from qcmrf_tpu.circuits.lower import lower
from qcmrf_tpu.parallel import sharded
from qcmrf_tpu.sim import dense
from qcmrf_tpu.sim import tpu as stpu


def random_circuit(rng, n, depth, allow_flags=True):
    c = Circuit(n)
    for _ in range(depth):
        kind = rng.randint(0, 8 if allow_flags else 7)
        if kind == 0:
            c.h(rng.randint(n))
        elif kind == 1:
            c.x(rng.randint(n))
        elif kind == 2:
            c.sx(rng.randint(n))
        elif kind == 3:
            c.rz(float(rng.uniform(-np.pi, np.pi)), rng.randint(n))
        elif kind == 4:
            a, b = rng.choice(n, 2, replace=False)
            c.cx(int(a), int(b))
        elif kind == 5:
            a, b = rng.choice(n, 2, replace=False)
            c.cp(float(rng.uniform(-np.pi, np.pi)), int(a), int(b))
        elif kind == 6:
            c.sxdg(rng.randint(n))
        else:
            m = rng.randint(1, min(3, n - 1) + 1)
            qs = rng.choice(n, m + 1, replace=False)
            flags = [int(f) * 2 - 1 for f in rng.randint(0, 2, m)]
            c.flags_phase([int(q) for q in qs[:m]], flags,
                          float(rng.uniform(-np.pi, np.pi)), int(qs[m]))
    return c


@pytest.mark.parametrize("seed", range(6))
def test_lowered_matches_dense_random(seed):
    rng = np.random.RandomState(seed)
    c = random_circuit(rng, n=5, depth=25)
    st = np.asarray(dense.run_statevector(c))
    st_low = np.asarray(dense.run_statevector(lower(c, style="fused")))
    np.testing.assert_allclose(st_low, st, atol=5e-5)


@pytest.mark.parametrize("seed", range(6))
def test_plane_engine_matches_dense_random(seed):
    rng = np.random.RandomState(100 + seed)
    c = random_circuit(rng, n=8, depth=30)
    st = np.asarray(dense.run_statevector(c))
    re, im = stpu.run_statevector(c)
    got = np.asarray(re).reshape(-1) + 1j * np.asarray(im).reshape(-1)
    np.testing.assert_allclose(got, st, atol=5e-5)


@pytest.mark.parametrize("seed", range(4))
def test_sharded_matches_dense_random(seed):
    rng = np.random.RandomState(200 + seed)
    c = random_circuit(rng, n=6, depth=25)
    st = np.asarray(dense.run_statevector(c))
    mesh = sharded.make_mesh(4)
    re, im = sharded.run_statevector_sharded(c, mesh)
    got = np.asarray(re) + 1j * np.asarray(im)
    np.testing.assert_allclose(got, st, atol=5e-5)


@pytest.mark.parametrize("seed", range(4))
def test_sharded_fused_matches_dense_random(seed):
    """n=12 on a 4-device mesh: local_n=10 engages the FUSED shard-local
    path (plane kernels + symbolic device-bit angles + exchange planning)
    on arbitrary gate streams, including device-bit diagonal conditions,
    device-bit sandwich ancillas, and non-trivial final permutations."""
    rng = np.random.RandomState(300 + seed)
    c = random_circuit(rng, n=12, depth=40)
    st = np.asarray(dense.run_statevector(c))
    mesh = sharded.make_mesh(4)
    re, im = sharded.run_statevector_sharded(c, mesh)
    got = np.asarray(re) + 1j * np.asarray(im)
    np.testing.assert_allclose(got, st, atol=5e-5)


def test_sharded_fused_qcmrf_matches_analytic():
    """QCMRF circuit wide enough for the fused sharded path (n=14 qubits,
    local_n=11 on mesh4): outcome probabilities == the closed-form law,
    exercising sandwich fusion across device-bit ancillas end to end."""
    from qcmrf_tpu.circuits.compiler import compile_qcmrf
    from qcmrf_tpu.models.mrf import MRF
    from qcmrf_tpu.sim import analytic

    rng = np.random.RandomState(42)
    probe = MRF.create([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 6]])
    mrf = MRF.create(
        probe.cliques,
        theta=-np.abs(rng.randn(probe.dimension)) * 0.35,
    )
    circ = compile_qcmrf(mrf)
    assert circ.num_qubits == 14
    mesh = sharded.make_mesh(4)
    got = np.asarray(sharded.sharded_outcome_probs(circ, mesh))
    want = np.asarray(analytic.joint_outcome_probs(mrf))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_norm_preserved_deep_circuit():
    rng = np.random.RandomState(7)
    c = random_circuit(rng, n=7, depth=120)
    st = np.asarray(dense.run_statevector(c))
    assert np.isclose(np.vdot(st, st).real, 1.0, atol=1e-4)
