"""The real/imag plane engine (sim.tpu) vs the dense complex engine."""

import numpy as np
import pytest

import jax.numpy as jnp

from qcmrf_tpu.circuits.compiler import compile_qcmrf
from qcmrf_tpu.circuits.ir import Circuit
from qcmrf_tpu.circuits.lower import lower
from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.sim import dense
from qcmrf_tpu.sim import tpu as stpu


def to_complex(re, im):
    return np.asarray(re).reshape(-1) + 1j * np.asarray(im).reshape(-1)


def rand_mrf(cliques, seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    probe = MRF.create(cliques)
    return MRF.create(cliques, theta=-np.abs(rng.randn(probe.dimension)) * scale)


def test_basic_gate_sequence():
    c = Circuit(7)
    c.h(0).h(3).h(6).x(1).sx(2).rz(0.4, 0).cp(0.9, 3, 6).cx(0, 5).sxdg(2)
    got = to_complex(*stpu.run_statevector(c))
    want = np.asarray(dense.run_statevector(c))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cx_all_positions():
    for c_q, t_q in [(0, 6), (6, 0), (3, 4)]:
        c = Circuit(7)
        c.h(c_q).cx(c_q, t_q)
        got = to_complex(*stpu.run_statevector(c))
        want = np.asarray(dense.run_statevector(c))
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("cliques", [
    [[0, 1], [1, 2], [2, 3]],      # width 8
    [[0, 1, 2], [2, 3, 4]],        # width 8
    [[0, 1], [1, 2], [2, 3], [3, 4]],  # width 10
])
def test_qcmrf_circuit_probs(cliques):
    mrf = rand_mrf(cliques, seed=3)
    circ = compile_qcmrf(mrf)
    got = np.asarray(stpu.simulate_probs(circ))
    want = np.asarray(dense.simulate_probs(circ))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_lowered_circuit_runs_on_plane_engine():
    """Basis-gate circuits (cx/rz/sx/x) also run on the plane engine."""
    mrf = rand_mrf([[0, 1], [1, 2], [2, 3]], seed=5)
    circ = lower(compile_qcmrf(mrf), style="fused")
    got = np.asarray(stpu.simulate_probs(circ))
    want = np.asarray(dense.simulate_probs(circ))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_small_circuit_rejected():
    c = Circuit(3)
    c.h(0)
    with pytest.raises(ValueError):
        stpu.run_statevector(c)


@pytest.mark.parametrize("q", [0, 3, 6])
def test_lane_qubit_butterflies_match_dense(q):
    """Gates on the low (lane) qubits are strided butterflies like any
    other qubit: a composed 1q gate and an adjacent pair, checked
    against the dense engine at three qubit positions."""
    from qcmrf_tpu.ops import kernels as K

    rng = np.random.RandomState(11 + q)
    nq = 9
    vec = rng.randn(1 << nq) + 1j * rng.randn(1 << nq)
    vec = (vec / np.linalg.norm(vec)).astype(np.complex64)
    re = jnp.asarray(vec.real.reshape(-1, 128))
    im = jnp.asarray(vec.imag.reshape(-1, 128))
    U = np.asarray(dense.GATES_1Q["sx"] @ dense.GATES_1Q["h"])
    r, i = K.apply_1q(re, im, U, q, nq)
    want = dense.apply_1q(jnp.asarray(vec), U, q, nq)
    np.testing.assert_allclose(to_complex(r, i), np.asarray(want),
                               atol=1e-5)
    U4 = np.kron(dense.GATES_1Q["h"], dense.GATES_1Q["sx"])
    r, i = K.apply_2q_row_pair(re, im, U4, q)
    want = dense.apply_2q(jnp.asarray(vec), U4, q + 1, q, nq)
    np.testing.assert_allclose(to_complex(r, i), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("qubits,kinds", [
    ((0, 1, 2, 3), ["2q", "2q"]),
    ((0, 1, 2, 3, 4), ["lane"]),
    ((0, 2, 3, 4, 5, 6, 1, 0), ["lane"]),
])
def test_low_qubit_runs_pick_passes_or_lane_dot(qubits, kinds):
    """A run of 1q gates on the low qubits stays strided passes up to
    four qubits and becomes one 128x128 dot from five on (the measured
    crossover); both match the dense engine."""
    c = Circuit(9)
    for q in qubits:
        c.sx(q)
    c.rz(0.3, 8)
    ops = stpu.fuse_ops(c)
    assert [o[0] for o in ops[:-1]] == kinds and ops[-1][0] == "diag"
    got = to_complex(*stpu.run_statevector(c))
    want = np.asarray(dense.run_statevector(c))
    np.testing.assert_allclose(got, want, atol=1e-5)


# --------------------------------------------------------------------------
# H·D·H sandwich fusion (one pass per clique block)
# --------------------------------------------------------------------------


def test_fuse_ops_emits_sandwiches():
    """The H wall folds into one closed-form init, clique blocks
    collapse to ONE sandwich op each, runs of ADJACENT-ancilla
    sandwiches group into one multi op (up to kernels._MAX_SANDWICH_K
    ancillas), and the leading group absorbs the uniform init as a
    write-only sandwichku, which later adjacent groups join."""
    mrf = rand_mrf([[i, i + 1] for i in range(6)], seed=1)  # width 15
    ops = stpu.fuse_ops(compile_qcmrf(mrf, with_measurements=False))
    kinds = [o[0] for o in ops]
    # variable H wall (qubits 0..6) -> closed-form uniform init, folded
    # INTO the single 6-ancilla group: the WHOLE circuit is one
    # write-only pass
    assert kinds == ["sandwichku"] and ops[0][1] == tuple(range(7))
    assert len(ops[0][3]) == 6  # all 6 clique profiles in one group

    # width 10: ancillas sit at qubits 6..9 — all four join the fold
    mrf10 = rand_mrf([[0, 1], [1, 2], [2, 3], [3, 4]], seed=2)
    ops10 = stpu.fuse_ops(compile_qcmrf(mrf10, with_measurements=False))
    assert [o[0] for o in ops10] == ["sandwichku"]
    assert ops10[0][2] == 6 and len(ops10[0][3]) == 4

    # more cliques than one read-write group holds: the groups after the
    # first join the write-only fold instead of costing passes of their own
    k = stpu.K._MAX_SANDWICH_K
    chain = rand_mrf([[i, i + 1] for i in range(k + 2)], seed=3)
    opsk = stpu.fuse_ops(compile_qcmrf(chain, with_measurements=False))
    assert [o[0] for o in opsk] == ["sandwichku"]
    assert len(opsk[0][3]) == k + 2


def test_sandwich_kernel_general_profiles():
    """apply_hdh_sandwich vs brute-force H·D·H, including mu != 0 (the
    general unmatched-profile case fuse_ops never emits for QCMRF)."""
    from qcmrf_tpu.ops import kernels as K

    rng = np.random.RandomState(7)
    nq = 9
    size = 1 << nq
    anc = 7
    re = jnp.asarray(rng.randn(size // 128, 128).astype(np.float32))
    im = jnp.asarray(rng.randn(size // 128, 128).astype(np.float32))

    nu_terms = (((0, 1), (3, 0)), ((1, 1),))
    nu_angles = (0.7, -0.4)
    mu_terms = (((2, 1),),)
    mu_angles = (0.3,)
    nu_base, mu_base = 0.2, -0.1

    got_re, got_im = K.apply_hdh_sandwich(
        re, im, anc, nu_terms, nu_angles, nu_base,
        mu_terms, mu_angles, mu_base,
    )
    got = to_complex(got_re, got_im)

    # brute force: psi' = H_anc D H_anc psi with per-state phases
    psi = np.asarray(re).reshape(-1) + 1j * np.asarray(im).reshape(-1)
    x = np.arange(size)

    def prof(terms, angles, base):
        a = np.full(size, base)
        for conds, t in zip(terms, angles):
            m = np.ones(size)
            for p, w in conds:
                b = (x >> p) & 1
                m = m * (b if w else 1 - b)
            a = a + t * m
        return a

    mu = prof(mu_terms, mu_angles, mu_base)
    nu = prof(nu_terms, nu_angles, nu_base)
    alpha, beta = mu - nu, mu + nu
    want = psi.copy()

    def apply_h(v):  # Hadamard on the anc qubit
        v = v.reshape(-1, 2 << anc)
        lo, hi = v[:, : 1 << anc], v[:, 1 << anc:]
        return np.concatenate(
            [(lo + hi) / np.sqrt(2), (lo - hi) / np.sqrt(2)], axis=1
        ).reshape(-1)

    want = apply_h(want)
    d = np.where((x >> anc) & 1, np.exp(1j * beta), np.exp(1j * alpha))
    want = want * d
    want = apply_h(want)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sandwich_pair_kernel_matches_sequential():
    """apply_hdh_sandwich_pair == two sequential apply_hdh_sandwich
    passes (each already pinned against brute force above), including a
    combined mu != 0 profile split arbitrarily between the two."""
    from qcmrf_tpu.ops import kernels as K

    rng = np.random.RandomState(8)
    nq = 10
    size = 1 << nq
    a_lo = 7
    re = jnp.asarray(rng.randn(size // 128, 128).astype(np.float32))
    im = jnp.asarray(rng.randn(size // 128, 128).astype(np.float32))

    nu1_terms, nu1_angles, nu1_base = (((0, 1),), ((2, 0), (4, 1))), \
        (0.7, -0.3), 0.15
    nu2_terms, nu2_angles, nu2_base = (((1, 1), (3, 1)),), (-0.9,), 0.0
    mu1_terms, mu1_angles, mu1_base = (((5, 1),),), (0.4,), -0.2
    mu2_terms, mu2_angles, mu2_base = (((0, 0),),), (-0.6,), 0.1

    r1, i1 = K.apply_hdh_sandwich(
        re, im, a_lo, nu1_terms, nu1_angles, nu1_base,
        mu1_terms, mu1_angles, mu1_base,
    )
    r1, i1 = K.apply_hdh_sandwich(
        r1, i1, a_lo + 1, nu2_terms, nu2_angles, nu2_base,
        mu2_terms, mu2_angles, mu2_base,
    )
    want = to_complex(r1, i1)

    r2, i2 = K.apply_hdh_sandwich_pair(
        re, im, a_lo,
        nu1_terms, nu1_angles, nu1_base,
        nu2_terms, nu2_angles, nu2_base,
        mu1_terms + mu2_terms, mu1_angles + mu2_angles,
        mu1_base + mu2_base,
    )
    got = to_complex(r2, i2)
    np.testing.assert_allclose(got, want, atol=1e-5)

    # no-mu specialization (the QCMRF case)
    r3, i3 = K.apply_hdh_sandwich(re, im, a_lo, nu1_terms, nu1_angles,
                                  nu1_base)
    r3, i3 = K.apply_hdh_sandwich(r3, i3, a_lo + 1, nu2_terms, nu2_angles,
                                  nu2_base)
    r4, i4 = K.apply_hdh_sandwich_pair(
        re, im, a_lo, nu1_terms, nu1_angles, nu1_base,
        nu2_terms, nu2_angles, nu2_base,
    )
    np.testing.assert_allclose(to_complex(r4, i4), to_complex(r3, i3),
                               atol=1e-5)


def test_sandwich_quad_kernel_matches_sequential():
    """apply_hdh_sandwich_quad == four sequential apply_hdh_sandwich
    passes (each already pinned against brute force above), including a
    combined mu != 0 profile."""
    from qcmrf_tpu.ops import kernels as K

    rng = np.random.RandomState(9)
    nq = 12
    size = 1 << nq
    a_lo = 7  # quad spans row qubits 7..10
    re = jnp.asarray(rng.randn(size // 128, 128).astype(np.float32))
    im = jnp.asarray(rng.randn(size // 128, 128).astype(np.float32))

    nu_terms4 = (
        (((0, 1),), ((2, 0), (4, 1))),
        (((1, 1), (3, 1)),),
        (((5, 0),), ((6, 1),)),
        (((11, 1), (0, 0)),),
    )
    nu_angles4 = ((0.7, -0.3), (-0.9,), (0.25, 1.1), (0.6,))
    nu_bases4 = (0.15, 0.0, -0.4, 0.05)
    mu_terms, mu_angles, mu_base = (((5, 1),), ((2, 1),)), (0.4, -0.7), -0.2

    r1, i1 = re, im
    for k in range(4):
        r1, i1 = K.apply_hdh_sandwich(
            r1, i1, a_lo + k, nu_terms4[k], nu_angles4[k], nu_bases4[k]
        )
    # the shared mu phase commutes with every Rx: apply it once via a
    # zero-nu sandwich on an untouched ancilla
    r1, i1 = K.apply_hdh_sandwich(
        r1, i1, a_lo, (), (), 0.0, mu_terms, mu_angles, mu_base
    )
    want = to_complex(r1, i1)

    r2, i2 = K.apply_hdh_sandwich_quad(
        re, im, a_lo, nu_terms4, nu_angles4, nu_bases4,
        mu_terms, mu_angles, mu_base,
    )
    np.testing.assert_allclose(to_complex(r2, i2), want, atol=1e-5)

    # no-mu specialization (the QCMRF case)
    r3, i3 = re, im
    for k in range(4):
        r3, i3 = K.apply_hdh_sandwich(
            r3, i3, a_lo + k, nu_terms4[k], nu_angles4[k], nu_bases4[k]
        )
    r4, i4 = K.apply_hdh_sandwich_quad(
        re, im, a_lo, nu_terms4, nu_angles4, nu_bases4
    )
    np.testing.assert_allclose(to_complex(r4, i4), to_complex(r3, i3),
                               atol=1e-5)


def test_uniform_quad_fusion_matches_dense():
    """The write-only uniform-init + first-group fusion (sandwichku)
    produces the identical statevector to the dense complex engine, and
    fuse_ops actually emits it for a >= 4-clique chain."""
    mrf = rand_mrf([[i, i + 1] for i in range(5)], seed=7)  # width 13
    circ = compile_qcmrf(mrf, with_measurements=False)
    ops = stpu.fuse_ops(circ)
    assert ops[0][0] == "sandwichku"
    got = to_complex(*stpu.run_statevector(circ))
    want = np.asarray(dense.run_statevector(circ))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sandwich_matches_unfused_statevector():
    """The fused engine (sandwiches on) equals a gate-by-gate unfused
    application for a full QCMRF circuit with mixed clique sizes."""
    mrf = rand_mrf([[0, 1, 2], [2, 3], [3, 4, 5, 6]], seed=4)
    circ = compile_qcmrf(mrf, with_measurements=False)
    re, im = stpu.zero_planes(circ.num_qubits)
    for g in circ.gates:
        re, im = stpu.apply_gate(re, im, g, circ.num_qubits)
    want = to_complex(re, im)
    got = to_complex(*stpu.run_statevector(circ))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.gpu
def test_plane_engine_on_card(gpu):
    """On the card the plane passes compile for the GPU and the engine
    matches the dense complex engine, as chip_smoke's gate phase does at
    full width."""
    import jax

    assert jax.default_backend() == "gpu"
    mrf = rand_mrf([[i, i + 1] for i in range(9)], seed=5)
    circ = compile_qcmrf(mrf, with_measurements=False)
    got = np.asarray(stpu.simulate_probs(circ))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(dense.simulate_probs(circ))
    np.testing.assert_allclose(got, want, atol=1e-6)
