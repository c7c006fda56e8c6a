"""Multi-chip sharding on the 8-virtual-CPU-device mesh: sharded results
must equal single-device results exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qcmrf_tpu.circuits.compiler import compile_qcmrf
from qcmrf_tpu.circuits.ir import Circuit
from qcmrf_tpu.models.mrf import MRF, grid_mrf
from qcmrf_tpu.parallel import sharded
from qcmrf_tpu.sim import analytic, dense


def rand_mrf(cliques, seed=0, scale=0.4):
    rng = np.random.RandomState(seed)
    probe = MRF.create(cliques)
    return MRF.create(cliques, theta=-np.abs(rng.randn(probe.dimension)) * scale)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return sharded.make_mesh(8)


@pytest.fixture(scope="module")
def mesh4():
    return sharded.make_mesh(4)


def test_sharded_log_partition(mesh8):
    mrf = grid_mrf(4, 4)  # n=16
    rng = np.random.RandomState(1)
    mrf = mrf.with_theta(-np.abs(rng.randn(mrf.dimension)) * 0.3)
    got = float(sharded.sharded_log_partition(mrf, mesh8))
    want = float(mrf.log_partition())
    assert np.isclose(got, want, rtol=1e-5)


def test_sharded_gibbs_probs(mesh8):
    mrf = rand_mrf([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 6]], seed=2)
    got = np.asarray(sharded.sharded_gibbs_probs(mrf, mesh8))
    want = np.asarray(mrf.gibbs_probs())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)


def test_sharded_success_rate(mesh8):
    mrf = rand_mrf([[0, 1], [1, 2], [2, 3]], seed=3)
    got = float(sharded.sharded_success_rate(mrf, mesh8))
    assert np.isclose(got, float(mrf.success_rate()), rtol=1e-4)


def test_sharded_sampling_distribution(mesh8):
    mrf = rand_mrf([[0, 1], [1, 2]], seed=4)
    x, acc = sharded.sharded_sample_postselected(
        jax.random.PRNGKey(0), mrf, mesh8, 80_000
    )
    x = np.asarray(x)
    acc = np.asarray(acc)
    # acceptance rate ~ Z/2^n
    assert np.isclose(acc.mean(), float(mrf.success_rate()), atol=0.01)
    emp = np.bincount(x[acc], minlength=mrf.num_states) / acc.sum()
    np.testing.assert_allclose(emp, np.asarray(mrf.gibbs_probs()), atol=0.015)


def test_sharded_estimate_delta_fused(mesh8):
    mrf = rand_mrf([[0, 1], [1, 2]], seed=4)
    deltas = np.asarray(sharded.sharded_estimate_delta(
        jax.random.PRNGKey(1), mrf, mesh8, 40_000, 4
    ))
    assert deltas.shape == (4,)
    # each round is an independent estimate of Z/2^n
    want = float(mrf.success_rate())
    np.testing.assert_allclose(deltas, want, atol=0.02)
    # rounds are independent draws, not one repeated value
    assert len(np.unique(deltas)) > 1


def test_sharded_statevector_bell(mesh4):
    c = Circuit(4)
    c.h(3).cx(3, 0)  # entangle a *sharded* qubit (3) with a local one
    re, im = sharded.run_statevector_sharded(c, mesh4)
    st = np.asarray(re) + 1j * np.asarray(im)
    want = np.asarray(dense.run_statevector(c))
    np.testing.assert_allclose(st, want, atol=1e-6)


def test_sharded_statevector_h_wall(mesh8):
    n = 6
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    re, im = sharded.run_statevector_sharded(c, mesh8)
    np.testing.assert_allclose(
        np.asarray(re), np.full(1 << n, 2 ** (-n / 2)), atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(im), 0, atol=1e-6)


@pytest.mark.parametrize("cliques", [
    [[0, 1]],
    [[0, 1], [1, 2], [2, 3]],
    [[0, 1, 2], [2, 3, 4]],
])
def test_sharded_qcmrf_circuit(mesh4, cliques):
    """Full compiled QCMRF circuit sharded over 4 devices == dense engine."""
    mrf = rand_mrf(cliques, seed=5)
    circ = compile_qcmrf(mrf)
    probs = np.asarray(sharded.sharded_outcome_probs(circ, mesh4))
    want = np.asarray(analytic.joint_outcome_probs(mrf))
    np.testing.assert_allclose(probs, want, atol=1e-5)


def test_sharded_rz_cp_on_device_bits(mesh4):
    """Diagonal gates on sharded qubits need no communication but must
    still be correct."""
    n = 4
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    c.rz(0.7, 3)       # qubit 3 is a device bit on a 4-device mesh
    c.cp(1.1, 2, 3)    # both device bits
    re, im = sharded.run_statevector_sharded(c, mesh4)
    st = np.asarray(re) + 1j * np.asarray(im)
    want = np.asarray(dense.run_statevector(c))
    np.testing.assert_allclose(st, want, atol=1e-6)


def test_sharded_larger_than_local(mesh8):
    """n=18 grid: per-device chunk 2^15; logZ matches the kernel path."""
    mrf = grid_mrf(3, 6)
    rng = np.random.RandomState(6)
    mrf = mrf.with_theta(-np.abs(rng.randn(mrf.dimension)) * 0.2)
    got = float(sharded.sharded_log_partition(mrf, mesh8))
    want = float(mrf.log_partition())
    assert np.isclose(got, want, rtol=1e-5)


def test_sharded_general_final_permutation(mesh8):
    """Circuits whose targeted exchanges scramble the layout into a
    general permutation (>= 2 remaps) must still restore canonically
    (round-1 VERDICT item 8: no single-swap carve-out)."""
    n = 6  # dlog=3, local_n=3
    rng = np.random.RandomState(11)
    c = Circuit(n)
    # alternate non-diagonal gates between device bits and local bits so
    # Belady evictions build up a non-trivial permutation
    seq = [5, 1, 4, 0, 3, 2, 5, 4, 1, 3, 0, 2]
    for i, q in enumerate(seq):
        if i % 3 == 2:
            c.x(q)
        else:
            c.h(q)
        c.rz(float(rng.uniform(-np.pi, np.pi)), q)
    c.cx(5, 0).cx(0, 4).cx(3, 5)
    re, im = sharded.run_statevector_sharded(c, mesh8)
    assert sharded.LAST_REMAP_COUNT >= 2
    st = np.asarray(re) + 1j * np.asarray(im)
    want = np.asarray(dense.run_statevector(c))
    np.testing.assert_allclose(st, want, atol=1e-5)


def test_sharded_qcmrf_2e20_amplitudes(mesh8):
    """Gate-level sharded engine at 2^20 amplitudes (n=20 qubits: a
    10-variable chain QCMRF circuit) == dense engine (VERDICT item 2)."""
    cliques = [[i, i + 1] for i in range(9)]
    mrf = rand_mrf(cliques, seed=12, scale=0.3)
    circ = compile_qcmrf(mrf, with_measurements=False)
    assert circ.num_qubits == 20
    re, im = sharded.run_statevector_sharded(circ, mesh8)
    assert sharded.LAST_REMAP_COUNT >= 2
    probs = np.asarray(re) ** 2 + np.asarray(im) ** 2
    assert probs.shape == (1 << 20,)
    want = np.abs(np.asarray(dense.run_statevector(circ))) ** 2
    np.testing.assert_allclose(probs, want, atol=1e-6)
    # physics cross-check: accepted mass == Z / 2^n
    np.testing.assert_allclose(
        probs[: 1 << mrf.n].sum(), float(mrf.success_rate()), atol=1e-5
    )


def test_fused_plan_folds_uniform_into_first_sandwich():
    """The write-only uniform init folds INTO the head sandwich group of
    the fused sharded plan (``sandwichku``), matching the single-chip
    engine's pass count — no standalone ``init_uniform`` pass remains.
    Plan-level pin so the fold can't silently disengage (the equality
    tests above stay green either way)."""
    cliques = [[i, i + 1] for i in range(9)]
    mrf = rand_mrf(cliques, seed=12, scale=0.3)
    circ = compile_qcmrf(mrf, with_measurements=False)
    n = circ.num_qubits
    for dlog in (0, 3):
        plan, _ = sharded._plan_fused(circ, n - dlog, dlog)
        head = plan[0]
        assert head[0] == "ops" and head[1][0][0] == "sandwichku"
        kinds = [o[0] for e in plan if e[0] == "ops" for o in e[1]]
        assert "init_uniform" not in kinds


def test_statevector_executable_cache(mesh4):
    """Repeat calls with an identical gate stream hit the compiled
    executable (no re-trace) and still report the trace-time remap count;
    a different circuit misses."""
    mrf = rand_mrf([[0, 1], [1, 2]], seed=9)
    circ = compile_qcmrf(mrf)
    before = len(sharded._SV_EXEC_CACHE)
    r1 = sharded.run_statevector_sharded(circ, mesh4)
    remaps = sharded.LAST_REMAP_COUNT
    assert len(sharded._SV_EXEC_CACHE) == before + 1
    r2 = sharded.run_statevector_sharded(circ, mesh4)
    assert len(sharded._SV_EXEC_CACHE) == before + 1  # hit, no new entry
    assert sharded.LAST_REMAP_COUNT == remaps
    np.testing.assert_allclose(np.asarray(r1[0]), np.asarray(r2[0]))
    other = compile_qcmrf(rand_mrf([[0, 1, 2]], seed=9))
    sharded.run_statevector_sharded(other, mesh4)
    assert len(sharded._SV_EXEC_CACHE) == before + 2


def test_sharded_outcome_probs_permuted_wiring(mesh4):
    """Nontrivial qubit->clbit permutation: shard-side marginalization
    must equal the dense engine's outcome_probs (VERDICT round-2 item 6:
    no identity-wiring carve-out)."""
    n = 6
    c = Circuit(n, num_clbits=n)
    for q in range(n):
        c.h(q)
    c.rz(0.9, 5).cx(5, 0).cp(0.6, 4, 1).cx(2, 3)
    perm = [3, 5, 0, 4, 2, 1]  # qubit q -> clbit perm[q]
    for q in range(n):
        c.measure(q, perm[q])
    got = np.asarray(sharded.sharded_outcome_probs(c, mesh4))
    want = np.asarray(dense.outcome_probs(c, dense.run_statevector(c)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.isclose(got.sum(), 1.0, atol=1e-6)


def test_sharded_outcome_probs_measured_subset(mesh4):
    """Measuring a subset marginalizes the unmeasured qubits shard-side."""
    n = 6
    c = Circuit(n, num_clbits=3)
    for q in range(n):
        c.h(q)
    c.cx(5, 1).rz(0.4, 4)
    c.measure(5, 0).measure(1, 2).measure(3, 1)
    got = np.asarray(sharded.sharded_outcome_probs(c, mesh4))
    want = np.asarray(dense.outcome_probs(c, dense.run_statevector(c)))
    assert got.shape == (8,)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_outcome_probs_register_smaller_than_mesh(mesh4):
    """A classical register SMALLER than the device count (2 keys on a
    4-device mesh) takes the replicated-scatter branch — the ring
    reduce-scatter needs at least one key chunk per device."""
    n = 5
    c = Circuit(n, num_clbits=1)
    for q in range(n):
        c.h(q)
    c.cx(4, 2).rz(0.7, 3)
    c.measure(3, 0)
    got = np.asarray(sharded.sharded_outcome_probs(c, mesh4))
    want = np.asarray(dense.outcome_probs(c, dense.run_statevector(c)))
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_outcome_probs_identity_subset_marginalizes(mesh4):
    """Identity-wired measured SUBSET with a superposed unmeasured qubit:
    the |psi|^2 fast path would be silently wrong (it was, pre-review) —
    the stray-mass check must route this to the marginalizing path."""
    n = 5
    c = Circuit(n, num_clbits=n)
    for q in range(n):
        c.h(q)
    c.cx(4, 0)
    for q in range(n - 1):   # qubit 4 stays unmeasured AND superposed
        c.measure(q, q)
    got = np.asarray(sharded.sharded_outcome_probs(c, mesh4))
    want = np.asarray(dense.outcome_probs(c, dense.run_statevector(c)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_outcome_probs_workspace_fast_path(mesh4):
    """QCMRF-style circuit (workspace unmeasured but provably |0>) still
    takes the sharded fast path and stays exact."""
    mrf = rand_mrf([[0, 1], [1, 2]], seed=11)
    circ = compile_qcmrf(mrf)
    probs = np.asarray(sharded.sharded_outcome_probs(circ, mesh4))
    want = np.asarray(analytic.joint_outcome_probs(mrf))
    np.testing.assert_allclose(probs, want, atol=1e-5)


def test_sharded_outcome_probs_no_measurements(mesh4):
    """No measure ops at all -> raw |psi|^2 over the full register, the
    sim.dense.outcome_probs empty-pairs convention the driver dryrun's
    oracle comparison relies on (regression: the stray-mass check must
    not reroute this to the keyed path)."""
    mrf = rand_mrf([[0, 1], [1, 2]], seed=3)
    circ = compile_qcmrf(mrf, with_measurements=False)
    assert circ.measured_pairs == []
    got = np.asarray(sharded.sharded_outcome_probs(circ, mesh4))
    want = np.asarray(dense.simulate_probs(circ))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_table_slice_guard_past_int32(mesh8):
    """Per-device TABLE slices past 2^31 states must raise loudly: the
    zeroed state-unit offset would make every device compute the SAME
    slice (round-4 review finding). Only the streaming-lnZ path (block-
    unit offsets) runs at that scale."""
    mrf = rand_mrf([[i, i + 1] for i in range(33)], seed=5)  # n=34
    with pytest.raises(ValueError, match="state-unit offsets"):
        sharded.sharded_gibbs_probs(mrf, mesh8)


def test_keyed_marginalization_int32_clbit_guard(mesh8):
    """Non-identity wiring past 31 clbits must raise BEFORE running the
    statevector: int32 keys would set the sign bit and the ring
    reduce-scatter would silently drop that mass (round-4 review
    finding; replaces the removed 26-clbit replication cap)."""
    c = Circuit(num_qubits=4, num_clbits=33)
    c.h(0)
    c.measure(0, 32)  # non-identity wiring into clbit 32
    with pytest.raises(ValueError, match="31 clbits"):
        sharded.sharded_outcome_probs(c, mesh8)


def test_sharded_map_state_kernel_path(mesh8):
    """Sharded streaming MAP == single-chip streaming MAP == table argmax
    on the interpret-kernel path (local width <= 16)."""
    from qcmrf_tpu.ops import kernels

    mrf = rand_mrf([[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 8],
                    [8, 9, 10], [10, 11, 12], [12, 13]], seed=9,
                   scale=0.6)  # n=14, dlog=3 -> local 11 (kernel path)
    want_id, want_val = kernels.map_state_streaming(mrf)
    got_id, got_val = sharded.sharded_map_state(mrf, mesh8)
    assert got_id == want_id
    assert abs(got_val - want_val) < 1e-4


def test_sharded_map_state_table_fallback(mesh8):
    """Sharded streaming MAP on the table-fallback path (local width
    past the CPU kernel gate) still reconstructs the global id."""
    mrf = rand_mrf([[i, i + 1] for i in range(19)], seed=10,
                   scale=0.6)  # n=20, dlog=3 -> local 17 (fallback)
    lp = np.asarray(mrf.beta * mrf.all_log_potentials())
    got_id, got_val = sharded.sharded_map_state(mrf, mesh8)
    assert got_id == int(np.argmax(lp))
    assert abs(got_val - float(lp.max())) < 1e-4


def test_sharded_map_state_tiny_shards(mesh8):
    """Shards smaller than one 128-lane row (chunk < 128) must still
    reconstruct the global id (the fallback's (device, row, lane)
    encoding cannot assume chunk is a multiple of 128)."""
    mrf = rand_mrf([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]], seed=11,
                   scale=0.6)  # n=6, dlog=3 -> chunk=8
    lp = np.asarray(mrf.beta * mrf.all_log_potentials())
    got_id, got_val = sharded.sharded_map_state(mrf, mesh8)
    assert got_id == int(np.argmax(lp))
    assert abs(got_val - float(lp.max())) < 1e-5


def test_sharded_clique_moments(mesh8):
    """Sharded streaming moment sweep == elimination marginals ==
    single-device streaming sweep (one block per device: n - dlog <=
    chunk bits)."""
    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.models import moments

    mrf = rand_mrf([[0, 1, 2], [2, 3], [3, 4, 5], [0, 5], [1, 4]],
                   seed=11, scale=0.7)  # n=6
    got = np.asarray(sharded.sharded_clique_moments(mrf, mesh8))
    want = np.asarray(ve.clique_marginals(mrf))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    single = np.asarray(moments.clique_moments_streaming(mrf))
    # not bit-identical: the mesh path partitions the lane accumulators
    # per device (L = chunk/2^dlog) and psums, the single path keeps one
    # global lane set — same algorithm, different f32 summation order
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-7)


def test_sharded_clique_moments_scan_path(mesh8, monkeypatch):
    """Multiple blocks per device (forced tiny chunks) exercise the
    per-device lax.scan with global block offsets."""
    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.models import moments

    monkeypatch.setattr(moments, "_CHUNK_BITS", 3)
    mrf = rand_mrf([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 6],
                    [6, 7], [7, 8], [0, 8]], seed=12, scale=0.5)  # n=9
    got = np.asarray(sharded.sharded_clique_moments(mrf, mesh8))
    want = np.asarray(ve.clique_marginals(mrf))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_sharded_streaming_lnZ_grad(mesh8):
    """value_and_grad through the mesh-sharded streaming lnZ == autodiff
    through the 2^n table (the multi-chip exact-MLE gradient)."""
    from qcmrf_tpu.models import moments

    mrf = rand_mrf([[0, 1, 2], [2, 3], [3, 4, 0]], seed=13, scale=0.6)

    def stream(theta):
        return moments.log_partition_streaming(
            mrf.with_theta(theta), mesh=mesh8
        )

    def table(theta):
        return mrf.with_theta(theta).log_partition()

    v_got, g_got = jax.value_and_grad(stream)(mrf.theta)
    v_want, g_want = jax.value_and_grad(table)(mrf.theta)
    assert np.isclose(float(v_got), float(v_want), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(g_got), np.asarray(g_want), rtol=1e-4, atol=1e-6
    )


def test_multi_axis_mesh_flattened():
    """A multi-axis mesh (the train CLI's 2-D (amp, data) shape) must
    give the same sharded sweep results as a 1-D mesh over the same
    devices: entry points flatten it internally (_sweep_mesh). Passed
    through raw, slices were sized by the TOTAL device count while
    offsets/seeds used only axis 0's index — lnZ came back silently
    wrong (a fraction of the state space swept; round-4 review)."""
    from jax.sharding import Mesh
    from qcmrf_tpu.models import moments
    from qcmrf_tpu.models import elimination as ve

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh2d = Mesh(devs, ("amp", "data"))
    mrf = rand_mrf([[0, 1, 2], [2, 3], [3, 4, 5], [0, 5]], seed=17,
                   scale=0.6)

    lnZ = float(sharded.sharded_log_partition(mrf, mesh2d))
    assert np.isclose(lnZ, float(mrf.log_partition()), rtol=1e-5)

    mu = np.asarray(sharded.sharded_clique_moments(mrf, mesh2d))
    np.testing.assert_allclose(
        mu, np.asarray(ve.clique_marginals(mrf)), rtol=1e-5, atol=1e-7)

    sid, val = sharded.sharded_map_state(mrf, mesh2d)
    sid1, val1 = sharded.sharded_map_state(mrf, sharded.make_mesh(8))
    assert sid == sid1 and np.isclose(val, val1)

    # the differentiable route the CLI's wide --mesh path takes
    v = float(moments.log_partition_streaming(mrf, mesh=mesh2d))
    assert np.isclose(v, float(mrf.log_partition()), rtol=1e-5)


def test_sharded_clique_moments_gram_kernel_path(mesh8):
    """A pairwise model over the 8-device mesh: each device sweeps its
    slice with the weighted-Gram sweep (device bits arrive through the
    block index) and one psum combines the monomial partials. Must match
    elimination and the single-device sweep."""
    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.models import moments

    cl = [[i, (i + 1) % 12] for i in range(12)] + [[0, 6]]
    mrf = rand_mrf(cl, seed=19, scale=0.5)

    got = np.asarray(sharded.sharded_clique_moments(mrf, mesh8))
    np.testing.assert_allclose(
        got, np.asarray(ve.clique_marginals(mrf)), rtol=1e-5, atol=1e-6)
    single = np.asarray(moments.clique_moments_streaming(mrf))
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)


def test_sharded_fused_lnz_and_moments(mesh8):
    """The sharded (lnZ, moments) pair must match the references and the
    single-device pair; the sharded lnZ gradient must route through
    it."""
    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.models import moments
    from qcmrf_tpu.ops import kernels as K

    cl = [[i, (i + 1) % 12] for i in range(12)] + [[0, 6], [3, 9]]
    mrf = rand_mrf(cl, seed=23, scale=0.6)

    lnZ, mu = sharded.sharded_lnz_and_moments(mrf, mesh8)
    assert np.isclose(float(lnZ), float(K.log_partition(mrf)), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(mu), np.asarray(ve.clique_marginals(mrf)),
        rtol=1e-5, atol=1e-6)

    lnZ_1, mu_1 = moments.lnz_and_moments_streaming(mrf)
    assert np.isclose(float(lnZ), float(lnZ_1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mu), np.asarray(mu_1),
                               rtol=1e-5, atol=1e-6)

    g = jax.grad(
        lambda th: moments.log_partition_streaming(
            mrf.with_theta(th), mesh8)
    )(mrf.theta)
    np.testing.assert_allclose(
        np.asarray(g), mrf.beta * np.asarray(mu), rtol=1e-5, atol=1e-6)

    # size-3 cliques: product columns beside the Gram entries
    cl3 = [[i, (i + 1) % 12] for i in range(12)] + [[0, 4, 8], [1, 5, 9]]
    mrf3 = rand_mrf(cl3, seed=24, scale=0.5)
    assert len(moments._gram_layout(mrf3.cliques).hi_cols) > 0
    lnZ3, mu3 = sharded.sharded_lnz_and_moments(mrf3, mesh8)
    assert np.isclose(float(lnZ3), float(K.log_partition(mrf3)),
                      rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(mu3), np.asarray(ve.clique_marginals(mrf3)),
        rtol=1e-5, atol=1e-6)

    # > 4 distinct vars in one clique: same API
    mrf5 = rand_mrf([[0, 1, 2, 3, 4], [4, 5], [5, 6]], seed=25)
    lnZ5, mu5 = sharded.sharded_lnz_and_moments(mrf5, mesh8)
    assert np.isclose(float(lnZ5), float(mrf5.log_partition()), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(mu5), np.asarray(ve.clique_marginals(mrf5)),
        rtol=1e-5, atol=1e-6)


def test_sharded_clamped_conditional(mesh8):
    """Evidence-clamped mass and conditionals with the free-variable
    sweep sharded over the mesh must match the single-chip values."""
    from qcmrf_tpu.models import elimination as ve
    from qcmrf_tpu.models import moments

    mrf = rand_mrf([[i, i + 1] for i in range(12)] + [[0, 5, 9]],
                   seed=28, scale=0.5)
    ev = {0: 1, 5: 0}
    got = float(moments.log_partition_clamped_streaming(mrf, ev, mesh8))
    assert np.isclose(got, float(ve.log_partition_clamped(mrf, ev)),
                      rtol=1e-6)
    p = float(moments.conditional_prob_streaming(mrf, 3, 1, ev, mesh8))
    assert np.isclose(p, float(ve.conditional_prob(mrf, 3, 1, ev)),
                      rtol=1e-5)


def test_sharded_clamped_map_and_sampling(mesh8):
    """Evidence-constrained MAP and conditional PAM with the reduced
    model's sweep sharded over the mesh are bit-identical to the
    single-chip paths."""
    from qcmrf_tpu.models import sample as msample

    mrf = rand_mrf([[i, i + 1] for i in range(12)] + [[0, 5, 9]],
                   seed=28, scale=0.5)
    ev = {0: 1, 5: 0}
    sid, sval = msample.map_state_clamped(mrf, ev)
    gid, gval = msample.map_state_clamped(mrf, ev, mesh8)
    assert gid == sid and np.isclose(gval, sval, rtol=1e-5)

    key = jax.random.PRNGKey(11)
    single = np.asarray(msample.sample_conditional(
        key, mrf, 4, ev, method="pam"))
    got = np.asarray(msample.sample_conditional(
        key, mrf, 4, ev, method="pam", mesh=mesh8))
    np.testing.assert_array_equal(got, single)


def test_sharded_sample_pam(mesh8):
    """Sharded perturb-and-MAP: keys replicate so every device perturbs
    identically and sweeps its slice; samples must be bit-identical to
    the single-chip streaming sampler (kernel path) and to the table
    sampler (small-chunk fallback path)."""
    from qcmrf_tpu.models import sample as msample

    cl = [[i, i + 1] for i in range(13)] + [[0, 6], [3, 10]]
    mrf = rand_mrf(cl, seed=26, scale=0.6)
    key = jax.random.PRNGKey(9)
    single = np.asarray(msample.sample_pam_streaming(key, mrf, 5))
    got = np.asarray(sharded.sharded_sample_pam(key, mrf, mesh8, 5))
    np.testing.assert_array_equal(got, single)

    small = rand_mrf([[i, i + 1] for i in range(8)], seed=27)  # n=9
    ids = np.asarray(msample.sample_pam(key, small, 10), np.int64)
    ref = (ids[:, None] >> (small.n - 1 - np.arange(small.n))) & 1
    np.testing.assert_array_equal(
        np.asarray(sharded.sharded_sample_pam(key, small, mesh8, 10)),
        ref)
