"""Sweeps and plane passes vs the reference implementations."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qcmrf_tpu.models.mrf import MRF, grid_mrf
from qcmrf_tpu.ops import kernels
from qcmrf_tpu.sim import dense


def rand_mrf(cliques, seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    probe = MRF.create(cliques)
    return MRF.create(cliques, theta=-np.abs(rng.randn(probe.dimension)) * scale)


def test_logpot_kernel_matches_jnp_small_grid():
    mrf = grid_mrf(3, 4, beta=1.0)  # n=12 -> kernel path
    rng = np.random.RandomState(1)
    mrf = mrf.with_theta(-np.abs(rng.randn(mrf.dimension)))
    got = np.asarray(kernels.all_log_potentials(mrf))
    want = np.asarray(mrf.beta * mrf.all_log_potentials())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_logpot_kernel_beta():
    mrf = grid_mrf(3, 4, beta=2.5)
    rng = np.random.RandomState(2)
    mrf = mrf.with_theta(-np.abs(rng.randn(mrf.dimension)))
    got = np.asarray(kernels.all_log_potentials(mrf))
    want = 2.5 * np.asarray(mrf.all_log_potentials())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_logpot_small_n_fallback():
    mrf = rand_mrf([[0, 1], [1, 2]], seed=3)
    got = np.asarray(kernels.all_log_potentials(mrf))
    want = np.asarray(mrf.beta * mrf.all_log_potentials())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gibbs_probs_kernel():
    mrf = grid_mrf(2, 6)
    rng = np.random.RandomState(4)
    mrf = mrf.with_theta(-np.abs(rng.randn(mrf.dimension)) * 0.4)
    got = np.asarray(kernels.gibbs_probs(mrf))
    want = np.asarray(mrf.gibbs_probs())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert np.isclose(got.sum(), 1.0, atol=1e-5)
    assert np.isclose(
        float(kernels.log_partition(mrf)), float(mrf.log_partition()),
        rtol=1e-5,
    )


def test_postselected_amplitudes_kernel():
    mrf = grid_mrf(3, 4)
    rng = np.random.RandomState(5)
    mrf = mrf.with_theta(-np.abs(rng.randn(mrf.dimension)) * 0.3)
    amps = np.asarray(kernels.postselected_amplitudes(mrf))
    # |amp|^2 renormalized = Gibbs; sum |amp|^2 = Z/2^n = success rate
    p = amps ** 2
    np.testing.assert_allclose(
        p / p.sum(), np.asarray(mrf.gibbs_probs()), rtol=1e-4, atol=1e-8
    )
    assert np.isclose(p.sum(), float(mrf.success_rate()), rtol=1e-4)


def plane_state(n):
    """Zero state as (rows, 128) planes."""
    re = np.zeros((1 << n) // 128 * 128, dtype=np.float32)
    re[0] = 1.0
    re = re.reshape(-1, 128)
    return jnp.asarray(re), jnp.zeros_like(jnp.asarray(re))


@pytest.mark.parametrize("q", [0, 3, 6, 7, 9])
def test_apply_1q_matches_dense(q):
    n = 10
    rng = np.random.RandomState(6)
    # random normalized complex state
    vec = rng.randn(1 << n) + 1j * rng.randn(1 << n)
    vec = (vec / np.linalg.norm(vec)).astype(np.complex64)
    re = jnp.asarray(vec.real.reshape(-1, 128))
    im = jnp.asarray(vec.imag.reshape(-1, 128))
    U = dense.GATES_1Q["h"]
    gre, gim = kernels.apply_1q(re, im, U, q, n)
    got = np.asarray(gre).reshape(-1) + 1j * np.asarray(gim).reshape(-1)
    want = np.asarray(dense.apply_1q(jnp.asarray(vec), U, q, n))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("q", [2, 8])
def test_apply_1q_complex_gate(q):
    n = 9
    rng = np.random.RandomState(7)
    vec = rng.randn(1 << n) + 1j * rng.randn(1 << n)
    vec = (vec / np.linalg.norm(vec)).astype(np.complex64)
    re = jnp.asarray(vec.real.reshape(-1, 128))
    im = jnp.asarray(vec.imag.reshape(-1, 128))
    U = dense.GATES_1Q["sx"]  # complex entries
    gre, gim = kernels.apply_1q(re, im, U, q, n)
    got = np.asarray(gre).reshape(-1) + 1j * np.asarray(gim).reshape(-1)
    want = np.asarray(dense.apply_1q(jnp.asarray(vec), U, q, n))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_hadamard_wall_uniform():
    n = 8
    re, im = plane_state(n)
    H = dense.GATES_1Q["h"]
    for q in range(n):
        re, im = kernels.apply_1q(re, im, H, q, n)
    got = np.asarray(re).reshape(-1)
    np.testing.assert_allclose(got, np.full(1 << n, 2 ** (-n / 2)),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(im).reshape(-1), 0, atol=1e-6)


def test_log_potentials_fast_matches_reference():
    from qcmrf_tpu.sim.analytic import log_potentials_fast

    mrf = grid_mrf(3, 4, beta=1.7)
    rng2 = np.random.RandomState(9)
    mrf = mrf.with_theta(-np.abs(rng2.randn(mrf.dimension)))
    x = jnp.arange(mrf.num_states, dtype=jnp.int32)
    got = np.asarray(log_potentials_fast(mrf, x))
    want = 1.7 * np.asarray(mrf.all_log_potentials())
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # higher-order cliques too
    m2 = MRF.create([[0, 1, 2], [2, 3, 4], [4, 5, 6, 7], [7, 8]])
    rng3 = np.random.RandomState(10)
    m2 = m2.with_theta(-np.abs(rng3.randn(m2.dimension)))
    x2 = jnp.arange(m2.num_states, dtype=jnp.int32)
    got2 = np.asarray(log_potentials_fast(m2, x2))
    want2 = np.asarray(m2.beta * m2.all_log_potentials())
    np.testing.assert_allclose(got2, want2, rtol=2e-4, atol=2e-4)


def test_log_partition_fused_streaming():
    """The streaming logsumexp kernel (no materialized table; the
    large-table path of kernels.log_partition) agrees with the two-pass
    table path. Exercised directly so the CPU suite covers it even though
    the size cutoff would route these n to the table path."""
    import jax
    import jax.numpy as jnp

    for g, scale in ((grid_mrf(3, 4), 0.2), (grid_mrf(4, 4), 0.35)):
        rng = np.random.RandomState(7)
        m = g.with_theta(jnp.asarray(
            -np.abs(rng.randn(g.dimension)).astype(np.float32) * scale))
        coef = kernels._moebius_coefficients(m)
        beta = jnp.reshape(jnp.asarray(m.beta, jnp.float32), (1,))
        fused = float(kernels._log_partition_fused(m.cliques, m.n, coef,
                                                   beta))
        ref = float(jax.scipy.special.logsumexp(
            kernels.all_log_potentials(m)))
        assert abs(fused - ref) < 5e-4, (m.n, fused, ref)


def test_log_partition_fused_random_structures():
    """Streaming lnZ vs table path on random clique structures (mixed
    sizes, shared variables, non-contiguous) — the Moebius chain and
    running-max recursion must agree for any static structure."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(11)
    for trial in range(4):
        n = int(rng.randint(10, 14))
        cliques = []
        for _ in range(rng.randint(2, 5)):
            size = int(rng.randint(1, 4))
            cliques.append(sorted(
                rng.choice(n, size=size, replace=False).tolist()))
        dim = sum(1 << len(C) for C in cliques)
        m = MRF.create(cliques, theta=jnp.asarray(
            -np.abs(rng.randn(dim)).astype(np.float32) * 0.4))
        coef = kernels._moebius_coefficients(m)
        beta = jnp.reshape(jnp.asarray(m.beta, jnp.float32), (1,))
        fused = float(kernels._log_partition_fused(m.cliques, m.n, coef,
                                                   beta))
        ref = float(jax.scipy.special.logsumexp(
            kernels.all_log_potentials(m)))
        assert abs(fused - ref) < 5e-4, (trial, cliques, fused, ref)


@pytest.mark.parametrize("geom", [(8, 10), (7, 9)])
def test_split_logpot_multiblock(geom):
    """Multi-tile streaming sweep with HIGH and CROSSING cliques.

    The production geometry keeps small-n sweeps in ONE tile, where
    every clique is low and _split_logpot's high/cross paths never
    execute in the CPU tests — so drive the lnZ sweep directly at a
    forced small geometry (n=12 grid: the low-plane cut crosses several
    edges and whole columns land in the high bits), plus a nonzero tile
    offset mimicking a sharded device slice."""
    lo_bits, tile_bits = geom
    g = grid_mrf(3, 4)
    rng = np.random.RandomState(5)
    m = g.with_theta(jnp.asarray(
        -np.abs(rng.randn(g.dimension)).astype(np.float32) * 0.4))
    coef = kernels._moebius_coefficients(m)
    beta = jnp.reshape(jnp.asarray(m.beta, jnp.float32), (1,))
    full = np.asarray(m.beta * m.all_log_potentials())

    for x0_states, num_states in ((0, 1 << m.n), (1 << 11, 1 << 11)):
        x0b = x0_states >> tile_bits
        ms, ss = kernels._lse_partials_call(
            m.cliques, m.n, num_states, coef, beta,
            jnp.full((1,), x0b, jnp.int32), lo_bits, tile_bits)
        got = float(kernels._combine_lse(ms, ss))
        ref = full[x0_states:x0_states + num_states]
        want = float(np.log(np.exp(ref - ref.max()).sum()) + ref.max())
        assert abs(got - want) < 5e-4, (geom, x0_states, got, want)


def test_split_logpot_past_int32_state_ids():
    """Block-unit bases keep the streaming sweep inside int32 past the
    2^31-state-id limit: an n=34 chain slice starting beyond 2^33 must
    match an int64 numpy enumeration of the same states. (The full n=34
    sweep runs on the card; this pins the >int32 bit arithmetic that
    enables it.)"""
    n = 34
    cliques = [[i, i + 1] for i in range(n - 1)]
    rng = np.random.RandomState(9)
    m = MRF.create(cliques, theta=jnp.asarray(
        -np.abs(rng.randn(4 * (n - 1))).astype(np.float32) * 0.3))
    coef = kernels._moebius_coefficients(m)
    beta = jnp.reshape(jnp.asarray(m.beta, jnp.float32), (1,))

    lo_bits, tile_bits, num_states = 8, 10, 1 << 12  # 4 tiles
    x0_states = (1 << 33) + (1 << 31) + 5 * (1 << 12)  # > int32 max
    ms, ss = kernels._lse_partials_call(
        tuple(tuple(C) for C in m.cliques), n, num_states, coef, beta,
        jnp.full((1,), x0_states >> tile_bits, jnp.int32),
        lo_bits, tile_bits)
    got = float(kernels._combine_lse(ms, ss))

    # int64 host reference over the same slice
    x = np.arange(x0_states, x0_states + num_states, dtype=np.int64)
    lp = np.zeros(num_states, np.float64)
    th = np.asarray(m.theta, np.float64)
    off = 0
    for C in m.cliques:
        idx = np.zeros(num_states, np.int64)
        for slot, v in enumerate(C):  # y[0] slowest: slot 0 = MSB of y
            bit = (x >> np.int64(n - 1 - v)) & 1
            idx |= bit << np.int64(len(C) - 1 - slot)
        lp += th[off + idx]
        off += 1 << len(C)
    lp *= float(m.beta)
    want = float(np.log(np.exp(lp - lp.max()).sum()) + lp.max())
    assert abs(got - want) < 5e-4, (got, want)


def test_map_state_streaming_matches_table():
    """Streaming argmax == table argmax (value and id) on structures the
    table path can enumerate, including a forced multi-tile sweep so
    tile-boundary carry logic executes."""
    from qcmrf_tpu.models.sample import map_state

    for seed, cliques in ((3, [[0, 1], [1, 2], [2, 3], [3, 4], [4, 5],
                               [5, 6], [6, 7], [7, 8], [8, 9], [9, 10],
                               [10, 11]]),
                          (4, [[0, 1, 2], [2, 3, 4], [4, 5, 6, 7],
                               [7, 8, 9], [9, 10, 11]])):
        m = rand_mrf(cliques, seed=seed, scale=0.6)
        want_id = int(map_state(m))
        want_val = float((m.beta * m.all_log_potentials())[want_id])
        got_id, got_val = kernels.map_state_streaming(m)
        assert got_id == want_id
        assert abs(got_val - want_val) < 1e-4

        # forced 8-tile sweep (production picks one tile at this n,
        # skipping the cross-tile carry)
        coef = kernels._moebius_coefficients(m)
        beta = jnp.reshape(jnp.asarray(m.beta, jnp.float32), (1,))
        out = kernels._map_partials_call(
            tuple(tuple(C) for C in m.cliques), m.n, 1 << m.n, coef, beta,
            jnp.zeros((1,), jnp.int32), 7, 9)
        state, val = kernels.map_partials_decode(
            m.cliques, m.n, 1 << m.n, out, tile_bits=9)
        assert state == want_id
        assert abs(val - want_val) < 1e-4


def test_row_gate_high_qubit_stride_tiling():
    """apply_1q on a high qubit: a 2^16-element stride between the
    paired amplitudes."""
    import jax.numpy as jnp

    n, q = 17, 16
    rows = (1 << n) // 128
    rng = np.random.RandomState(2)
    re = jnp.asarray(rng.randn(rows, 128).astype(np.float32))
    im = jnp.asarray(rng.randn(rows, 128).astype(np.float32))
    H = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2)
    ore, oim = kernels.apply_1q(re, im, H, q, n)
    psi = (np.asarray(re) + 1j * np.asarray(im)).reshape(-1)
    idx = np.arange(psi.size)
    hi = (idx >> q) & 1
    a0 = np.where(hi == 0, psi, psi[idx ^ (1 << q)])
    a1 = np.where(hi == 0, psi[idx ^ (1 << q)], psi)
    ref = np.where(hi == 0, a0 + a1, a0 - a1) / np.sqrt(2)
    got = (np.asarray(ore) + 1j * np.asarray(oim)).reshape(-1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_map_state_streaming_small_n_dense_fallback():
    """Below the kernel floor the streaming MAP takes the dense argmax
    (previously a ZeroDivisionError: rows // block_rows with rows = 0
    at n < 7)."""
    m = rand_mrf([[0, 1], [1, 2]], seed=7)  # n=3
    got_id, got_val = kernels.map_state_streaming(m)
    lp = np.asarray(m.beta * m.all_log_potentials())
    assert got_id == int(np.argmax(lp))
    assert abs(got_val - float(lp.max())) < 1e-5


def test_sweep_geometry_contract():
    """The sharded callers' tile-unit offsets and the MAP id decoding
    rest on one geometry: low plane <= tile <= swept states, and both
    sweeps report the same tile size."""
    n = 26
    cliques = tuple(
        (h, 12 + h, 13 + h, 14 + h, 15 + h) for h in range(8)
    )
    L, T = kernels.sweep_geometry(1 << n)
    assert L == kernels._LO_BITS and T == kernels._TILE_BITS
    assert kernels.lse_block_states(cliques, n, 1 << n) == 1 << T
    assert kernels.map_block_states(cliques, n, 1 << n) == 1 << T
    # small sweeps shrink to fit, one tile
    assert kernels.sweep_geometry(1 << 12) == (12, 12)
    # overrides keep L <= T
    assert kernels.sweep_geometry(1 << 20, lo_bits=9, tile_bits=8) == (8, 8)


def test_interpret_only_on_cpu(monkeypatch):
    """Pallas kernels interpret on the CPU (the tests) and nowhere else:
    on a GPU they are compiled for the card."""
    import jax
    from qcmrf_tpu.ops import _common

    assert _common.interpret()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not _common.interpret()
