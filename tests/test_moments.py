"""Streaming exact moments + differentiable streaming lnZ (models/moments.py).

Validates the chunked gather-free sweep against the elimination and
enumeration oracles, the custom-VJP gradient against autodiff through
the enumeration table, and the training-path routing that sends
high-induced-width structures past n=22 through the streaming lnZ.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qcmrf_tpu.models import elimination as ve
from qcmrf_tpu.models import moments, train
from qcmrf_tpu.models.mrf import MRF, chain_mrf


GRAPHS = [
    [[0]],
    [[0, 1], [1, 2], [2, 3]],
    [[0, 1, 2], [2, 3, 4]],
    [[2, 0, 3]],          # unsorted clique order
    [[0, 2], [1, 3]],     # disconnected components
]


def _random_mrf(cliques, seed=0, beta=1.0):
    probe = MRF.create(cliques)
    rng = np.random.RandomState(seed)
    return MRF.create(
        cliques, theta=-np.abs(rng.randn(probe.dimension)), beta=beta
    )


@pytest.mark.parametrize("cliques", GRAPHS)
def test_streaming_moments_match_elimination(cliques):
    mrf = _random_mrf(cliques)
    got = np.asarray(moments.clique_moments_streaming(mrf))
    want = np.asarray(ve.clique_marginals(mrf))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_streaming_moments_chunked_path():
    """n=17 > _CHUNK_BITS exercises the lax.scan sweep (2 chunks)."""
    assert moments._CHUNK_BITS == 16
    mrf = _random_mrf([[i, i + 1] for i in range(16)], seed=3, beta=1.5)
    assert mrf.n == 17
    got = np.asarray(moments.clique_moments_streaming(mrf))
    want = np.asarray(ve.clique_marginals(mrf))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_streaming_lnZ_value_and_grad():
    """Value == enumeration lnZ; custom-VJP grad == autodiff through the
    2^n table (beta * E_p[phi])."""
    mrf = _random_mrf([[0, 1, 2], [2, 3], [3, 4, 0]], seed=4, beta=2.0)

    got = float(moments.log_partition_streaming(mrf))
    want = float(mrf.log_partition())
    assert np.isclose(got, want, rtol=1e-5)

    def stream_lnZ(theta):
        return moments.log_partition_streaming(mrf.with_theta(theta))

    def table_lnZ(theta):
        return mrf.with_theta(theta).log_partition()

    g_got = np.asarray(jax.grad(stream_lnZ)(mrf.theta))
    g_want = np.asarray(jax.grad(table_lnZ)(mrf.theta))
    np.testing.assert_allclose(g_got, g_want, rtol=1e-4, atol=1e-6)


def test_streaming_lnZ_jittable():
    mrf = _random_mrf([[0, 1], [1, 2]], seed=5)

    @jax.jit
    def f(theta):
        return jax.value_and_grad(
            lambda t: moments.log_partition_streaming(mrf.with_theta(t))
        )(theta)

    v, g = f(mrf.theta)
    assert np.isclose(float(v), float(mrf.log_partition()), rtol=1e-5)
    assert np.all(np.isfinite(np.asarray(g)))


def test_streaming_moments_width_cap():
    with pytest.raises(ValueError, match="n=47"):
        moments.clique_moments_streaming(
            MRF.create([[0, 47]])  # n = 48 > the int32 block-id cap
        )


@pytest.mark.parametrize("cb", [3, 5])
def test_block_offset_coordinates(monkeypatch, cb):
    """Tiny chunks force the sweep across the block cut: low-only,
    high-only, and cut-crossing cliques all exercise the (blk, offset)
    bit split that carries the sweep past the int32 state-id limit."""
    monkeypatch.setattr(moments, "_CHUNK_BITS", cb)
    mrf = _random_mrf(
        [[0, 1, 2], [3, 4], [2, 5, 7], [6, 7], [0, 7]], seed=7, beta=1.3
    )
    assert mrf.n == 8
    got = np.asarray(moments.clique_moments_streaming(mrf))
    want = np.asarray(ve.clique_marginals(mrf))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_induced_width():
    # chain: width 2; adding a clique over {0..4} forces width >= 5
    assert ve.induced_width(((0, 1), (1, 2), (2, 3)), 4) == 2
    assert ve.induced_width(((0, 1, 2, 3, 4), (4, 5)), 6) >= 5
    assert ve.induced_width((), 3) == 0


def test_moment_train_step_streaming_routing(monkeypatch):
    """make_moment_train_step (the past-n=30 sufficient-statistics path)
    must produce the same step through the streaming custom-VJP lnZ as
    through elimination when the width cap forces the reroute."""
    import optax

    cliques = [[0, 1, 2], [2, 3], [1, 3]]
    mrf = _random_mrf(cliques, seed=8)
    true = _random_mrf(cliques, seed=9)
    mu_hat = ve.clique_marginals(true)

    def one_step():
        opt = optax.sgd(0.1)
        step = train.make_moment_train_step(mrf, opt, mu_hat)
        raw = train._from_theta(mrf.theta, True)
        raw, _, loss = step(raw, opt.init(raw))
        return np.asarray(raw), float(loss)

    raw_elim, loss_elim = one_step()
    monkeypatch.setattr(train, "_ELIM_WIDTH_CAP", 1)
    raw_stream, loss_stream = one_step()

    assert np.isclose(loss_stream, loss_elim, rtol=1e-5)
    np.testing.assert_allclose(raw_stream, raw_elim, rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_nll_routes_wide_structures_through_streaming(monkeypatch):
    """Past n=22 with induced width above the cap, _nll must fall back to
    the streaming lnZ and produce the same loss/grad as elimination would
    (cap lowered so a small-width n=23 model exercises the routing)."""
    cliques = [[i, i + 1] for i in range(22)] + [[0, 11, 22]]
    mrf = _random_mrf(cliques, seed=6)
    assert mrf.n == 23
    data = jnp.asarray([0, 5, (1 << 23) - 1], dtype=jnp.int32)

    def nll_grad(theta):
        return jax.value_and_grad(
            lambda t: train._nll(mrf, t, data)
        )(theta)

    v_elim, g_elim = nll_grad(mrf.theta)

    width = ve.induced_width(mrf.cliques, mrf.n)
    monkeypatch.setattr(train, "_ELIM_WIDTH_CAP", width - 1)
    v_stream, g_stream = nll_grad(mrf.theta)

    assert np.isclose(float(v_stream), float(v_elim), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(g_stream), np.asarray(g_elim), rtol=1e-3, atol=1e-5
    )


def test_streaming_moments_repeated_variable_cliques():
    """Degenerate cliques repeating a variable (b^2 = b aliases half the
    states away) exercise the Gram diagonal / (v,v)-pair branches; the
    elimination oracle cannot even build such scopes, so the pin is
    brute-force enumeration."""
    cl = [[0, 0], [0, 1], [1, 2, 2]]
    mrf = _random_mrf(cl, seed=2, beta=1.1)
    got = np.asarray(moments.clique_moments_streaming(mrf))

    p = np.asarray(mrf.gibbs_probs(), np.float64)
    n, x = mrf.n, np.arange(1 << mrf.n)
    mu = np.zeros(mrf.dimension)
    off = 0
    for C in mrf.cliques:
        y = np.zeros(1 << n, dtype=np.int64)
        for v in C:
            y = (y << 1) | ((x >> (n - 1 - v)) & 1)
        np.add.at(mu, off + y, p)
        off += 1 << len(C)
    np.testing.assert_allclose(got, mu, rtol=1e-5, atol=1e-6)


def test_gram_kernel_path_matches_elimination():
    """Pairwise structures through the weighted-Gram sweep: a cyclic
    n=14 structure with chords, every pair a Gram entry."""
    cl = ([[i, (i + 1) % 14] for i in range(14)]
          + [[0, 7], [3, 10], [5, 12]])
    mrf = _random_mrf(cl, seed=11, beta=1.2)
    gram = moments._gram_layout(mrf.cliques)
    assert gram.pair_g.size == len(cl) and gram.hi_g.size == 0

    got = np.asarray(moments.clique_moments_streaming(mrf))
    want = np.asarray(ve.clique_marginals(mrf))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gram_kernel_higher_order_cliques():
    """Size-3/4 cliques add product columns (``hi_cols``) beside the
    Gram entries; pinned against elimination, through both the moment
    sweep and the (lnZ, moments) pair."""
    cl = ([[i, i + 1] for i in range(13)]
          + [[0, 5, 9], [2, 7, 11], [1, 4, 8, 12]])
    mrf = _random_mrf(cl, seed=15, beta=1.2)
    gram = moments._gram_layout(mrf.cliques)
    assert len(gram.hi_cols) > 0

    got = np.asarray(moments.clique_moments_streaming(mrf))
    want = np.asarray(ve.clique_marginals(mrf))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    lnZ, mu = moments.lnz_and_moments_streaming(mrf)
    assert np.isclose(float(lnZ), float(mrf.log_partition()), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mu), want, rtol=1e-5, atol=1e-6)


def test_gram_kernel_repeated_vars_in_higher_order_clique():
    """A 4-slot clique with a repeated variable ([0, 1, 1, 2]) collapses
    to 3 distinct variables (b^2 = b); oracle is brute-force enumeration
    (elimination cannot build repeated-variable scopes)."""
    cl = ([[0, 1, 1, 2], [2, 3], [3, 4, 4]]
          + [[i, i + 1] for i in range(4, 13)])
    mrf = _random_mrf(cl, seed=16, beta=1.1)
    got = np.asarray(moments.clique_moments_streaming(mrf))

    p = np.asarray(mrf.gibbs_probs(), np.float64)
    n, x = mrf.n, np.arange(1 << mrf.n)
    mu = np.zeros(mrf.dimension)
    off = 0
    for C in mrf.cliques:
        y = np.zeros(1 << n, dtype=np.int64)
        for v in C:
            y = (y << 1) | ((x >> (n - 1 - v)) & 1)
        np.add.at(mu, off + y, p)
        off += 1 << len(C)
    np.testing.assert_allclose(got, mu, rtol=1e-5, atol=1e-6)


def test_gram_layout_kernel_ok_gate():
    """5+ distinct variables in one clique: the size >= 3 subsets become
    product columns (one per subset) and the sweep still matches."""
    gram = moments._gram_layout(((0, 1, 2, 3, 4),))
    assert len(gram.hi_cols) == 16  # C(5,3) + C(5,4) + C(5,5)
    mrf = _random_mrf([[0, 1, 2, 3, 4], [4, 5], [5, 6]], seed=17)
    got = np.asarray(moments.clique_moments_streaming(mrf))
    want = np.asarray(ve.clique_marginals(mrf))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fused_lnz_and_moments_matches_two_sweep():
    """The (lnZ, moments) pair must match the separate lnZ and moment
    sweeps on a pairwise structure and on higher-order cliques."""
    from qcmrf_tpu.ops import kernels as K

    cl = [[i, (i + 1) % 12] for i in range(12)] + [[2, 9]]
    mrf = _random_mrf(cl, seed=13, beta=1.4)

    lnZ_ref = float(K.log_partition(mrf))
    mu_ref = np.asarray(moments.clique_moments_streaming(mrf))
    lnZ, mu = moments.lnz_and_moments_streaming(mrf)
    assert np.isclose(float(lnZ), lnZ_ref, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mu), mu_ref,
                               rtol=1e-5, atol=1e-6)

    # higher-order structure: same API
    cl3 = [[0, 1, 2], [2, 3], [3, 4, 5]]
    mrf3 = _random_mrf(cl3, seed=14)
    lnZ3, mu3 = moments.lnz_and_moments_streaming(mrf3)
    assert np.isclose(float(lnZ3), float(mrf3.log_partition()), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(mu3), np.asarray(ve.clique_marginals(mrf3)),
        rtol=1e-5, atol=1e-6)


def test_clamped_streaming_matches_elimination():
    """Evidence clamping by exact clique-table reduction + streaming lnZ
    (the arbitrary-structure counterpart of elimination's clamped pass):
    clamped mass, conditionals (with/without extra evidence), the
    conflict short-circuit, and the all-evidence corner must match
    elimination / direct log-potentials."""
    mrf = _random_mrf(
        [[i, i + 1] for i in range(13)] + [[0, 5, 9], [2, 7, 11]],
        seed=18, beta=1.2)
    ev = {0: 1, 5: 0, 9: 1}
    got = float(moments.log_partition_clamped_streaming(mrf, ev))
    want = float(ve.log_partition_clamped(mrf, ev))
    assert np.isclose(got, want, rtol=1e-6)

    p = float(moments.conditional_prob_streaming(mrf, 3, 1, {0: 1, 7: 0}))
    assert np.isclose(
        p, float(ve.conditional_prob(mrf, 3, 1, {0: 1, 7: 0})), rtol=1e-5)
    p0 = float(moments.conditional_prob_streaming(mrf, 2, 0))
    assert np.isclose(p0, float(ve.conditional_prob(mrf, 2, 0)),
                      rtol=1e-5)
    assert float(moments.conditional_prob_streaming(
        mrf, 0, 1, {0: 1})) == 1.0
    assert float(moments.conditional_prob_streaming(
        mrf, 0, 0, {0: 1})) == 0.0

    full = {v: (v * 7 + 1) % 2 for v in range(mrf.n)}
    xid = 0
    for v in range(mrf.n):
        xid = (xid << 1) | full[v]
    mass = float(moments.log_partition_clamped_streaming(mrf, full))
    lp = float(mrf.beta * mrf.all_log_potentials()[xid])
    assert np.isclose(mass, lp, rtol=1e-5)


def test_clamped_streaming_degenerate_clique():
    """Evidence on a variable that repeats within a clique slot-slices
    every occurrence consistently (oracle: masked brute-force mass)."""
    mrf = _random_mrf([[0, 0, 1], [1, 2], [2, 3]], seed=19)
    got = float(moments.log_partition_clamped_streaming(mrf, {0: 1}))
    lps = np.asarray(mrf.beta * mrf.all_log_potentials(), np.float64)
    mask = ((np.arange(1 << mrf.n) >> (mrf.n - 1)) & 1) == 1
    want = float(np.log(np.exp(lps[mask]).sum()))
    assert np.isclose(got, want, rtol=1e-5)


def test_clamped_marginals_match_brute_force():
    """Conditional clique marginals E[phi | e] (evidence reduction +
    streaming moments + re-embed) vs the masked-table conditional;
    no-evidence must equal elimination's marginals; all-evidence must be
    the one-hot phi of the observed state."""
    mrf = _random_mrf([[i, i + 1] for i in range(7)] + [[0, 3, 6]],
                      seed=21, beta=1.2)
    n = mrf.n
    ids = np.arange(1 << n)
    p = np.asarray(mrf.gibbs_probs(), np.float64)

    def phi_rows(xids):
        out = np.zeros((len(xids), mrf.dimension))
        off = 0
        for C in mrf.cliques:
            y = np.zeros(len(xids), np.int64)
            for v in C:
                y = (y << 1) | ((xids >> (n - 1 - v)) & 1)
            out[np.arange(len(xids)), off + y] = 1.0
            off += 1 << len(C)
        return out

    ev = {1: 1, 4: 0}
    mask = ((((ids >> (n - 2)) & 1) == 1)
            & (((ids >> (n - 5)) & 1) == 0))
    pc = p * mask
    pc /= pc.sum()
    want = pc @ phi_rows(ids)
    got = np.asarray(
        moments.clique_marginals_clamped_streaming(mrf, ev), np.float64)
    np.testing.assert_allclose(got, want, atol=2e-6)

    got0 = np.asarray(
        moments.clique_marginals_clamped_streaming(mrf), np.float64)
    np.testing.assert_allclose(
        got0, np.asarray(ve.clique_marginals(mrf), np.float64), atol=2e-6)

    full = {v: (v * 3 + 1) % 2 for v in range(n)}
    xid = 0
    for v in range(n):
        xid = (xid << 1) | full[v]
    np.testing.assert_allclose(
        np.asarray(moments.clique_marginals_clamped_streaming(mrf, full)),
        phi_rows(np.array([xid]))[0], atol=1e-7)


def test_clamped_streaming_isolated_free_variables():
    """Free variables left in no reduced clique — isolated in the
    original model, or exposed when every clique containing other
    variables folds into the constant — keep their ln2 mass and their
    place in the reduced model's n (round-4 review: MRF.create's
    inferred n silently dropped them, losing ln2 per variable and
    misaligning sample/MAP re-embedding)."""
    # variable 1 is in no clique (n=3 by the explicit-n constructor)
    mrf = MRF.create([[0], [2]],
                     theta=jnp.asarray([0.0, -0.5, -0.2, 0.0]), beta=1.3,
                     n=3)
    assert mrf.n == 3

    red, _ = moments.reduce_evidence(mrf, {2: 1})
    assert red.n == 2  # free vars {0, 1}, var 1 isolated

    got = float(moments.log_partition_clamped_streaming(mrf, {2: 1}))
    lps = np.asarray(mrf.beta * mrf.all_log_potentials(), np.float64)
    mask = (np.arange(8) & 1) == 1
    want = float(np.log(np.exp(lps[mask]).sum()))
    assert np.isclose(got, want, rtol=1e-6)
    # elimination's clamped pass agrees (empty buckets contribute 2x)
    assert np.isclose(got, float(ve.log_partition_clamped(mrf, {2: 1})),
                      rtol=1e-6)

    # every clique determined, one isolated variable free:
    # mass = beta * const + ln 2 (the dummy zero-clique reduced model)
    got2 = float(moments.log_partition_clamped_streaming(
        mrf, {0: 1, 2: 0}))
    want2 = float(1.3 * (-0.5 + -0.2) + np.log(2.0))
    assert np.isclose(got2, want2, rtol=1e-6)

    # conditional marginals under the same evidence stay exact
    mu = np.asarray(moments.clique_marginals_clamped_streaming(
        mrf, {2: 1}))
    z = np.exp(1.3 * np.asarray([0.0, -0.5]))
    np.testing.assert_allclose(mu[:2], z / z.sum(), atol=1e-6)
    np.testing.assert_allclose(mu[2:], [0.0, 1.0], atol=1e-7)


def test_clamped_streaming_fuzz_vs_elimination():
    """Randomized cross-backend consistency: random structures (some
    with isolated variables via explicit n), random evidence sets —
    clamped log-mass and conditional marginals from the streaming
    reduction must match variable elimination / the masked brute-force
    table everywhere."""
    rng = np.random.RandomState(77)
    for trial in range(8):
        n = int(rng.randint(3, 9))
        ncl = int(rng.randint(1, 5))
        cliques = []
        for _ in range(ncl):
            c = int(rng.randint(1, min(4, n) + 1))
            cliques.append(sorted(rng.choice(n, size=c, replace=False)
                                  .tolist()))
        probe = MRF.create(cliques, n=n)
        mrf = MRF.create(
            cliques, theta=-np.abs(rng.randn(probe.dimension)),
            beta=float(rng.uniform(0.5, 1.5)), n=n)
        nev = int(rng.randint(1, n))
        ev_vars = rng.choice(n, size=nev, replace=False)
        ev = {int(v): int(rng.randint(0, 2)) for v in ev_vars}

        lps = np.asarray(mrf.beta * mrf.all_log_potentials(), np.float64)
        ids = np.arange(1 << n)
        mask = np.ones(1 << n, bool)
        for v, b in ev.items():
            mask &= ((ids >> (n - 1 - v)) & 1) == b
        want = float(np.log(np.exp(lps[mask]).sum()))
        got = float(moments.log_partition_clamped_streaming(mrf, ev))
        assert np.isclose(got, want, rtol=1e-5), (trial, cliques, ev)
        assert np.isclose(got, float(ve.log_partition_clamped(mrf, ev)),
                          rtol=1e-5), (trial, cliques, ev)

        # conditional marginals vs the masked table
        p = np.exp(lps - want) * mask
        mu_want = []
        for C in mrf.cliques:
            c = len(C)
            for y in range(1 << c):
                sel = np.ones(1 << n, bool)
                for s, v in enumerate(C):
                    sel &= (((ids >> (n - 1 - v)) & 1)
                            == ((y >> (c - 1 - s)) & 1))
                mu_want.append(p[sel].sum())
        mu = np.asarray(moments.clique_marginals_clamped_streaming(
            mrf, ev), np.float64)
        np.testing.assert_allclose(mu, mu_want, atol=1e-5,
                                   err_msg=f"{trial} {cliques} {ev}")


def test_clamped_streaming_validates_evidence():
    mrf = _random_mrf([[0, 1], [1, 2]], seed=20)
    with pytest.raises(ValueError, match="out of range"):
        moments.log_partition_clamped_streaming(mrf, {7: 1})
    with pytest.raises(ValueError, match="binary"):
        moments.conditional_prob_streaming(mrf, 1, 2)


def test_gram_kernel_grad_through_custom_vjp():
    """The moment sweep is the custom-VJP gradient of the streaming lnZ:
    value and grad must match autodiff through the 2^n table at a
    sweep-path width."""
    cl = [[i, i + 1] for i in range(11)] + [[0, 11]]
    mrf = _random_mrf(cl, seed=12, beta=0.9)

    def stream(theta):
        return moments.log_partition_streaming(mrf.with_theta(theta))

    def table(theta):
        return mrf.with_theta(theta).log_partition()

    v_got, g_got = jax.value_and_grad(stream)(mrf.theta)
    v_want, g_want = jax.value_and_grad(table)(mrf.theta)
    assert np.isclose(float(v_got), float(v_want), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_got), np.asarray(g_want),
                               rtol=1e-4, atol=1e-6)
