"""Closed-form QCMRF outcome distribution — the fast path.

The QCMRF circuit's measurement statistics factorize exactly (derived from
the verified semantics in SURVEY.md Appendix A item 5): every per-clique
real-part-extraction sandwich multiplies the amplitude of variable-state
``x`` by ``cos(2*gamma_C(x)) = exp(beta*theta_C(x)/2)`` on its ancilla-0
branch and ``-i*sin(2*gamma_C(x))`` on the ancilla-1 branch, and all blocks
are diagonal in ``x``. Hence the joint outcome distribution is

    P(x, a_1..a_K) = 2^{-n} * prod_k [ c2_k(x) if a_k = 0 else 1 - c2_k(x) ]

with ``c2_k(x) = exp(beta * theta_{k, y_k(x)})``. Consequences:

* the *unconditional* marginal of ``x`` is uniform — sampling the circuit
  reduces to "draw x uniformly, then flip K independent Bernoulli ancillas" —
  embarrassingly parallel over shots;
* post-selection on all-zero ancillas yields the Gibbs distribution with
  success rate ``delta = Z / 2**n``.

This module is the flagship execution path for QCMRF circuits; the gate-level
engines (:mod:`qcmrf_tpu.sim.dense`, :mod:`qcmrf_tpu.sim.tpu`) validate it
gate-by-gate and serve arbitrary circuits.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.utils import moebius


def check_theta_domain(mrf: MRF) -> None:
    """Host-side guard for the sampling entry points: theta > 0 makes
    ``c2 = exp(beta*theta) > 1``, so the Bernoulli ``u >= c2`` silently
    never fires (the sample follows the theta=0 law instead of erroring)
    and ``1 - c2`` goes negative in the joint law. Only checks concrete
    (non-traced) theta — inside jit the caller owns the domain (training
    reparameterizes to theta <= 0 by construction)."""
    import numpy as np

    theta = mrf.theta
    if isinstance(theta, jax.core.Tracer):
        return
    if np.any(np.asarray(theta) > 0):
        raise ValueError(
            "theta must be <= 0 (QCMRF.py:139 domain): positive entries "
            "give clique keep-probabilities > 1 and a silently wrong "
            "outcome law"
        )


def clique_keep_probs(mrf: MRF, x) -> jax.Array:
    """``c2_k(x) = exp(beta * theta_k(y_k(x)))`` for each clique k.

    Shape ``x.shape + (K,)``. This is the per-clique ancilla-0 probability.
    """
    flat_idx = mrf.suff_stat_flat_indices(x)
    return jnp.exp(mrf.beta * mrf.theta[flat_idx])


@functools.lru_cache(maxsize=256)
def _moebius_layout(cliques: tuple, n: int):
    """Static tables for the gather-free keep-prob evaluation.

    Returns (idx_map (K, 2^cmax) int32, shifts (cmax, K) int32, cmax):
    ``idx_map[k, s]`` maps slot-encoded subset ``s`` (bit i <-> clique slot
    i; out-of-range slots aliased down so their Moebius coefficients vanish)
    to the flat theta index; ``shifts[i, k]`` is the state-id right-shift of
    clique k's slot-i variable.
    """
    import numpy as np

    K = len(cliques)
    cmax = max(len(C) for C in cliques)
    offsets, o = [], 0
    for C in cliques:
        offsets.append(o)
        o += 1 << len(C)
    idx_map = np.zeros((K, 1 << cmax), dtype=np.int32)
    shifts = np.zeros((cmax, K), dtype=np.int32)
    for k, C in enumerate(cliques):
        m = len(C)
        for i, v in enumerate(C):
            shifts[i, k] = n - 1 - v
        for s in range(1 << cmax):
            sm = s & ((1 << m) - 1)
            yidx = 0
            for i in range(m):
                if (sm >> i) & 1:
                    yidx |= 1 << (m - 1 - i)
            idx_map[k, s] = offsets[k] + yidx
    return idx_map, shifts, cmax


def _broadcast_multilinear(mrf: MRF, x, tab) -> jax.Array:
    """Evaluate per-clique multilinear coefficient tables ``tab``
    ((K, 2^cmax), slot-encoded) at state ids ``x``; returns (..., K)."""
    _, shifts, cmax = _moebius_layout(mrf.cliques, mrf.n)
    x = jnp.asarray(x, jnp.int32)
    sh = jnp.asarray(shifts)  # (cmax, K)
    bits = [
        ((x[..., None] >> sh[i]) & 1).astype(tab.dtype)
        for i in range(cmax)
    ]  # each (..., K)
    zero = jnp.zeros(x.shape + (tab.shape[0],), tab.dtype)
    return moebius.eval_multilinear(
        bits, cmax, lambda s: tab[:, s], zero
    )


def clique_keep_probs_fast(mrf: MRF, x) -> jax.Array:
    """Gather-free ``c2_k(x)``: the per-clique exp-theta table is converted
    to multilinear (Moebius) coefficients in-graph (tiny (K, 2^cmax) ops),
    then evaluated per state as an FMA chain over bit monomials — no
    per-(state, clique) gather, so XLA fuses the whole thing. Exact; the
    throughput path for sampling (the gather version is the reference).
    """
    idx_map, _, cmax = _moebius_layout(mrf.cliques, mrf.n)
    tab = moebius.transform(
        jnp.exp(mrf.beta * mrf.theta[jnp.asarray(idx_map)]), cmax
    )
    return _broadcast_multilinear(mrf, x, tab)


def log_potentials_fast(mrf: MRF, x) -> jax.Array:
    """Gather-free ``beta * theta^T phi(x)``: per-clique Moebius
    coefficients evaluated as FMA
    chains over bit monomials and summed over cliques. Exact; preferable to
    ``mrf.log_potential`` for large state batches on accelerators (no
    per-(state, clique) gather)."""
    idx_map, _, cmax = _moebius_layout(mrf.cliques, mrf.n)
    tab = moebius.transform(
        mrf.beta * mrf.theta[jnp.asarray(idx_map)], cmax
    )
    return _broadcast_multilinear(mrf, x, tab).sum(-1)


def postselected_probs(mrf: MRF) -> Tuple[jax.Array, jax.Array]:
    """Exact post-selected distribution and success rate.

    Returns ``(p, delta)`` where ``p[x]`` is the Gibbs distribution over the
    ``2**n`` variable states and ``delta = Z / 2**n``.
    """
    check_theta_domain(mrf)
    logpot = mrf.beta * mrf.all_log_potentials()
    lse = jax.scipy.special.logsumexp(logpot)
    p = jnp.exp(logpot - lse)
    delta = jnp.exp(lse - mrf.n * jnp.log(2.0))
    return p, delta


def joint_outcome_probs(mrf: MRF) -> jax.Array:
    """Full joint distribution over counts keys, shape ``2**(n+K+1)``.

    Key layout (matches the deferred-measurement dense engine and qiskit
    key ints): bits ``0..n-1`` = variable state id, bit ``n`` = workspace
    (always 0), bits ``n+1+k`` = ancilla of clique ``k``. Peak memory is
    about twice the output; large models use :func:`sample_outcome_parts`,
    which never materializes the joint.
    """
    check_theta_domain(mrf)
    n, K = mrf.n, mrf.num_cliques
    if n + K + 1 > 31:
        raise ValueError(
            f"joint distribution would need 2**{n + K + 1} floats and "
            "int32 keys past 2**31; use sample_outcome_parts / "
            "sample_postselected for large models (they never materialize "
            "the joint)"
        )
    x = jnp.arange(mrf.num_states, dtype=jnp.int32)
    c2 = clique_keep_probs(mrf, x)  # (2**n, K)

    # ancilla configurations a in [0, 2**K): bit k of a = outcome of clique k
    # P[a, x] = 2^-n * prod_k (1 - c2 if bit k of a else c2)
    a = jnp.arange(1 << K, dtype=jnp.int32)[:, None]
    P = jnp.full((1 << K, mrf.num_states), 2.0 ** -n, c2.dtype)
    for k in range(K):
        P = P * jnp.where(((a >> k) & 1) == 1, 1.0 - c2[:, k], c2[:, k])
    # key = x + (a << (n+1)); the workspace bit n is 0
    out = jnp.zeros((1 << K, 2, mrf.num_states), c2.dtype)
    return out.at[:, 0].set(P).reshape(-1)


def sample_outcome_parts(key: jax.Array, mrf: MRF, shots: int):
    """Sample full measurement outcomes without materializing any 2^Q vector.

    Exactly reproduces the circuit's outcome statistics: ``x`` uniform,
    ancilla ``k`` ~ Bernoulli(1 - c2_k(x)). Returns ``(x, a)`` with the
    variable state ids (int32) and the ancilla outcome bitmask (uint32,
    bit k = clique k's ancilla; K <= 32). O(shots * K) work, independent
    of 2**n — this is the n=20+ throughput path.
    """
    if mrf.num_cliques > 32:
        raise ValueError("ancilla bitmask limited to 32 cliques per word")
    check_theta_domain(mrf)
    return _sample_outcome_parts(key, mrf, shots)


@functools.partial(jax.jit, static_argnums=(2,))
def _sample_outcome_parts(key, mrf, shots):
    K = mrf.num_cliques
    kx, ka = jax.random.split(key)
    x = jax.random.randint(kx, (shots,), 0, mrf.num_states, dtype=jnp.int32)
    c2 = clique_keep_probs_fast(mrf, x)  # (shots, K)
    u = jax.random.uniform(ka, (shots, K), dtype=c2.dtype)
    abits = (u >= c2).astype(jnp.uint32)  # 1 = ancilla fired (reject)
    a = (abits << jnp.arange(K, dtype=jnp.uint32)).sum(-1, dtype=jnp.uint32)
    return x, a


@functools.partial(jax.jit, static_argnums=(2,))
def sample_outcomes(key: jax.Array, mrf: MRF, shots: int) -> jax.Array:
    """Sampled measurement keys packed as int32 (layout of
    :func:`joint_outcome_probs`). Requires n + K + 1 <= 31 — true for the
    whole reference suite; wider models use :func:`sample_outcome_parts`.
    """
    n, K = mrf.n, mrf.num_cliques
    if n + K + 1 > 31:
        raise ValueError(
            "packed keys need n + K + 1 <= 31 bits; "
            "use sample_outcome_parts for wider circuits"
        )
    x, a = sample_outcome_parts(key, mrf, shots)
    return x + (a.astype(jnp.int32) << (n + 1))


def sample_postselected(key: jax.Array, mrf: MRF, shots: int):
    """Sample ``shots`` outcomes: (variable states, accept mask).

    Equivalent to running the circuit and post-selecting all-zero ancillas
    (eval.py:115-123 semantics). Returns ``(x, accepted)`` where ``x`` are
    the uniform variable draws and ``accepted[s]`` says shot ``s`` survived.
    No per-ancilla packing, so there is no clique-count limit (n=24-28
    grids have K > 32).
    """
    check_theta_domain(mrf)
    return _sample_postselected(key, mrf, shots)


@functools.partial(jax.jit, static_argnums=(2,))
def _sample_postselected(key, mrf, shots):
    K = mrf.num_cliques
    kx, ka = jax.random.split(key)
    x = jax.random.randint(kx, (shots,), 0, mrf.num_states, dtype=jnp.int32)
    c2 = clique_keep_probs_fast(mrf, x)
    u = jax.random.uniform(ka, (shots, K), dtype=c2.dtype)
    return x, jnp.all(u < c2, axis=-1)
