"""Classical samplers over MRFs (exact / Gibbs chain / perturb-and-MAP).

JAX replacement for ``kiopto_native``'s sampling API
(``px.sample(b)`` and ``px.sample(b, pam=True)``, reference
/root/reference/eval.py:95-113). All samplers are jit-compiled, use
``jax.random`` keys, and express the Markov chain with ``lax.scan`` —
no Python-level loops over samples.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from qcmrf_tpu.models.mrf import MRF

#: sample_conditional's PAM routing: prefer max-product elimination up
#: to this induced width (vmapped per-sample message tables stay at
#: num_samples * 2^width floats); wider structures use the streaming
#: argmax sweep
_PAM_ELIM_WIDTH = 16

#: sample_conditional's exact routing: up to this many free variables
#: the enumerated ``2**n`` logits table is cheap and one categorical
#: draw covers any structure; past it, exact IID draws come from
#: elimination's ancestral sampler (bounded induced width, any n)
_EXACT_TABLE_N = 20
#: hard table fallback for wide structures past ``_EXACT_TABLE_N``
#: where elimination's width cap is also blown: a 2^26 float32 logits
#: table (256 MB) still enumerates; past this there is no exact
#: sampler. Value in capability.py (one source of truth for caps).
from qcmrf_tpu.models.capability import (
    EXACT_TABLE_HARD_N as _EXACT_TABLE_HARD_N)

#: sample_exact: max num_samples * num_states for the single-stage
#: categorical (whose Gumbel matrix is that many floats); bigger draws
#: split into the exact two-stage block categorical
_CATEGORICAL_BUDGET = 1 << 28


@functools.partial(jax.jit, static_argnums=(2,))
def sample_exact(key: jax.Array, mrf: MRF, num_samples: int) -> jax.Array:
    """IID exact samples (state ids) from the Gibbs distribution.

    Uses the full ``2**n`` logits table — the exact analog of the
    reference's post-selected quantum sampling target. One categorical
    over the table broadcasts a ``(num_samples, 2**n)`` Gumbel matrix
    (``jax.random.categorical`` semantics), which stops fitting long
    before the table itself does (n=24 x 8000 draws would be a 0.5 TB
    matrix while the table is 64 MB) — past a memory budget the draw
    splits into an EXACT two-stage categorical: P(x) factorizes as
    P(block) * P(x | block) over any fixed partition of the state space,
    so sampling a block from per-block logsumexp masses and then a state
    within the chosen block is distribution-identical, and both stages'
    Gumbel matrices stay at ``num_samples * 2**(n/2)``. Draws below the
    budget are bit-identical to the historical single-stage path.
    """
    logits = mrf.beta * mrf.all_log_potentials()
    n = mrf.n
    if num_samples * (1 << n) <= _CATEGORICAL_BUDGET:
        return jax.random.categorical(
            key, logits, shape=(num_samples,)).astype(jnp.int32)
    bbits = (n + 1) // 2  # blocks ~ sqrt(num_states)
    nblk = 1 << bbits
    per = logits.reshape(nblk, (1 << n) // nblk)
    k1, k2 = jax.random.split(key)
    blk = jax.random.categorical(
        key=k1, logits=jax.scipy.special.logsumexp(per, axis=1),
        shape=(num_samples,))
    within = jax.random.categorical(k2, per[blk])  # per-row draw
    return (blk * per.shape[1] + within).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def sample_gibbs(
    key: jax.Array,
    mrf: MRF,
    num_samples: int,
    thin: int = 10,
    burn: int = 10,
) -> jax.Array:
    """Single-site systematic-scan Gibbs chain, returning thinned state ids.

    Mirrors the reference's classical baseline ``--mode gibbs``
    (eval.py:95-104: a long chain thinned by 10). One "step" is a full
    sweep over all ``n`` variables; the chain runs
    ``burn + num_samples * thin`` sweeps under ``lax.scan`` and every
    ``thin``-th post-burn-in state is emitted.
    """
    n = mrf.n
    positions = jnp.arange(n - 1, -1, -1, dtype=jnp.int32)  # bit pos of var v

    def sweep(carry, key_sweep):
        x = carry
        keys = jax.random.split(key_sweep, n)

        def site(v, x):
            pos = positions[v]
            x0 = x & ~(1 << pos)
            x1 = x | (1 << pos)
            d = mrf.beta * (mrf.log_potential(x1) - mrf.log_potential(x0))
            p1 = jax.nn.sigmoid(d)
            b = jax.random.bernoulli(keys[v], p1)
            return jnp.where(b, x1, x0)

        x = jax.lax.fori_loop(0, n, site, x)
        return x, x

    total = burn + num_samples * thin
    key_init, key_chain = jax.random.split(key)
    x0 = jax.random.randint(key_init, (), 0, mrf.num_states, dtype=jnp.int32)
    _, xs = jax.lax.scan(sweep, x0, jax.random.split(key_chain, total))
    return xs[burn::thin][:num_samples]


def bits_site_delta_fn(mrf: MRF):
    """``site_delta(v, bits)`` = theta(bits with v=1) − theta(bits with
    v=0) from only the cliques touching ``v`` — the local-energy core
    shared by the bit-array Gibbs sweep here and the AIS transition
    kernel (models/ais.py). Structure is consumed host-side, so the
    returned closure traces under jit (theta layout: y binary-counting,
    slot 0 slowest — models/mrf.py)."""
    # static per-variable clique membership: (clique k, position j)
    touch = [[] for _ in range(mrf.n)]
    for k, C in enumerate(mrf.cliques):
        for j, v in enumerate(C):
            touch[v].append((k, j))
    offs = mrf.theta_offsets

    def site_delta(v, bits):
        d = jnp.zeros((), mrf.theta.dtype)
        for k, j in touch[v]:
            C = mrf.cliques[k]
            m = len(C)
            idx = jnp.zeros((), jnp.int32)
            for jj, u in enumerate(C):
                if jj != j:
                    idx = idx + (bits[u] << (m - 1 - jj))
            hi = mrf.theta[offs[k] + idx + (1 << (m - 1 - j))]
            lo = mrf.theta[offs[k] + idx]
            d = d + (hi - lo)
        return d

    return site_delta


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def sample_gibbs_bits(
    key: jax.Array,
    mrf: MRF,
    num_samples: int,
    thin: int = 10,
    burn: int = 10,
) -> jax.Array:
    """Systematic-scan Gibbs chain on a BIT-ARRAY state, returning
    thinned samples as ``(num_samples, n)`` int32 bits.

    The any-n counterpart of :func:`sample_gibbs` (whose int32 state
    ids cap it at n=30): each site update computes the LOCAL energy
    difference from only the cliques touching that variable (theta
    layout: clique order, first variable slowest — models/mrf.py) —
    O(sum_{C ni v} 2 gathers) per site instead of two full-energy
    evaluations, and no state-id width limit. This is the fallback
    sampler for wide structures at large n, where both the exact
    ancestral sampler and PAM refuse."""
    n = mrf.n
    site_delta = bits_site_delta_fn(mrf)

    def sweep(bits, key_sweep):
        keys = jax.random.split(key_sweep, n)
        for v in range(n):  # static unroll: structure differs per site
            p1 = jax.nn.sigmoid(mrf.beta * site_delta(v, bits))
            b = jax.random.bernoulli(keys[v], p1)
            bits = bits.at[v].set(b.astype(jnp.int32))
        return bits, bits

    total = burn + num_samples * thin
    key_init, key_chain = jax.random.split(key)
    x0 = jax.random.bernoulli(key_init, 0.5, (n,)).astype(jnp.int32)
    _, xs = jax.lax.scan(sweep, x0, jax.random.split(key_chain, total))
    return xs[burn::thin][:num_samples]


@functools.partial(jax.jit, static_argnums=(2,))
def sample_pam(key: jax.Array, mrf: MRF, num_samples: int) -> jax.Array:
    """Low-order perturb-and-MAP samples (state ids).

    Mirrors the reference's ``--mode pam`` baseline
    (``px.sample(b, pam=True)``, eval.py:106-113): perturb every
    clique-state weight with IID Gumbel noise and return the MAP state of
    the perturbed model. Low-order perturbation makes this an
    *approximate* (upper-bound) sampler, like the classical PAM baseline.
    """
    # (2**n, K) active-weight index table, shared across samples.
    idx = mrf.suff_stat_flat_indices(
        jnp.arange(mrf.num_states, dtype=jnp.int32)
    )

    def one(k):
        g = jax.random.gumbel(k, (mrf.dimension,), dtype=mrf.theta.dtype)
        perturbed = mrf.beta * mrf.theta + g
        scores = perturbed[idx].sum(axis=-1)  # (2**n,)
        return jnp.argmax(scores).astype(jnp.int32)

    return jax.vmap(one)(jax.random.split(key, num_samples))


@jax.jit
def map_state(mrf: MRF) -> jax.Array:
    """Exact MAP state id (argmax of the Gibbs distribution)."""
    return jnp.argmax(mrf.all_log_potentials()).astype(jnp.int32)


@functools.lru_cache(maxsize=64)
def _pam_sweep_fn(cliques: tuple, n: int):
    """Compiled scan-over-samples of the streaming-MAP sweep on
    Gumbel-perturbed models — cached so repeated
    :func:`sample_pam_streaming` calls don't re-trace (a fresh jit
    closure per call cost ~90 ms/sample in re-trace overhead alone).
    ``beta`` is a traced argument, so sweeping it (annealed PAM) hits
    the same executable."""
    from qcmrf_tpu.ops import kernels as K

    dim = MRF.create([list(C) for C in cliques]).dimension

    @jax.jit
    def sweep_all(theta, beta, keys):
        def step(_, k):
            g = jax.random.gumbel(k, (dim,), jnp.float32)
            pm = MRF(theta=beta * theta + g, beta=1.0,
                     cliques=cliques, n=n)
            coef = K._moebius_coefficients(pm)
            out = K._map_partials_call(
                cliques, n, 1 << n, coef,
                jnp.ones((1,), jnp.float32), jnp.zeros((1,), jnp.int32))
            return 0, out

        return jax.lax.scan(step, 0, keys)[1]

    return sweep_all


def sample_pam_streaming(key: jax.Array, mrf: MRF,
                         num_samples: int) -> jax.Array:
    """Low-order perturb-and-MAP samples as bit arrays (num, n) for
    ARBITRARY clique structure past table widths and treewidth bounds.

    Completes the PAM surface: :func:`sample_pam` argmaxes an enumerated
    ``2**n`` table (small n), ``models.elimination.sample_pam`` runs
    max-product elimination (any n, bounded treewidth) — this one runs
    the streaming argmax sweep of
    :func:`qcmrf_tpu.ops.kernels.map_state_streaming` on each
    Gumbel-perturbed model, so no ``2**n`` array ever materializes and
    the structure is unconstrained (cost: one full state sweep per
    sample; ``lax.scan`` over samples keeps it one kernel compile).
    Same perturbation semantics as the table sampler (IID Gumbel on
    every clique-state weight of ``beta * theta``), so with the same key
    the two return identical samples where both apply. Bit order:
    column v = variable v (utils/bits.py)."""
    import numpy as np

    from qcmrf_tpu.ops import kernels as K

    n = mrf.n
    if n < K._MIN_KERNEL_N:  # below the kernel floor the table is tiny
        ids = np.asarray(sample_pam(key, mrf, num_samples), np.int64)
        return jnp.asarray(
            (ids[:, None] >> (n - 1 - np.arange(n))) & 1, jnp.int32)

    sweep_all = _pam_sweep_fn(mrf.cliques, n)
    outs = np.asarray(sweep_all(
        mrf.theta, jnp.asarray(mrf.beta, jnp.float32),
        jax.random.split(key, num_samples)))
    bits = np.zeros((num_samples, n), np.int32)
    for i, out in enumerate(outs):
        # shared block-unit decode (int64-safe past n=31)
        state, _ = K.map_partials_decode(mrf.cliques, n, 1 << n, out)
        bits[i] = (state >> (n - 1 - np.arange(n))) & 1
    return jnp.asarray(bits)


# --------------------------------------------------------------------------
# Evidence-conditioned MAP and sampling: clamp by exact clique-table
# reduction (models.moments.reduce_evidence), run any backend on the
# free-variable model, re-embed the evidence bits.
# --------------------------------------------------------------------------


def map_state_clamped(mrf: MRF, evidence: dict, mesh=None):
    """Exact evidence-constrained MAP (MPE): the argmax over all states
    consistent with ``evidence``, for ARBITRARY clique structure.

    Evidence clamps by exact clique-table reduction
    (:func:`qcmrf_tpu.models.moments.reduce_evidence`); the free-variable
    model runs the streaming argmax sweep
    (:func:`qcmrf_tpu.ops.kernels.map_state_streaming`, or the
    mesh-sharded sweep when ``mesh`` is given); the winner's bits
    re-embed around the evidence. Returns ``(state_id, beta_logpot)`` as
    host values (int64-safe past n=31), exactly like the unconditioned
    streaming MAP. The MPE analog of the reference oracle's
    ``px.infer(b, task="map")`` with observed variables
    (/root/reference/eval.py:95-113 exercises only the unconditioned
    form; this completes the standard query set)."""
    from qcmrf_tpu.models import moments
    from qcmrf_tpu.ops import kernels as K

    red, const = moments.reduce_evidence(mrf, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    n = mrf.n
    base = 0
    for v, b in ev.items():
        base |= b << (n - 1 - v)
    offset = float(mrf.beta) * float(const)
    if red is None:
        return base, offset
    if mesh is not None:
        from qcmrf_tpu.parallel import sharded

        mesh = sharded.fit_mesh(mesh, red.n)
    if mesh is not None:
        from qcmrf_tpu.parallel import sharded

        rid, val = sharded.sharded_map_state(red, mesh)
    else:
        rid, val = K.map_state_streaming(red)
    free = [v for v in range(n) if v not in ev]
    nf = len(free)
    for j, v in enumerate(free):
        base |= ((int(rid) >> (nf - 1 - j)) & 1) << (n - 1 - v)
    return base, float(val) + offset


def sample_conditional(key: jax.Array, mrf: MRF, num_samples: int,
                       evidence: dict, method: str = "exact",
                       mesh=None) -> jax.Array:
    """Samples of ``p(x_free | evidence)`` as bit arrays ``(num, n)``
    with the evidence columns clamped (column v = variable v).

    The evidence reduces the model exactly
    (:func:`qcmrf_tpu.models.moments.reduce_evidence`), the reduced
    model runs the chosen sampler, and the free bits land back in their
    original columns:

    - ``"exact"`` — IID exact conditional draws: the enumerated-table
      sampler up to ``_EXACT_TABLE_N`` free variables, elimination's
      ancestral sampler past that (bounded induced width, any n; wide
      AND large has no exact sampler and raises);
    - ``"gibbs"`` — systematic-scan Gibbs chain on bit-array states
      (local site updates, any n — the approximate fallback where both
      exact backends refuse);
    - ``"pam"``   — perturb-and-MAP: bounded induced width routes to
      max-product elimination (any n); wider structures use the
      streaming argmax sweep up to its n cap (with ``mesh`` each
      per-sample sweep shards over the devices); wide AND past the n
      cap has no exact backend and raises.
    """
    import numpy as np

    from qcmrf_tpu.models import moments

    red, _ = moments.reduce_evidence(mrf, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    n = mrf.n
    bits = np.zeros((num_samples, n), np.int32)
    for v, b in ev.items():
        bits[:, v] = b
    if red is None:
        return jnp.asarray(bits)
    free = np.asarray([v for v in range(n) if v not in ev])
    if method == "pam":
        # a variable in no reduced clique has no clique weight, so
        # low-order Gumbel perturbation never breaks its tie and every
        # PAM argmax leaves its bit at 0; its true conditional is an
        # independent uniform bit, drawn exactly below (the exact/gibbs
        # paths handle this through their full energy tables)
        covered = {j for C in red.cliques for j in C}
        iso = [j for j in range(red.n) if j not in covered]
        if iso:
            key, kiso = jax.random.split(key)
        if mesh is not None:
            from qcmrf_tpu.parallel import sharded

            mesh = sharded.fit_mesh(mesh, red.n)
        if mesh is not None:
            from qcmrf_tpu.parallel import sharded

            rbits = np.asarray(
                sharded.sharded_sample_pam(key, red, mesh, num_samples))
        else:
            from qcmrf_tpu.models import elimination
            from qcmrf_tpu.ops import kernels as K

            # prefer max-product elimination when the reduced width is
            # bounded: per sample it costs n * 2^(width+1) vs the
            # streaming sweep's 2^n (the width cap bounds the per-sample
            # message + argmax tables); tiny models keep the
            # enumerated-table path. Past the sweep's n cap elimination
            # is the ONLY backend, and a wide structure there has no
            # exact route at all — fail with the limits spelled out
            # rather than OOMing in the traceback tables (round-4
            # review finding)
            width = elimination.induced_width(red.cliques, red.n)
            if red.n > moments._MAX_N and width > _PAM_ELIM_WIDTH:
                raise ValueError(
                    f"conditional PAM on this model needs either the "
                    f"streaming argmax sweep (free variables "
                    f"{red.n} > cap {moments._MAX_N}) or max-product "
                    f"elimination (induced width {width} > cap "
                    f"{_PAM_ELIM_WIDTH}: per-sample traceback tables "
                    f"are steps x 2^width); add evidence to shrink the "
                    f"free set or use method='gibbs' on a narrower "
                    f"submodel")
            if red.n >= K._MIN_KERNEL_N and width <= _PAM_ELIM_WIDTH:
                rbits = np.asarray(elimination.sample_pam(
                    key, red, num_samples))
            else:
                rbits = np.asarray(
                    sample_pam_streaming(key, red, num_samples))
        if iso:
            rbits = np.array(rbits)
            rbits[:, iso] = np.asarray(jax.random.bernoulli(
                kiso, 0.5, (num_samples, len(iso))), np.int32)
    elif method == "exact" and red.n > _EXACT_TABLE_N:
        from qcmrf_tpu.models import elimination
        from qcmrf_tpu.models import train as mtrain

        # past cheap table widths, exact IID draws come from
        # elimination's ancestral pass — budgeted on BOTH the per-step
        # width and the total stored-factor floats (a long bounded-width
        # model passes the width cap yet stores width x steps tables);
        # a wide structure falls back to the enumerated table while it
        # still fits, and past every cap fails with the limits spelled
        # out rather than OOMing
        width = elimination.induced_width(red.cliques, red.n)
        if width <= mtrain._ELIM_WIDTH_CAP and \
                elimination.plan_table_floats(red.cliques, red.n) \
                <= elimination._SAMPLER_TABLE_FLOATS_CAP:
            rbits = np.asarray(elimination.sample_exact_elim(
                key, red, num_samples))
        elif red.n <= _EXACT_TABLE_HARD_N:
            ids = np.asarray(sample_exact(key, red, num_samples), np.int64)
            rbits = (ids[:, None] >> (red.n - 1 - np.arange(red.n))) & 1
        else:
            raise ValueError(
                f"exact conditional sampling on this model needs either "
                f"an enumerable table (free variables {red.n} > cap "
                f"{_EXACT_TABLE_HARD_N}) or elimination's ancestral "
                f"sampler (induced width {width} > cap "
                f"{mtrain._ELIM_WIDTH_CAP}, or its stored step factors "
                f"over {elimination._SAMPLER_TABLE_FLOATS_CAP:.3g} "
                f"floats); add evidence to shrink the free set, or use "
                f"method='gibbs' (approximate) or method='pam'")
    elif method == "gibbs":
        # the bit-array chain: identical systematic-scan semantics to
        # sample_gibbs but local site updates and no int32 state-id
        # width cap, so conditional Gibbs serves any reduced size —
        # including the wide-AND-large regime where exact and PAM
        # refuse
        rbits = np.asarray(sample_gibbs_bits(key, red, num_samples))
    elif method == "exact":
        ids = np.asarray(sample_exact(key, red, num_samples), np.int64)
        rbits = (ids[:, None] >> (red.n - 1 - np.arange(red.n))) & 1
    else:
        raise ValueError(f"unknown method {method!r}; expected "
                         "'exact', 'gibbs', or 'pam'")
    bits[:, free] = rbits
    return jnp.asarray(bits)
