"""Streaming exact moments and a differentiable streaming lnZ.

Closes the arbitrary-structure training gap between the enumeration
table (a 2^n logits table stops fitting beside an optimizer state around
n=22) and variable elimination (any n, but only bounded treewidth): a
chunked, gather-free sweep of the 2^n state space computes the exact
clique-marginal vector ``E_p[phi]`` without materializing any 2^n array,
and a custom-VJP wrapper turns the streaming lnZ into a differentiable
building block (``d lnZ / d theta = beta * E_p[phi]``), so exact MLE
runs for ANY clique structure on one chip.

The sweep works in (block, offset) coordinates — every chunk's states
are ``x = blk * 2^cb + offset`` — so no flat state id is ever formed:
bits below the chunk cut come from the int32 ``offset`` vector and bits
above it from the int32 scalar ``blk``, which keeps every in-sweep
integer below int32 past the 2^31-state-id limit (same block-unit
device as the streaming lnZ/MAP sweeps, ops/kernels.py::_split_logpot).
Width cap: ``n - cb <= 31`` ⇒ n <= 47 structurally; sweep time is the
practical bound (~2^n work).

The reference delegates all exact inference to ``kiopto_native``
(/root/reference/eval.py:84-93) and never trains; this extends the
oracle surface rather than mirroring it. The lnZ forward pass reuses
:func:`qcmrf_tpu.ops.kernels.log_partition`.

The sweep accumulates the DEDUPLICATED BIT-MONOMIAL basis, not the
theta-layout masks, as matrix products: every size-1/size-2 monomial
moment is one entry of the weighted Gram matrix ``B^T diag(w) B`` of
the used variables' bit planes (``b^2 = b`` puts the singletons on the
diagonal), and the log-potential folds into the same contractions (see
:func:`_chunk_mono_partials`). The products run at HIGHEST precision:
a default-precision float32 product on the GPU is a TF32 one, about
three decimal digits. Theta-layout moments are recovered once per sweep
by the inverse-Moebius doubling (:func:`_masks_from_monomials`).
"""

from __future__ import annotations

import collections
import functools

import jax
import jax.numpy as jnp

from qcmrf_tpu.models.mrf import MRF

#: states per sweep chunk: big enough that the per-chunk dispatch is
#: amortized, small enough that the (chunk,)-sized intermediates (one
#: weight vector + one live mask per clique state) stay cache-friendly
_CHUNK_BITS = 16

#: past the int32 state-id limit the block count 2^(n-cb) is the scan
#: length — bigger chunks keep it bounded (4 MB weight vectors are
#: nothing to HBM)
_CHUNK_BITS_BIG = 20

#: structural n cap (int32 block ids; defined with the other regime
#: caps in models/capability.py — the underscore alias is historical)
from qcmrf_tpu.models.capability import STREAMING_MAX_N as _MAX_N


def _chunk_bits(mrf: MRF, blk, offset, cb: int):
    """Bit value of every used variable over the chunk's states
    ``x = blk * 2^cb + offset``: a (chunk,) plane for variables in the
    low id bits, a chunk-constant scalar for variables above the cut
    (variable 0 = MSB of state ids; utils/bits.py)."""
    bits = {}
    for v in sorted({u for C in mrf.cliques for u in C}):
        p = mrf.n - 1 - v
        if p < cb:
            bits[v] = ((offset >> p) & 1).astype(jnp.float32)
        else:
            bits[v] = ((blk >> (p - cb)) & 1).astype(jnp.float32)
    return bits


class _MonomialLayout(
    collections.namedtuple(
        "_MonomialLayout", "cmaps sel_idx sel_gidx m cmax subsets")):
    """Host-side layout of the DEDUPLICATED bit-monomial basis shared by
    every clique: the union of all subsets of all cliques.

    * ``subsets[g]``: sorted variable tuple of monomial ``g`` (index 0 is
      the empty set; :func:`_gram_layout` splits these by size).
    * ``cmaps[k][s]``: global monomial index of clique ``k``'s slot
      subset ``s`` (bit ``i`` of ``s`` <-> slot ``i``, i.e. ``C[i]``).
    * ``sel_idx``/``sel_gidx``: scatter map from the padded Moebius
      coefficient table (``k << cmax | s`` flat layout, _beta_coef) onto
      the (m,) global-monomial coefficient vector.
    """


@functools.lru_cache(maxsize=128)
def _monomial_layout(cliques: tuple) -> _MonomialLayout:
    import numpy as np

    cmax = max(len(C) for C in cliques)
    index = {(): 0}
    cmaps = []
    sel_idx, sel_gidx = [], []
    for k, C in enumerate(cliques):
        local = []
        for s in range(1 << len(C)):
            S = tuple(sorted(C[i] for i in range(len(C)) if (s >> i) & 1))
            g = index.setdefault(S, len(index))
            local.append(g)
            sel_idx.append((k << cmax) | s)
            sel_gidx.append(g)
        cmaps.append(tuple(local))
    return _MonomialLayout(
        cmaps=tuple(cmaps),
        sel_idx=np.asarray(sel_idx, np.int32),
        sel_gidx=np.asarray(sel_gidx, np.int32),
        m=len(index), cmax=cmax, subsets=tuple(index),
    )


class _GramLayout(
    collections.namedtuple(
        "_GramLayout",
        "vars sing_g pair_g pair_iu pair_iv hi_g hi_cols")):
    """Host-side split of the monomial basis by subset size, for the
    matrix-product form of the sweep (:func:`_chunk_mono_partials`):

    * size 0 — ``sum w`` (the lane accumulator);
    * size 1 and 2 — ONE weighted Gram matrix ``B^T diag(w) B`` over the
      used variables' bit planes ``B`` covers every such moment at once
      (``E[w b_u b_v]``; the diagonal gives the singletons since
      ``b^2 = b``). ``sing_g[i]`` is var ``vars[i]``'s singleton
      monomial; ``(pair_g, pair_iu, pair_iv)`` index the size-2 subsets
      (``iu == iv`` for the degenerate repeated-variable pairs).
    * size >= 3 — ``hi_g[j]``'s column is the product of plane indices
      ``hi_cols[j]`` (per-column lane dots like the size-0 row)."""


@functools.lru_cache(maxsize=128)
def _gram_layout(cliques: tuple) -> _GramLayout:
    import numpy as np

    layout = _monomial_layout(cliques)
    vars_ = tuple(sorted({v for C in cliques for v in C}))
    vi = {v: i for i, v in enumerate(vars_)}
    sing_g = np.full(len(vars_), -1, np.int32)
    pair_g, pair_iu, pair_iv = [], [], []
    hi_g, hi_cols = [], []
    for g, S in enumerate(layout.subsets):
        if len(S) == 1:
            sing_g[vi[S[0]]] = g
        elif len(S) == 2:
            pair_g.append(g)
            pair_iu.append(vi[S[0]])
            pair_iv.append(vi[S[1]])
        elif len(S) >= 3:
            hi_g.append(g)
            hi_cols.append(tuple(vi[v] for v in S))
    assert (sing_g >= 0).all()  # every used var has a singleton subset
    return _GramLayout(
        vars=vars_, sing_g=sing_g,
        pair_g=np.asarray(pair_g, np.int32),
        pair_iu=np.asarray(pair_iu, np.int32),
        pair_iv=np.asarray(pair_iv, np.int32),
        hi_g=np.asarray(hi_g, np.int32), hi_cols=tuple(hi_cols),
    )


def _coef_mono(coef, layout: _MonomialLayout):
    """(m,) log-potential coefficients on the deduplicated monomial
    basis: subsets shared by several cliques (singletons, mostly) sum
    their per-clique Moebius coefficients."""
    return jnp.zeros((layout.m,), jnp.float32).at[
        jnp.asarray(layout.sel_gidx)
    ].add(coef[jnp.asarray(layout.sel_idx)])


def _chunk_mono_partials(mrf: MRF, coef_mono, lnZ, blk, offset, cb: int):
    """Partial monomial moments ``sum_x p(x) * mono_g(x)`` over one
    chunk, as the pytree ``(lane_w, G, extra)`` that
    :func:`_assemble_mono` flattens to (m,) once per sweep:

    * ``lane_w`` (L,) — lane-resolved ``sum w`` (L = min(128, chunk));
    * ``G`` (nv, nv) — the weighted Gram ``B^T diag(w) B`` of the used
      variables' bit planes: ONE HIGHEST-precision matrix product yields
      every size-1 (diagonal, ``b^2 = b``) and size-2 monomial moment;
    * ``extra`` (n_hi, L) — lane dots of the rare size->=3 columns.

    The log-potential is a matrix product too: ``lp = c0 + B a +
    rowsum((B Q) * B)`` with the singleton/pair coefficients scattered
    into ``a``/``Q`` (higher subsets FMA their product columns in),
    which keeps the sweep off the ~m-materialized-columns form (each
    column written and reread for its dot).

    Scalar-output reductions fused into producers are AVOIDED on
    purpose: they lower to sequential accumulations whose f32 error
    grows ~N*eps (measured 3e-5 absolute at chunk 2^16 — enough to fail
    the 1e-4-rtol oracle pins). lane_w/extra keep (L,) accumulators; the
    Gram's contraction is a tiled f32 accumulation. Final sums
    run once on small materialized arrays. Chunk-constant bits
    (variables above the block cut) broadcast into their B columns."""
    gram = _gram_layout(mrf.cliques)
    bits = _chunk_bits(mrf, blk, offset, cb)
    prec = jax.lax.Precision.HIGHEST

    B = jnp.stack(
        [jnp.broadcast_to(bits[v], offset.shape) for v in gram.vars],
        axis=1,
    )  # (chunk, nv)

    # lp = c0 + B a + rowsum((B Q) * B) [+ size>=3 column FMAs]
    # (every index below is a real monomial id: _gram_layout asserts a
    # singleton subset exists for each used variable)
    nv = len(gram.vars)
    a = coef_mono[jnp.asarray(gram.sing_g)]
    Q = jnp.zeros((nv, nv), jnp.float32).at[
        jnp.asarray(gram.pair_iu), jnp.asarray(gram.pair_iv)
    ].add(coef_mono[jnp.asarray(gram.pair_g)])
    lp = coef_mono[0] + jnp.matmul(B, a, precision=prec)
    if gram.pair_g.size:
        lp = lp + (jnp.matmul(B, Q, precision=prec) * B).sum(-1)
    hi_cols = []
    for j, idxs in enumerate(gram.hi_cols):
        col = B[:, idxs[0]]
        for i in idxs[1:]:
            col = col * B[:, i]
        hi_cols.append(col)
        lp = lp + coef_mono[int(gram.hi_g[j])] * col
    w = jnp.exp(lp - lnZ)  # p(x), exact

    L = min(128, w.size)
    w2 = w.reshape(-1, L)
    lane_w = w2.sum(0)  # (L,)
    G = jnp.matmul(B.T, B * w[:, None], precision=prec)  # (nv, nv)
    extra = (
        jnp.stack([(w2 * c.reshape(-1, L)).sum(0) for c in hi_cols])
        if hi_cols else jnp.zeros((0, L), jnp.float32)
    )
    return lane_w, G, extra


def _assemble_mono(partials, cliques: tuple):
    """(m,) monomial moments from the swept ``(lane_w, G, extra)``
    pytree (sum of :func:`_chunk_mono_partials` over all chunks)."""
    layout = _monomial_layout(cliques)
    gram = _gram_layout(cliques)
    lane_w, G, extra = partials
    mono = jnp.zeros((layout.m,), jnp.float32)
    mono = mono.at[0].set(lane_w.sum())
    mono = mono.at[jnp.asarray(gram.sing_g)].set(jnp.diagonal(G))
    if gram.pair_g.size:
        mono = mono.at[jnp.asarray(gram.pair_g)].set(
            G[jnp.asarray(gram.pair_iu), jnp.asarray(gram.pair_iv)])
    if gram.hi_g.size:
        mono = mono.at[jnp.asarray(gram.hi_g)].set(extra.sum(axis=1))
    return mono


def _masks_from_monomials(mono, cliques: tuple):
    """theta-layout moments ``E_p[phi]`` from monomial moments
    ``E_p[prod b]`` by the inverse-Moebius doubling per clique: per slot
    ``(without, with) -> (without - with, with)`` — the numerically
    compensated form (pairwise differences of probabilities; no signed
    2^|C|-term sums), run ONCE at the end of the sweep. The final
    bit-reversal gather maps slot-bitmask order onto the theta layout's
    y index (y binary-counting, y[0] slowest — utils/bits.py)."""
    layout = _monomial_layout(cliques)
    parts = []
    for k, C in enumerate(cliques):
        c = len(C)
        tab = mono[jnp.asarray(layout.cmaps[k], jnp.int32)]
        for i in range(c):
            t = tab.reshape(1 << (c - 1 - i), 2, 1 << i)
            tab = jnp.concatenate(
                [t[:, :1] - t[:, 1:], t[:, 1:]], axis=1
            ).reshape(-1)
        rev = [int(format(s, f"0{c}b")[::-1], 2) for s in range(1 << c)]
        parts.append(tab[jnp.asarray(rev, jnp.int32)])
    return jnp.concatenate(parts)


def _beta_coef(mrf: MRF) -> jax.Array:
    """beta-scaled Moebius coefficients, same padded layout as the
    sweeps' (the transform is linear, so scaling commutes with it)."""
    from qcmrf_tpu.ops import kernels

    return (jnp.asarray(mrf.beta, jnp.float32)
            * kernels._moebius_coefficients(mrf))


def clique_moments_streaming(mrf: MRF, lnZ=None) -> jax.Array:
    """Exact model moments ``E_p[phi]`` (the clique-marginal vector in
    theta layout) by a chunked streaming sweep — no 2^n array and no
    flat state id ever materializes, so the sweep runs past the int32
    state-id limit (structural cap ``n <= 47``; time is the practical
    bound). ``lnZ`` may be passed to skip recomputing it.

    For bounded-treewidth models prefer
    :func:`qcmrf_tpu.models.elimination.clique_marginals`; this exists
    for structures whose induced width makes elimination intractable.
    """
    from qcmrf_tpu.ops import kernels

    if mrf.n > _MAX_N:
        raise ValueError(
            f"streaming moments cap at n={_MAX_N} (int32 block ids); got "
            f"n={mrf.n} — bounded-treewidth models can use "
            "models.elimination.clique_marginals at any n"
        )
    if lnZ is None:
        lnZ = kernels.log_partition(mrf)
    layout = _monomial_layout(mrf.cliques)
    coef_mono = _coef_mono(_beta_coef(mrf), layout)
    cb = min(_CHUNK_BITS if mrf.n <= 31 else _CHUNK_BITS_BIG, mrf.n)
    offset = jnp.arange(1 << cb, dtype=jnp.int32)
    # block 0's partials double as the scan init (pytree-shaped)
    acc0 = _chunk_mono_partials(
        mrf, coef_mono, lnZ, jnp.int32(0), offset, cb)
    if mrf.n > cb:
        # fori_loop, not scan-over-arange: near the n<=47 cap the
        # block-index xs array alone would be hundreds of MB of HBM
        def step(blk, acc):
            new = _chunk_mono_partials(mrf, coef_mono, lnZ, blk, offset, cb)
            return jax.tree.map(jnp.add, acc, new)

        acc0 = jax.lax.fori_loop(1, 1 << (mrf.n - cb), step, acc0)
    return _masks_from_monomials(
        _assemble_mono(acc0, mrf.cliques), mrf.cliques)


def lnz_and_moments_streaming(mrf: MRF):
    """``(lnZ, E_p[phi])``: the lnZ sweep, then the moment sweep it
    normalizes — what an exact-MLE training step needs (its NLL takes
    lnZ forward and the moments as its gradient)."""
    from qcmrf_tpu.ops import kernels

    lnZ = kernels.log_partition(mrf)
    return lnZ, clique_moments_streaming(mrf, lnZ)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _lnZ_streaming(cliques: tuple, n: int, beta: float, theta):
    m = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
    from qcmrf_tpu.ops import kernels

    return kernels.log_partition(m)


def _lnZ_fwd(cliques, n, beta, theta):
    # under differentiation the fused sweep computes lnZ AND the
    # gradient's moments together; value-only callers run the primal
    # body above (one plain lnZ sweep) instead
    m = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
    lnZ, mu = lnz_and_moments_streaming(m)
    return lnZ, mu


def _lnZ_bwd(cliques, n, beta, mu, g):
    return (beta * mu * g,)


_lnZ_streaming.defvjp(_lnZ_fwd, _lnZ_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3))
def _lnZ_streaming_sharded(cliques: tuple, n: int, beta: float, mesh,
                           theta):
    from qcmrf_tpu.parallel import sharded

    m = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
    return sharded.sharded_log_partition(m, mesh)


def _lnZ_sharded_fwd(cliques, n, beta, mesh, theta):
    from qcmrf_tpu.parallel import sharded

    m = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
    lnZ, mu = sharded.sharded_lnz_and_moments(m, mesh)
    return lnZ, mu


def _lnZ_sharded_bwd(cliques, n, beta, mesh, mu, g):
    return (beta * mu * g,)


_lnZ_streaming_sharded.defvjp(_lnZ_sharded_fwd, _lnZ_sharded_bwd)


def log_partition_streaming(mrf: MRF, mesh=None) -> jax.Array:
    """``ln Z`` differentiable w.r.t. ``mrf.theta`` with the gradient
    computed by the streaming moment sweep (``beta * E_p[phi]``) instead
    of autodiff through a 2^n table — exact MLE for arbitrary clique
    structures past table widths. ``beta`` is treated as a constant
    (must be a concrete host value, the QCMRF training convention).
    With ``mesh``, both the forward lnZ sweep and the gradient's moment
    sweep shard over the device mesh (parallel/sharded.py)."""
    if mesh is not None:
        from qcmrf_tpu.parallel import sharded

        # evidence-reduced models can shrink below the mesh size; the
        # single-device sweep is then the same answer without the
        # negative-shift crash in the per-device slice arithmetic
        if sharded.fit_mesh(mesh, mrf.n) is not None:
            return _lnZ_streaming_sharded(
                mrf.cliques, mrf.n, float(mrf.beta), mesh, mrf.theta
            )
    return _lnZ_streaming(mrf.cliques, mrf.n, float(mrf.beta), mrf.theta)


# --------------------------------------------------------------------------
# Conditional inference for arbitrary structure: clamp evidence by exact
# clique-table reduction, then any lnZ backend covers the free variables.
# --------------------------------------------------------------------------


def reduce_evidence(mrf: MRF, evidence: dict):
    """(reduced MRF over the free variables, clamped log-potential
    constant) — EXACT evidence clamping by clique-table slicing.

    Each clique slot carrying an evidence variable is sliced to its
    observed value (theta layout: y binary-counting, slot 0 slowest —
    utils/bits.py), cliques fully determined by evidence fold into the
    returned constant, and the surviving scopes relabel onto the free
    variables in ascending order (free variable ``free[i]`` becomes
    variable ``i``). Identity: ``ln sum_{x ~ e} e^{beta theta^T phi(x)}
    = beta * const + lnZ(reduced)``. Host-side structure surgery only —
    theta stays traced, so the reduction composes with jit/grad. The
    multi-chip counterpart of elimination's clamped pass
    (models/elimination.py::_build_lnZ_clamped) with no treewidth bound:
    the reduced model runs through any lnZ backend, including the
    streaming sweeps and the sharded sweeps."""
    from qcmrf_tpu.models import elimination as _ve

    _ve._validate_evidence(mrf.n, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    free = [v for v in range(mrf.n) if v not in ev]
    rank = {v: i for i, v in enumerate(free)}
    const = jnp.zeros((), mrf.theta.dtype)
    new_cliques, new_thetas = [], []
    off = 0
    for C in mrf.cliques:
        c = len(C)
        tab = mrf.theta[off: off + (1 << c)].reshape((2,) * c)
        idx = tuple(ev[v] if v in ev else slice(None) for v in C)
        tab = tab[idx]
        scope = [rank[v] for v in C if v not in ev]
        if scope:
            new_cliques.append(scope)
            new_thetas.append(tab.reshape(-1))
        else:
            const = const + tab.reshape(())
        off += 1 << c
    nf = len(free)
    if not new_cliques:
        if nf == 0:
            # every variable observed
            return None, const
        # every clique folded into the constant, but free variables
        # remain: they are isolated (in no clique) in the original
        # model, so the free-variable distribution is uniform — keep it
        # representable with one zero-potential clique
        new_cliques = [[0]]
        new_thetas = [jnp.zeros((2,), mrf.theta.dtype)]
    # n=nf explicitly: a free variable that was isolated in the
    # original model appears in no reduced clique, and inferring n from
    # the cliques would silently drop it (losing ln2 per variable in
    # lnZ and misaligning sample/MAP bit re-embedding)
    red = MRF.create(new_cliques, theta=jnp.concatenate(new_thetas),
                     beta=mrf.beta, n=nf)
    return red, const


def log_partition_clamped_streaming(mrf: MRF, evidence: dict,
                                    mesh=None) -> jax.Array:
    """Unnormalized log-mass of the evidence for ARBITRARY structure:
    ``ln sum_{x ~ e} e^{beta theta^T phi(x)}`` by exact clique-table
    reduction (:func:`reduce_evidence`) + a streaming lnZ sweep of the
    free-variable model — same contract as
    ``models.elimination.log_partition_clamped`` without its treewidth
    bound. With ``mesh`` the sweep shards over the devices.
    Differentiable w.r.t. ``mrf.theta`` (the reduced tables are slices
    of theta and the lnZ sweep carries the moment-sweep VJP of
    :func:`log_partition_streaming`)."""
    red, const = reduce_evidence(mrf, evidence)
    if red is None:
        return mrf.beta * const
    return mrf.beta * const + log_partition_streaming(red, mesh)


def conditional_prob_streaming(mrf: MRF, v: int, value: int,
                               evidence: dict = None,
                               mesh=None) -> jax.Array:
    """Exact ``P(x_v = value | evidence)`` for arbitrary structure by
    two clamped streaming sweeps (mirrors
    ``models.elimination.conditional_prob``, which needs bounded
    treewidth; this needs only sweepable width). Conflicting evidence on
    ``v`` itself short-circuits to 0 or 1."""
    from qcmrf_tpu.models import elimination as _ve

    evidence = dict(evidence or {})
    _ve._validate_evidence(mrf.n, {**evidence, v: value})
    if int(v) in {int(u) for u in evidence}:
        agree = int(evidence[[u for u in evidence
                              if int(u) == int(v)][0]]) == int(value)
        return jnp.asarray(1.0 if agree else 0.0, mrf.theta.dtype)
    num = log_partition_clamped_streaming(
        mrf, {**evidence, v: value}, mesh)
    if evidence:
        den = log_partition_clamped_streaming(mrf, evidence, mesh)
    else:
        den = log_partition_streaming(mrf, mesh)
    return jnp.exp(num - den)


def clique_marginals_clamped_streaming(mrf: MRF, evidence: dict = None,
                                       mesh=None) -> jax.Array:
    """Conditional clique marginals ``E_p[phi | evidence]`` in the
    ORIGINAL theta layout, for arbitrary structure.

    The evidence reduces the model exactly (:func:`reduce_evidence`),
    the free-variable model's moments come from the streaming sweep
    (:func:`clique_moments_streaming`; with ``mesh`` the sharded
    sweep), and each clique's reduced table re-embeds at its
    evidence-consistent rows — evidence-inconsistent rows are exactly
    zero, and fully-determined cliques are one-hot at the observed row.
    With no evidence this is exactly the unconditioned moment sweep.
    The conditional form of the reference oracle's marginal task
    (models/elimination.py::clique_marginals covers bounded treewidth;
    this has no width bound)."""
    import numpy as np

    from qcmrf_tpu.models import elimination as _ve

    evidence = dict(evidence or {})
    if not evidence:
        if mesh is not None:
            from qcmrf_tpu.parallel import sharded

            mesh = sharded.fit_mesh(mesh, mrf.n)
        if mesh is not None:
            from qcmrf_tpu.parallel import sharded

            return sharded.sharded_clique_moments(mrf, mesh)
        return clique_moments_streaming(mrf)
    _ve._validate_evidence(mrf.n, evidence)
    red, _ = reduce_evidence(mrf, evidence)
    if mesh is not None and red is not None:
        from qcmrf_tpu.parallel import sharded

        mesh = sharded.fit_mesh(mesh, red.n)
    if red is None:
        rmom = np.zeros((0,), np.float64)
    elif mesh is not None:
        from qcmrf_tpu.parallel import sharded

        rmom = np.asarray(
            sharded.sharded_clique_moments(red, mesh), np.float64)
    else:
        rmom = np.asarray(clique_moments_streaming(red), np.float64)
    return embed_clamped_marginals(mrf, evidence, rmom)


def marginal_map_streaming(mrf: MRF, max_vars, evidence: dict = None,
                           mesh=None):
    """Marginal MAP for ARBITRARY structure: ``(assignment, value)``
    with ``value = max_{x_M} ln sum_{x_S} e^{beta theta^T phi(x)}``
    under the evidence — by enumerating the ``2^|M|`` max-variable
    assignments, each scored with one clamped streaming lnZ sweep
    (:func:`log_partition_clamped_streaming`; with ``mesh`` each sweep
    shards over the devices). The arbitrary-width counterpart of
    ``models.elimination.marginal_map`` (whose constrained elimination
    needs bounded constrained width); cost is ``2^|M|`` sweeps, so it
    suits few max variables over wide models — the regime elimination
    cannot touch at all. Observed max variables are pinned by the
    evidence."""
    from qcmrf_tpu.models import elimination as _ve

    evidence = dict(evidence or {})
    _ve._validate_evidence(mrf.n, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    req = _ve._validate_max_vars(mrf.n, max_vars)
    M = [v for v in req if v not in ev]
    m = len(M)
    best_val, best_bits = -float("inf"), 0
    for a in range(1 << m):
        bits = {M[j]: (a >> (m - 1 - j)) & 1 for j in range(m)}
        val = float(log_partition_clamped_streaming(
            mrf, {**ev, **bits}, mesh))
        if val > best_val:
            best_val, best_bits = val, a
    assignment = {
        v: (ev[v] if v in ev
            else (best_bits >> (m - 1 - M.index(v))) & 1)
        for v in req
    }
    return assignment, best_val


def embed_clamped_marginals(mrf: MRF, evidence: dict,
                            red_moments) -> jax.Array:
    """Re-embed the evidence-reduced model's moment vector (theta
    layout of ``reduce_evidence``'s model, any backend) into the
    ORIGINAL theta layout: reduced rows land at their
    evidence-consistent indices, other rows are zero, fully-determined
    cliques are one-hot at the observed row."""
    import numpy as np

    ev = {int(v): int(b) for v, b in evidence.items()}
    rmom = np.asarray(red_moments, np.float64)
    out = np.zeros((mrf.dimension,), np.float64)
    off = roff = 0
    for C in mrf.cliques:
        c = len(C)
        surv = [s for s, v in enumerate(C) if int(v) not in ev]
        base = 0
        for s, v in enumerate(C):
            if int(v) in ev:
                base |= ev[int(v)] << (c - 1 - s)
        if not surv:
            out[off + base] = 1.0
        else:
            m = len(surv)
            for j in range(1 << m):
                idx = base
                for t, s in enumerate(surv):
                    idx |= ((j >> (m - 1 - t)) & 1) << (c - 1 - s)
                out[off + idx] = rmom[roff + j]
            roff += 1 << m
        off += 1 << c
    return jnp.asarray(out, mrf.theta.dtype)
