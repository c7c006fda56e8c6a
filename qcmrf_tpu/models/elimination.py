"""Exact inference by variable elimination, in JAX (differentiable, jit).

The reference's native oracle (`kiopto_native`) computes partition
functions by native exact inference (SURVEY.md §1 L0); our C++ engine
(qcmrf_tpu/native) replicates that host-side with bucket elimination. This
module is the **device-side** counterpart: because the clique structure is
static, the entire elimination schedule — which factors combine, every
intermediate factor's scope and shape — is known at trace time, so the
whole algorithm lowers to a fixed sequence of broadcast-adds and
logsumexp reductions over small dense tensors. Consequences:

* cost scales with treewidth, not 2**n: a 4 x C grid (treewidth 4) is
  exact at ANY length — far beyond the 2**n state-table ceiling (n <= 30)
  of the enumeration paths;
* it is pure jnp, so ``jax.grad`` of ln Z gives exact clique marginals
  (E_p[phi]) and exact-MLE training works on graphs of hundreds of
  variables;
* everything is static-shape: one jit compilation per graph structure.

Log-domain throughout; factors are dense arrays over their scope with the
scope's variables in ascending order, one axis per variable (axis order =
sorted variable order, matching the C++ engine's layout).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qcmrf_tpu.models.mrf import MRF


def min_degree_order(cliques: Sequence[Sequence[int]], n: int,
                     defer: Sequence[int] = ()) -> List[int]:
    """Min-degree elimination order (same heuristic as native/kiopto.cpp).

    Variables in ``defer`` are eliminated only after every other
    variable (min-degree within each phase) — the constrained order a
    marginal-MAP pass needs, where the max variables must come last."""
    adj = [set() for _ in range(n)]
    for C in cliques:
        for a in C:
            for b in C:
                if a != b:
                    adj[a].add(b)
    deferred = set(int(v) for v in defer)
    done = [False] * n
    order = []
    for _ in range(n):
        best, best_key = -1, None
        for v in range(n):
            if done[v]:
                continue
            deg = sum(1 for u in adj[v] if not done[u])
            key = (v in deferred, deg)
            if best_key is None or key < best_key:
                best, best_key = v, key
        order.append(best)
        done[best] = True
        nb = [u for u in adj[best] if not done[u]]
        for a in nb:
            for b in nb:
                if a != b:
                    adj[a].add(b)
    return order


class _Step:
    """One elimination step: which pool factors combine, the combined
    scope, and the axis summed out."""

    __slots__ = ("factor_ids", "scope", "out_scope", "axis")

    def __init__(self, factor_ids, scope, out_scope, axis):
        self.factor_ids = factor_ids
        self.scope = scope
        self.out_scope = out_scope
        self.axis = axis


def _plan(cliques: Sequence[Tuple[int, ...]], n: int,
          order: Sequence[int] = None):
    """Static elimination schedule. Returns (steps, isolated_count).

    Pool entries are (scope tuple, source): source is either ('clique', k)
    for an input factor or ('step', i) for an intermediate.
    """
    if order is None:
        order = min_degree_order(cliques, n)
    pool = [(tuple(sorted(C)), ("clique", k)) for k, C in enumerate(cliques)]
    steps: List[_Step] = []
    isolated = 0
    for v in order:
        touching = [(s, src) for s, src in pool if v in s]
        rest = [(s, src) for s, src in pool if v not in s]
        if not touching:
            isolated += 1
            pool = rest
            continue
        scope = tuple(sorted(set().union(*[set(s) for s, _ in touching])))
        out_scope = tuple(u for u in scope if u != v)
        steps.append(_Step([src for _, src in touching], scope, out_scope,
                           scope.index(v)))
        pool = rest
        if out_scope:
            pool.append((out_scope, ("step", len(steps) - 1)))
    return steps, isolated


@functools.lru_cache(maxsize=1024)
def _plan_stats(cliques: Tuple[Tuple[int, ...], ...], n: int):
    """(width, total table floats) of the min-degree plan — cached so
    routing layers that consult both don't replan per call."""
    steps, _ = _plan(cliques, n)
    width = max((len(st.scope) for st in steps), default=0)
    return width, sum(1 << len(st.scope) for st in steps)


def induced_width(cliques, n: int) -> int:
    """Largest combined factor SCOPE SIZE of the min-degree elimination
    plan — the exponent of this module's per-step table cost (2^width).
    NOTE: the scope includes the variable being eliminated, so this is
    the textbook induced width PLUS ONE (K_n returns n, a chain returns
    2); it is the table exponent that callers budget against, and
    _ELIM_WIDTH_CAP in models/train.py is expressed in the same unit.
    Callers route high-width structures to streaming enumeration instead
    (models.moments), since elimination's tables blow up in it."""
    return _plan_stats(tuple(tuple(sorted(C)) for C in cliques), n)[0]


def plan_table_floats(cliques, n: int) -> int:
    """Total floats of ALL step tables of the min-degree plan,
    ``sum_steps 2^|scope|`` — the live-memory unit for passes that keep
    every step's table (the ancestral sampler's stored factors, and
    roughly the transient peak of the lnZ/MAP passes). A long
    bounded-width model (say a 20x200 grid: width 21 but ~4000 steps)
    passes a per-step width cap yet needs tens of GB here, so samplers
    budget against THIS number too (round-4 review finding)."""
    return _plan_stats(tuple(tuple(sorted(C)) for C in cliques), n)[1]


def _clique_log_factor(mrf: MRF, k: int) -> jax.Array:
    """Clique k's theta table as a log-factor over its sorted scope."""
    C = mrf.cliques[k]
    m = len(C)
    off = mrf.theta_offsets[k]
    tab = mrf.beta * mrf.theta[off: off + (1 << m)]
    # theta layout: clique-order, first variable slowest -> axes in clique
    # order; transpose to sorted-variable order
    tab = tab.reshape((2,) * m)
    # target axis j holds sorted(C)[j]; its source axis is argsort(C)[j]
    return jnp.transpose(tab, axes=[int(a) for a in np.argsort(C)])


def _expand(f: jax.Array, scope: Tuple[int, ...],
            target: Tuple[int, ...]) -> jax.Array:
    """Broadcast a log-factor over ``scope`` to the superset ``target``."""
    shape = [2 if u in scope else 1 for u in target]
    return f.reshape(shape)


def _combine_step(st: "_Step", clique_scopes, clique_factors,
                  step_results, steps, dtype) -> jax.Array:
    """Sum (log-domain product) of every factor touching this step's
    variable, broadcast to the combined scope — shared by the sum-product
    (lnZ), clamped, and max-product (MAP) passes. ``clique_scopes[idx]``
    is the sorted scope of ``clique_factors[idx]`` (already reduced for
    the clamped pass)."""
    acc = jnp.zeros((2,) * len(st.scope), dtype)
    for kind, idx in st.factor_ids:
        f = clique_factors[idx] if kind == "clique" else step_results[idx]
        src_scope = (clique_scopes[idx] if kind == "clique"
                     else steps[idx].out_scope)
        acc = acc + _expand(f, src_scope, st.scope)
    return acc


@functools.lru_cache(maxsize=256)
def _build_lnZ(cliques: Tuple[Tuple[int, ...], ...], n: int):
    steps, isolated = _plan(cliques, n)

    def lnZ(theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
        clique_factors = [
            _clique_log_factor(mrf, k) for k in range(len(cliques))
        ]
        step_results: List[jax.Array] = []
        const = isolated * jnp.log(2.0)
        for st in steps:
            acc = _combine_step(
                st, [tuple(sorted(C)) for C in cliques], clique_factors,
                step_results, steps, theta.dtype)
            reduced = jax.scipy.special.logsumexp(acc, axis=st.axis)
            step_results.append(reduced)
            if not st.out_scope:
                const = const + reduced
        return const

    return jax.jit(lnZ)


def log_partition(mrf: MRF) -> jax.Array:
    """``ln Z`` by variable elimination — exact at any n for bounded
    treewidth; differentiable (grad gives beta * E_p[phi] via the chain
    rule on theta)."""
    fn = _build_lnZ(mrf.cliques, mrf.n)
    return fn(mrf.theta, mrf.beta)


# --------------------------------------------------------------------------
# Conditional inference: clamp evidence variables, eliminate the rest.
# --------------------------------------------------------------------------


def _reduce_factors(mrf: MRF, ev: dict, red_scopes):
    """Slice the evidence axes out of every clique log-factor
    (descending so axis ids stay valid). Returns ``(reduced_factors,
    const, covered)``: the factors with nonempty reduced scope, the
    folded sum of fully-observed cliques, and the set of free variables
    appearing in some reduced factor — shared by the clamped-lnZ and
    marginal-MAP builders so the evidence-slicing logic cannot
    diverge between them (round-4 review finding)."""
    reduced_factors = []
    const = jnp.zeros((), mrf.theta.dtype)
    for k, C in enumerate(mrf.cliques):
        f = _clique_log_factor(mrf, k)
        scope = tuple(sorted(C))
        for ax in range(len(scope) - 1, -1, -1):
            if scope[ax] in ev:
                f = jnp.take(f, ev[scope[ax]], axis=ax)
        if red_scopes[k]:
            reduced_factors.append(f)
        else:
            const = const + f  # fully observed clique: scalar
    covered = set().union(*[set(s) for s in red_scopes if s]) \
        if any(red_scopes) else set()
    return reduced_factors, const, covered


@functools.lru_cache(maxsize=256)
def _build_lnZ_clamped(cliques: Tuple[Tuple[int, ...], ...], n: int,
                       evidence: Tuple[Tuple[int, int], ...]):
    ev = dict(evidence)
    # reduced clique scopes (evidence vars sliced out of each factor)
    red_scopes = [
        tuple(v for v in sorted(C) if v not in ev) for C in cliques
    ]
    # plan over the nonempty reduced scopes; free-variable factors of 2
    # are accounted for explicitly below (NOT via _plan's isolated count,
    # which would also count the clamped evidence variables)
    steps, _ = _plan([s for s in red_scopes if s], n)

    def lnZ(theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
        reduced_factors, const, covered = _reduce_factors(
            mrf, ev, red_scopes)
        # unobserved variables appearing in no reduced factor: factor 2
        free = set(range(n)) - set(ev) - covered
        const = const + len(free) * jnp.log(2.0)

        step_results: List[jax.Array] = []
        nonempty = [s for s in red_scopes if s]
        for st in steps:
            acc = _combine_step(st, nonempty, reduced_factors,
                                step_results, steps, theta.dtype)
            reduced = jax.scipy.special.logsumexp(acc, axis=st.axis)
            step_results.append(reduced)
            if not st.out_scope:
                const = const + reduced
        return const

    return jax.jit(lnZ)


def _validate_evidence(n: int, evidence: dict) -> None:
    for v, b in evidence.items():
        if not 0 <= int(v) < n:
            raise ValueError(f"evidence variable {v} out of range [0, {n})")
        if int(b) not in (0, 1):
            raise ValueError(f"evidence value {b} for variable {v} is not "
                             "a binary state (jnp.take would silently "
                             "clamp it)")


def log_partition_clamped(mrf: MRF, evidence: dict) -> jax.Array:
    """Unnormalized log-mass of the evidence: ``ln sum_{x ~ e} e^{beta
    theta^T phi(x)}``. ``ln P(e) = log_partition_clamped - log_partition``;
    single-variable conditionals follow by clamping one more variable."""
    _validate_evidence(mrf.n, evidence)
    ev = tuple(sorted((int(v), int(b)) for v, b in evidence.items()))
    fn = _build_lnZ_clamped(mrf.cliques, mrf.n, ev)
    return fn(mrf.theta, mrf.beta)


def conditional_prob(mrf: MRF, v: int, value: int,
                     evidence: dict = None) -> jax.Array:
    """Exact ``P(x_v = value | evidence)`` by two clamped eliminations.

    Conflicting evidence on ``v`` itself short-circuits to 0 or 1 (the
    clamped ratio would otherwise compute a cross-mass quotient)."""
    evidence = dict(evidence or {})
    _validate_evidence(mrf.n, {**evidence, v: value})
    if int(v) in {int(u) for u in evidence}:
        agree = int(evidence[[u for u in evidence
                              if int(u) == int(v)][0]]) == int(value)
        return jnp.asarray(1.0 if agree else 0.0, mrf.theta.dtype)
    num = log_partition_clamped(mrf, {**evidence, v: value})
    den = log_partition_clamped(mrf, evidence) if evidence else (
        log_partition(mrf)
    )
    return jnp.exp(num - den)


def clique_marginals(mrf: MRF) -> jax.Array:
    """Exact ``E_p[phi]`` (d,) by autodiff through elimination."""
    fn = _build_lnZ(mrf.cliques, mrf.n)

    def lnZ_of_theta(theta):
        return fn(theta, mrf.beta)

    return jax.grad(lnZ_of_theta)(mrf.theta) / mrf.beta


# --------------------------------------------------------------------------
# Max-product elimination with traceback: exact MAP (and, with Gumbel
# perturbations, perturb-and-MAP sampling) at any n for bounded treewidth.
# The native engine does the same host-side (kiopto.cpp qk_map/qk_sample_pam);
# this is the jit-able, vmap-able device version.
# --------------------------------------------------------------------------


def _gather_bits(table: jax.Array, scope: Tuple[int, ...],
                 bits: jax.Array) -> jax.Array:
    """Dynamic lookup ``table[bits[scope[0]], bits[scope[1]], ...]``."""
    flat = table.reshape(-1)
    idx = jnp.zeros((), jnp.int32)
    m = len(scope)
    for i, u in enumerate(scope):
        idx = idx + (bits[u] << (m - 1 - i))
    return flat[idx]


@functools.lru_cache(maxsize=256)
def _build_map(cliques: Tuple[Tuple[int, ...], ...], n: int):
    steps, _ = _plan(cliques, n)

    def map_bits(theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
        clique_factors = [
            _clique_log_factor(mrf, k) for k in range(len(cliques))
        ]
        step_results: List[jax.Array] = []
        argmaxes: List[jax.Array] = []
        for st in steps:
            acc = _combine_step(
                st, [tuple(sorted(C)) for C in cliques], clique_factors,
                step_results, steps, theta.dtype)
            step_results.append(jnp.max(acc, axis=st.axis))
            argmaxes.append(jnp.argmax(acc, axis=st.axis).astype(jnp.int32))

        # backtrack in reverse elimination order: every variable of a
        # step's out_scope is decided by a later step, so its bits are
        # already known when we look up this step's argmax table
        bits = jnp.zeros((n,), jnp.int32)
        for st, am in zip(reversed(steps), reversed(argmaxes)):
            v = st.scope[st.axis]
            bits = bits.at[v].set(_gather_bits(am, st.out_scope, bits))
        return bits

    return jax.jit(map_bits)


def map_state_bits(mrf: MRF) -> jax.Array:
    """Exact MAP assignment as per-variable bits (n,), by max-product
    elimination with traceback."""
    fn = _build_map(mrf.cliques, mrf.n)
    return fn(mrf.theta, mrf.beta)


# --------------------------------------------------------------------------
# Marginal MAP: max over a chosen variable set of the summed mass over the
# rest — the remaining member of the standard query family (PR / MAR / MPE
# covered above). Exact by CONSTRAINED elimination: sum variables must be
# eliminated before max variables (the operators do not commute), so the
# min-degree order defers the max set to a second, max-product phase with
# traceback. Complexity is governed by the CONSTRAINED induced width,
# which can exceed the unconstrained one. The reference oracle exposes
# only partition/MAP/sampling (/root/reference/eval.py:88-113); this
# completes the query set the serving CLI offers.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def _mmap_plan(cliques: Tuple[Tuple[int, ...], ...], n: int,
               max_set: Tuple[int, ...],
               evidence: Tuple[Tuple[int, int], ...]):
    """Constrained (sum-first, max-last) elimination plan over the
    evidence-reduced scopes. Returns ``(red_scopes, free, steps)``.
    Cached: one mmap query consults it from mmap_width, marginal_map's
    cap check, AND _build_mmap (round-4 review found it replanned
    three times per query)."""
    ev = dict(evidence)
    red_scopes = [
        tuple(v for v in sorted(C) if v not in ev) for C in cliques
    ]
    free = [v for v in range(n) if v not in ev]
    order = [v for v in min_degree_order(
        [s for s in red_scopes if s], n, defer=max_set) if v in set(free)]
    steps, _ = _plan([s for s in red_scopes if s], n, order=order)
    return red_scopes, free, steps


def mmap_width(cliques, n: int, max_vars, evidence: dict = None) -> int:
    """Largest combined factor scope of the CONSTRAINED elimination plan
    :func:`marginal_map` runs (sum variables first, max variables last)
    — same table-exponent unit as :func:`induced_width`, but it can be
    MUCH larger than the unconstrained width (a star graph has width 2
    unconstrained but |leaves|+1 when every leaf is a max variable), so
    callers must route on THIS number, not ``induced_width``."""
    ev = {int(v): int(b) for v, b in (evidence or {}).items()}
    M = tuple(v for v in sorted({int(u) for u in max_vars})
              if v not in ev)
    _, _, steps = _mmap_plan(
        tuple(tuple(sorted(C)) for C in cliques), n, M,
        tuple(sorted(ev.items())))
    return max((len(st.scope) for st in steps), default=0)


#: default cap on marginal_map's constrained elimination width — a
#: 2^30-entry float32 message table is ~4 GB; beyond that the dense
#: pass wedges the process rather than answering. Value in capability.py.
from qcmrf_tpu.models.capability import MMAP_WIDTH_CAP as _MMAP_WIDTH_CAP


@functools.lru_cache(maxsize=256)
def _build_mmap(cliques: Tuple[Tuple[int, ...], ...], n: int,
                max_set: Tuple[int, ...],
                evidence: Tuple[Tuple[int, int], ...]):
    ev = dict(evidence)
    mx = set(max_set)
    red_scopes, free, steps = _mmap_plan(cliques, n, max_set, evidence)

    def mmap(theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
        reduced_factors, const, covered = _reduce_factors(
            mrf, ev, red_scopes)
        # free variables in no factor: sum variables contribute ln 2,
        # max variables contribute 0 (their argmax ties at bit 0)
        const = const + sum(
            1 for v in free if v not in covered and v not in mx
        ) * jnp.log(2.0)

        step_results: List[jax.Array] = []
        argmaxes: List[jax.Array] = []  # None placeholders for sum steps
        nonempty = [s for s in red_scopes if s]
        for st in steps:
            acc = _combine_step(st, nonempty, reduced_factors,
                                step_results, steps, theta.dtype)
            if st.scope[st.axis] in mx:
                step_results.append(jnp.max(acc, axis=st.axis))
                argmaxes.append(
                    jnp.argmax(acc, axis=st.axis).astype(jnp.int32))
            else:
                step_results.append(
                    jax.scipy.special.logsumexp(acc, axis=st.axis))
                argmaxes.append(None)
            if not st.out_scope:
                const = const + step_results[-1]

        # traceback over the max-phase steps only; by the constrained
        # order every factor live in that phase has scope inside the max
        # set, so each argmax table's out_scope bits are already decided
        bits = jnp.zeros((n,), jnp.int32)
        for st, am in zip(reversed(steps), reversed(argmaxes)):
            if am is not None:
                v = st.scope[st.axis]
                bits = bits.at[v].set(_gather_bits(am, st.out_scope, bits))
        return bits, const

    return jax.jit(mmap)


def _validate_max_vars(n: int, max_vars) -> list:
    """Dedup, sort, and range-check a marginal-MAP max-variable set —
    shared by the elimination and streaming backends (they previously
    carried verbatim copies; round-4 review finding)."""
    req = sorted({int(v) for v in max_vars})
    for v in req:
        if not 0 <= v < n:
            raise ValueError(f"max variable {v} out of range [0, {n})")
    return req


def marginal_map(mrf: MRF, max_vars, evidence: dict = None,
                 width_cap: int = _MMAP_WIDTH_CAP):
    """Exact marginal MAP: ``(assignment, value)`` with
    ``value = max_{x_M} ln sum_{x_S} e^{beta theta^T phi(x)}`` under the
    evidence, ``M = max_vars`` (minus observed ones, which are pinned),
    ``S`` the remaining free variables. ``assignment`` maps every
    requested max variable to its optimizing bit (host ints); with
    ``M`` = all free variables this is the clamped MAP, with ``M`` empty
    it is ``log_partition_clamped``. Cost: one constrained elimination
    (sum-out phase, then max phase with traceback) — the CONSTRAINED
    induced width (:func:`mmap_width`) governs it and can far exceed the
    unconstrained one; widths past ``width_cap`` raise instead of
    materializing a multi-GB message table (pass ``width_cap=None`` to
    override; ``moments.marginal_map_streaming`` covers the wide
    regime at ``2^|M|`` sweeps)."""
    evidence = dict(evidence or {})
    _validate_evidence(mrf.n, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    req = _validate_max_vars(mrf.n, max_vars)
    M = tuple(v for v in req if v not in ev)
    evt = tuple(sorted(ev.items()))
    if width_cap is not None:
        w = mmap_width(mrf.cliques, mrf.n, M, ev)
        if w > width_cap:
            raise ValueError(
                f"marginal_map's constrained elimination width is {w} "
                f"(a 2^{w}-entry message table), over width_cap="
                f"{width_cap}; use moments.marginal_map_streaming for "
                f"few max variables over wide structures, or pass "
                f"width_cap=None to force it")
    fn = _build_mmap(mrf.cliques, mrf.n, M, evt)
    bits, val = fn(mrf.theta, mrf.beta)
    bits = np.asarray(bits)
    assignment = {v: (ev[v] if v in ev else int(bits[v])) for v in req}
    return assignment, float(val)


@functools.lru_cache(maxsize=256)
def _build_sampler(cliques: Tuple[Tuple[int, ...], ...], n: int):
    """Exact ancestral sampler over the elimination plan (forward
    filtering, backward sampling). The forward sum-product pass stores
    each step's PRE-sum combined log-factor; the backward pass walks the
    steps in reverse — every variable of a step's out_scope was
    eliminated later, so its bit is already drawn — and samples the
    step's variable from the normalized 2-slice of that stored factor
    at the drawn out_scope bits. The chain of those conditionals is
    exactly the Gibbs joint, so the draws are IID and exact at any n
    for bounded induced width (the stored factors cost
    ``sum_steps 2^|scope|`` floats ONCE, shared across samples; the
    per-sample backward work is ~n two-entry gathers, vmapped)."""
    steps, _ = _plan(cliques, n)
    decided = {st.scope[st.axis] for st in steps}
    iso = tuple(v for v in range(n) if v not in decided)

    def sample(theta, beta, keys):
        mrf = MRF(theta=theta, beta=beta, cliques=cliques, n=n)
        scopes = [tuple(sorted(C)) for C in cliques]
        clique_factors = [
            _clique_log_factor(mrf, k) for k in range(len(cliques))
        ]
        accs: List[jax.Array] = []
        step_results: List[jax.Array] = []
        for st in steps:
            acc = _combine_step(st, scopes, clique_factors, step_results,
                                steps, theta.dtype)
            accs.append(acc)
            step_results.append(
                jax.scipy.special.logsumexp(acc, axis=st.axis))

        def one(k):
            ks = jax.random.split(k, len(steps) + 1)
            bits = jnp.zeros((n,), jnp.int32)
            for i, (st, acc) in enumerate(
                    zip(reversed(steps), reversed(accs))):
                v = st.scope[st.axis]
                t = jnp.moveaxis(acc, st.axis, -1)
                l0 = _gather_bits(t[..., 0], st.out_scope, bits)
                l1 = _gather_bits(t[..., 1], st.out_scope, bits)
                b = jax.random.bernoulli(ks[i], jax.nn.sigmoid(l1 - l0))
                bits = bits.at[v].set(b.astype(jnp.int32))
            if iso:
                # variables in no factor: independent uniform bits
                ib = jax.random.bernoulli(ks[-1], 0.5, (len(iso),))
                bits = bits.at[jnp.asarray(iso)].set(ib.astype(jnp.int32))
            return bits

        return jax.vmap(one)(keys)

    return jax.jit(sample)


#: default cap on the ancestral sampler's STORED step factors
#: (sum_steps 2^|scope| floats). Width alone doesn't bound this — a
#: long bounded-width model multiplies per-step tables by its step
#: count — so the sampler budgets the total. Value in capability.py.
from qcmrf_tpu.models.capability import (
    SAMPLER_TABLE_FLOATS_CAP as _SAMPLER_TABLE_FLOATS_CAP)


def sample_exact_elim(key: jax.Array, mrf: MRF, num_samples: int,
                      table_floats_cap: int = _SAMPLER_TABLE_FLOATS_CAP
                      ) -> jax.Array:
    """IID EXACT samples from the Gibbs distribution as bit arrays
    (num, n) — the large-n counterpart of models.sample.sample_exact
    (which draws from an enumerated ``2**n`` logits table, reference
    target ``px.sample(b)``, /root/reference/eval.py:95-104): forward
    sum-product elimination once, then per-sample backward ancestral
    draws through the stored step factors. Exact (not PAM-approximate)
    at any n for bounded induced width. The stored factors cost
    :func:`plan_table_floats` floats for the whole pass; past
    ``table_floats_cap`` this raises instead of wedging the device
    (pass ``None`` to force it)."""
    if table_floats_cap is not None:
        tf = plan_table_floats(mrf.cliques, mrf.n)
        if tf > table_floats_cap:
            raise ValueError(
                f"ancestral sampling stores every elimination step's "
                f"factor: {tf:.3g} floats here (width "
                f"{induced_width(mrf.cliques, mrf.n)} x ~{mrf.n} steps)"
                f" > cap {table_floats_cap:.3g}; add evidence to shrink "
                f"the model or pass table_floats_cap=None to force it")
    fn = _build_sampler(mrf.cliques, mrf.n)
    return fn(mrf.theta, mrf.beta, jax.random.split(key, num_samples))


def sample_pam(key: jax.Array, mrf: MRF, num_samples: int,
               _max_chunk_states: int = 1 << 22) -> jax.Array:
    """Low-order perturb-and-MAP samples as bit arrays (num, n).

    The large-n counterpart of models.sample.sample_pam (which argmaxes an
    enumerated 2**n table): every sample is an exact MAP of a
    Gumbel-perturbed model, computed by vmapped max-product elimination.
    The vmap runs in sample chunks sized against the induced width so
    the per-chunk message + argmax tables stay ~tens of MB instead of
    scaling with ``num_samples * 2^width`` (results are identical: each
    sample is a pure function of its own split key)."""
    fn = _build_map(mrf.cliques, mrf.n)

    def one(k):
        g = jax.random.gumbel(k, (mrf.dimension,), dtype=mrf.theta.dtype)
        return fn(mrf.beta * mrf.theta + g, jnp.ones((), mrf.theta.dtype))

    keys = jax.random.split(key, num_samples)
    width = induced_width(mrf.cliques, mrf.n)
    per = max(1, _max_chunk_states >> width)  # chunk * 2^width bounded
    if per >= num_samples:
        return jax.vmap(one)(keys)
    out = [jax.vmap(one)(keys[i:i + per])
           for i in range(0, num_samples - per + 1, per)]
    tail = num_samples - (num_samples // per) * per
    if tail:
        out.append(jax.vmap(one)(keys[num_samples - tail:]))
    return jnp.concatenate(out, axis=0)
