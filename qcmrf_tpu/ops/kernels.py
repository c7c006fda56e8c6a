"""State-space sweeps and statevector plane passes in plain JAX.

Two families of hot operations live here. Both are written as
``jax.numpy`` bodies, so XLA compiles each into fused loops on the GPU
and the same code runs on the CPU for the tests.

* **Sweeps over the 2^n state space**: the log-potential table, the
  streaming log-partition function and the streaming MAP argmax. Each
  clique table becomes its multilinear (Moebius) coefficients, and the
  sum over cliques is split at a cut of the state-id bits
  (:func:`_split_logpot`). Cliques wholly below the cut are evaluated
  once on a ``2^L``-state low plane, cliques above it reduce to one
  scalar per ``2^L``-state block, and cut-crossing cliques become
  per-block scalars times loop-invariant low-bit monomial planes. A
  sweep walks tiles of ``2^T`` states in a ``lax.fori_loop`` with a
  running (max, scaled-sum) or (value, tile, row) carry, so no ``2^n``
  table is ever materialised. Offsets are kept in block units, which
  keeps every integer inside int32 past n = 31.
* **Plane passes of the gate-level engine** (:mod:`qcmrf_tpu.sim.tpu`).
  Amplitudes live as float32 real/imag planes of shape
  ``(2^Q / 128, 128)``. Each op (a 1q gate, an adjacent-pair gate, a
  diagonal phase profile, a group of H·D·H ancilla sandwiches) is an
  elementwise body over a reshaped view of the planes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.utils import moebius

LANE = 128
#: below this width the sweeps take the dense table path (one small
#: fusion is cheaper than a loop)
_MIN_KERNEL_N = 10

#: log2 states of a sweep's low plane (the loop-invariant part); the low
#: planes stay small enough for the GPU's L2 cache
_LO_BITS = 16
#: log2 states of one sweep tile (one loop step)
_TILE_BITS = 24


# --------------------------------------------------------------------------
# Log-potential sweeps: out[x] = beta * sum_k theta_k[y_k(x)]
# --------------------------------------------------------------------------


def _moebius_coefficients(mrf: MRF) -> jax.Array:
    """Multilinear coefficients of every clique table, padded (K * 2^cmax,).

    Entry layout per clique: subset ``s`` encoded with bit ``i`` <-> clique
    slot ``i`` (slot order = clique variable order); cliques smaller than
    cmax alias the extra slots down, so their high-subset coefficients
    vanish after the transform. Traceable (theta may be a tracer inside
    shard_map / grad); tiny ((K, 2^cmax)) work.
    """
    from qcmrf_tpu.sim.analytic import _moebius_layout

    idx_map, _, cmax = _moebius_layout(mrf.cliques, mrf.n)
    tab = mrf.theta[jnp.asarray(idx_map)].astype(jnp.float32)
    return moebius.transform(tab, cmax).reshape(-1)


def _split_cliques(cliques: tuple, n: int, L: int):
    """Partition cliques by a block cut at state-id bit ``L``: variable v
    lives in a block's LOW id bits iff its bit position (n-1-v) < L
    (variable 0 = MSB; see utils/bits.py)."""
    low, high, cross = [], [], []
    for k, C in enumerate(cliques):
        inlow = [(n - 1 - v) < L for v in C]
        if all(inlow):
            low.append((k, tuple(C)))
        elif not any(inlow):
            high.append((k, tuple(C)))
        else:
            cross.append((k, tuple(C)))
    return low, high, cross


def _split_logpot(offset, coef, cliques, n: int, L: int):
    """Block-invariant / per-block split of the Moebius log-potential sum
    over blocks of ``2^L`` states.

    Every state id decomposes as ``x = base_blocks * 2^L + offset``, so

    * cliques entirely in LOW id bits contribute identically in every
      block: evaluated ONCE on the offset plane (returned ``acc0``);
    * cliques entirely in HIGH bits reduce to ONE scalar per block;
    * crossing cliques reduce to per-block scalar coefficients times
      loop-invariant low-bit monomial planes.

    Per-block work then scales with the number of cut-crossing cliques,
    not the total clique count (for grid models the cut crosses about
    one column of edges).

    Returns ``(invariants, vary)``: ``invariants`` is a flat tuple of
    low planes (the low-clique accumulator first, then the crossing
    cliques' monomials) and ``vary(base_blocks, invariants)`` evaluates
    the log-potential of every (block, offset) pair by broadcasting
    ``base_blocks`` against the low planes. ``base_blocks`` is the
    absolute block index ``x >> L``: bit ``p`` of x for p >= L is bit
    ``p - L`` of base_blocks, so no integer leaves int32 past the
    2^31-state-id limit.
    """
    cmax = max(len(C) for C in cliques)
    low, high, cross = _split_cliques(cliques, n, L)

    lowvars = [v for _, C in low + cross for v in C if (n - 1 - v) < L]
    planes = moebius.extract_bit_planes(offset, lowvars, n)
    acc0 = jnp.zeros(offset.shape, jnp.float32)
    for k, C in low:
        off = k << cmax
        acc0 = moebius.eval_multilinear(
            [planes[v] for v in C], len(C),
            lambda s, off=off: coef[off + s], acc0,
        )

    # loop-invariant low-bit monomial planes of the crossing cliques,
    # one per (clique, nonempty low-slot subset); slot bit i <-> C[i]
    mono_index = {}
    mono_planes = []
    cross_meta = []
    for k, C in cross:
        L_slots = [i for i, v in enumerate(C) if (n - 1 - v) < L]
        H_slots = [i for i, v in enumerate(C) if (n - 1 - v) >= L]
        for t in range(1, 1 << len(L_slots)):
            sl, p = 0, None
            for j in range(len(L_slots)):
                if (t >> j) & 1:
                    sl |= 1 << L_slots[j]
                    b = planes[C[L_slots[j]]]
                    p = b if p is None else p * b
            mono_index[(k, sl)] = len(mono_planes)
            mono_planes.append(p)
        cross_meta.append((k, C, L_slots, H_slots))

    hvars = sorted({v for _, C in high + cross for v in C
                    if (n - 1 - v) >= L})
    invariants = (acc0,) + tuple(mono_planes)

    def vary(base_blocks, inv):
        acc0, monos = inv[0], inv[1:]
        hb = {v: ((base_blocks >> (n - 1 - v - L)) & 1).astype(jnp.float32)
              for v in hvars}
        sacc = jnp.float32(0.0)
        for k, C in high:
            off = k << cmax
            sacc = moebius.eval_multilinear(
                [hb[v] for v in C], len(C),
                lambda s, off=off: coef[off + s], sacc,
            )
        acc = acc0
        for k, C, L_slots, H_slots in cross_meta:
            off = k << cmax

            def hidx(s, H_slots=H_slots):
                e = 0
                for j in range(len(H_slots)):
                    if (s >> j) & 1:
                        e |= 1 << H_slots[j]
                return e

            for t in range(1 << len(L_slots)):
                sl = 0
                for j in range(len(L_slots)):
                    if (t >> j) & 1:
                        sl |= 1 << L_slots[j]
                # scalar reduced coefficient: the clique's multilinear
                # form marginalized onto this low-slot subset at the
                # block's high bits
                cL = moebius.eval_multilinear(
                    [hb[C[i]] for i in H_slots], len(H_slots),
                    lambda s, off=off, sl=sl, hidx=hidx:
                        coef[off + sl + hidx(s)],
                    jnp.float32(0.0),
                )
                if sl == 0:
                    sacc = sacc + cL
                else:
                    acc = acc + cL * monos[mono_index[(k, sl)]]
        return acc + sacc

    return invariants, vary


def sweep_geometry(num_states: int, lo_bits: int = None,
                   tile_bits: int = None) -> Tuple[int, int]:
    """``(L, T)`` of a sweep over ``num_states`` states: ``2^L``-state low
    planes and ``2^T``-state loop tiles (``L <= T``). The overrides let
    tests force small multi-tile sweeps with high and crossing cliques."""
    logN = num_states.bit_length() - 1
    T = min(logN, _TILE_BITS if tile_bits is None else tile_bits)
    L = min(T, _LO_BITS if lo_bits is None else lo_bits)
    return L, T


def _logpot_tiles(cliques: tuple, n: int, coef, beta, L: int, T: int):
    """``tile(t)``: beta * log-potential of tile ``t`` (absolute index in
    ``2^T``-state units) as a ``(2^(T-L), 2^L)`` array whose row-major
    flattening is the tile's states in order."""
    offset = jnp.arange(1 << L, dtype=jnp.int32)[None, :]
    inv, vary = _split_logpot(offset, coef, cliques, n, L)
    rows = jnp.arange(1 << (T - L), dtype=jnp.int32)[:, None]
    shape = (1 << (T - L), 1 << L)

    def tile(t):
        acc = vary(t * (1 << (T - L)) + rows, inv)
        return beta[0] * jnp.broadcast_to(acc, shape)

    return tile


def lse_block_states(cliques: tuple, n: int, num_states: int) -> int:
    """States per tile of the streaming lnZ sweep: the unit of its
    ``x0_blocks`` argument (callers with a device-slice offset divide by
    this; block units stay inside int32 for n >= 32)."""
    return 1 << sweep_geometry(num_states)[1]


def map_block_states(cliques: tuple, n: int, num_states: int) -> int:
    """States per tile of the streaming MAP sweep: the unit of its
    ``x0_blocks`` argument AND of the (tile, row, lane) id coordinates
    it returns (see :func:`map_partials_decode`)."""
    return lse_block_states(cliques, n, num_states)


def _lse_partials_call(cliques: tuple, n: int, num_states: int, coef,
                       beta, x0_blocks, lo_bits=None, tile_bits=None):
    """Per-lane (max, scaled-sum) over ``num_states`` states starting at
    tile index ``x0_blocks[0]`` (unit: :func:`lse_block_states`)."""
    L, T = sweep_geometry(num_states, lo_bits, tile_bits)
    tile = _logpot_tiles(cliques, n, coef, beta, L, T)

    def step(i, carry):
        m, s = carry
        acc = tile(x0_blocks[0] + i).reshape(-1, LANE)
        bm = jnp.max(acc, axis=0)
        bs = jnp.sum(jnp.exp(acc - bm), axis=0)
        new_m = jnp.maximum(m, bm)
        s = s * jnp.exp(m - new_m) + bs * jnp.exp(bm - new_m)
        return new_m, s

    m0 = jnp.full((LANE,), -jnp.inf, jnp.float32)
    s0 = jnp.zeros((LANE,), jnp.float32)
    return jax.lax.fori_loop(0, num_states >> T, step, (m0, s0))


def _map_partials_call(cliques: tuple, n: int, num_states: int, coef,
                       beta, x0_blocks, lo_bits=None, tile_bits=None):
    """Per-lane (best value, best ABSOLUTE tile, best in-tile row) over
    ``num_states`` states starting at tile index ``x0_blocks[0]``, as a
    (3, LANE) array. The id coordinates ride as float32 (exact below
    2^24 tiles and rows), so the host can rebuild a past-int32 state id
    ``(tile * rows_per_tile + row) * 128 + lane`` with int64 math. Value
    ties resolve to the earliest tile / lowest row; cross-lane ties to
    the lowest lane at decode time (measure-zero for generic theta)."""
    L, T = sweep_geometry(num_states, lo_bits, tile_bits)
    tile = _logpot_tiles(cliques, n, coef, beta, L, T)

    def step(i, carry):
        best, blk, row = carry
        acc = tile(x0_blocks[0] + i).reshape(-1, LANE)
        bm = jnp.max(acc, axis=0)
        br = jnp.argmax(acc, axis=0).astype(jnp.float32)
        upd = bm > best
        best = jnp.where(upd, bm, best)
        blk = jnp.where(upd, (x0_blocks[0] + i).astype(jnp.float32), blk)
        row = jnp.where(upd, br, row)
        return best, blk, row

    best0 = jnp.full((LANE,), -jnp.inf, jnp.float32)
    zero = jnp.zeros((LANE,), jnp.float32)
    return jnp.stack(jax.lax.fori_loop(
        0, num_states >> T, step, (best0, zero, zero)))


def map_partials_decode(cliques: tuple, n: int, num_states: int, out,
                        tile_bits=None):
    """(state_id, value) from one (3, LANE) MAP-partials output: the
    host-side inverse of the sweep's (value, tile, row, lane)
    coordinates, shared by every full-sweep decoder (single-device MAP,
    streaming PAM). ``state_id`` is a host int (int64-safe past n=31)."""
    out = np.asarray(out)
    rows = (1 << sweep_geometry(num_states, tile_bits=tile_bits)[1]) // LANE
    lane = int(np.argmax(out[0]))
    state = (int(out[1, lane]) * rows + int(out[2, lane])) * LANE + lane
    return state, float(out[0, lane])


def _combine_lse(m: jax.Array, s: jax.Array) -> jax.Array:
    """logsumexp from per-lane (max, scaled-sum) partials."""
    M = jnp.max(m)
    return M + jnp.log(jnp.sum(s * jnp.exp(m - M)))


def _logpot_call_sized(cliques: tuple, n: int, fuse_amp: bool,
                       num_states: int, coef, beta, x0):
    """Table of ``num_states`` log-potentials starting at state ``x0[0]``
    (a multiple of the low-plane size); with ``fuse_amp`` the
    post-selected amplitudes ``2^{-n/2} e^{lp/2}`` instead."""
    L, _ = sweep_geometry(num_states)
    offset = jnp.arange(1 << L, dtype=jnp.int32)[None, :]
    inv, vary = _split_logpot(offset, coef, cliques, n, L)
    blocks = (x0[0] >> L) + jnp.arange(num_states >> L,
                                       dtype=jnp.int32)[:, None]
    acc = beta[0] * jnp.broadcast_to(vary(blocks, inv),
                                     (num_states >> L, 1 << L))
    if fuse_amp:
        acc = jnp.exp(0.5 * acc) * np.float32(2.0 ** (-0.5 * n))
    return acc.reshape(-1)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _logpot_call(cliques: tuple, n: int, fuse_amp: bool, coef, beta):
    return _logpot_call_sized(cliques, n, fuse_amp, 1 << n, coef, beta,
                              jnp.zeros((1,), jnp.int32))


def _coef_beta(mrf: MRF):
    return (_moebius_coefficients(mrf),
            jnp.reshape(jnp.asarray(mrf.beta, jnp.float32), (1,)))


def all_log_potentials(mrf: MRF) -> jax.Array:
    """``beta * theta^T phi(x)`` for all ``2**n`` states: the gather-free
    version of ``beta * mrf.all_log_potentials()``."""
    if mrf.n < _MIN_KERNEL_N:
        return mrf.beta * mrf.all_log_potentials()
    return _logpot_call(mrf.cliques, mrf.n, False, *_coef_beta(mrf))


def gibbs_probs(mrf: MRF) -> jax.Array:
    """Exact Gibbs probabilities from the gather-free table."""
    return jax.nn.softmax(all_log_potentials(mrf))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _log_partition_fused(cliques: tuple, n: int, coef, beta):
    m, s = _lse_partials_call(cliques, n, 1 << n, coef, beta,
                              jnp.zeros((1,), jnp.int32))
    return _combine_lse(m, s)


def log_partition(mrf: MRF) -> jax.Array:
    """ln Z by exact enumeration: a streaming sweep (no table) for
    n >= _MIN_KERNEL_N, the dense table below."""
    if mrf.n < _MIN_KERNEL_N:
        return jax.scipy.special.logsumexp(mrf.beta
                                           * mrf.all_log_potentials())
    return _log_partition_fused(mrf.cliques, mrf.n, *_coef_beta(mrf))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _map_partials(cliques: tuple, n: int, coef, beta):
    return _map_partials_call(cliques, n, 1 << n, coef, beta,
                              jnp.zeros((1,), jnp.int32))


def map_state_streaming(mrf: MRF):
    """Exact MAP state id by streaming enumeration, for any clique
    structure at any width the sweep covers (the table-based
    :func:`~qcmrf_tpu.models.sample.map_state` caps at table-sized n,
    variable elimination needs bounded treewidth). Returns
    ``(state_id, beta*logpot)`` with the id a host int (int64-safe past
    n=31). Small n takes the dense argmax."""
    if mrf.n < _MIN_KERNEL_N:
        lp = mrf.beta * mrf.all_log_potentials()
        i = int(jnp.argmax(lp))
        return i, float(lp[i])
    out = _map_partials(mrf.cliques, mrf.n, *_coef_beta(mrf))
    return map_partials_decode(mrf.cliques, mrf.n, 1 << mrf.n, out)


def postselected_amplitudes(mrf: MRF) -> jax.Array:
    """Amplitudes of the all-ancilla-zero branch over all 2**n states:
    the circuit's post-selected wavefunction (SURVEY.md Appendix A item
    5: each clique contributes cos(2*gamma) = e^{beta*theta/2})."""
    if mrf.n < _MIN_KERNEL_N:
        lp = mrf.beta * mrf.all_log_potentials()
        return jnp.exp(0.5 * lp) * (2.0 ** (-0.5 * mrf.n))
    return _logpot_call(mrf.cliques, mrf.n, True, *_coef_beta(mrf))


# --------------------------------------------------------------------------
# Statevector plane passes on (rows, 128) real/imag planes
# --------------------------------------------------------------------------


def _u_array(U) -> jax.Array:
    """A complex gate matrix as a float32 [..., re/im] array, passed to
    the jitted passes as data (one compile per gate shape, not per
    gate)."""
    U = np.asarray(U, dtype=np.complex64)
    return jnp.asarray(np.stack([U.real, U.imag], axis=-1), jnp.float32)


def _matvec(u, vr, vi):
    """Complex ``u @ v`` over python lists of planes; ``u`` is (d, d, 2)."""
    d = len(vr)
    out_r, out_i = [], []
    for j in range(d):
        ar = ai = 0.0
        for l in range(d):
            ur, ui = u[j, l, 0], u[j, l, 1]
            ar = ar + ur * vr[l] - ui * vi[l]
            ai = ai + ur * vi[l] + ui * vr[l]
        out_r.append(ar)
        out_i.append(ai)
    return out_r, out_i


@functools.partial(jax.jit, static_argnums=(3, 4))
def _gate_call(re, im, u, q_lo: int, nbits: int):
    """``2^nbits``-dimensional gate on the adjacent qubits
    ``q_lo .. q_lo + nbits - 1``: one elementwise pass over the
    ``(hi, 2^nbits, 2^q_lo)`` view."""
    d = 1 << nbits
    r = re.reshape(-1, d, 1 << q_lo)
    i_ = im.reshape(-1, d, 1 << q_lo)
    out_r, out_i = _matvec(u, [r[:, j] for j in range(d)],
                           [i_[:, j] for j in range(d)])
    return (jnp.stack(out_r, axis=1).reshape(re.shape),
            jnp.stack(out_i, axis=1).reshape(im.shape))


def lane_gate_matrix(U, q: int) -> np.ndarray:
    """A 2x2 gate on low qubit q (< 7) embedded in the 128 lanes:
    I_{2^(6-q)} ⊗ U ⊗ I_{2^q}."""
    U = np.asarray(U, dtype=np.complex64)
    return np.kron(np.kron(np.eye(1 << (6 - q)), U), np.eye(1 << q))


@jax.jit
def _lane_call(re, im, m):
    d = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    mr, mi = m[..., 0].T, m[..., 1].T
    return d(re, mr) - d(im, mi), d(re, mi) + d(im, mr)


def apply_lane(re: jax.Array, im: jax.Array,
               M: np.ndarray) -> Tuple[jax.Array, jax.Array]:
    """Apply a 128x128 unitary on the low qubits 0-6 (the lane axis) as
    one float32 dot at HIGHEST precision (a default-precision dot on the
    GPU is TF32, about 1e-3 off)."""
    return _lane_call(re, im, _u_array(M))


def apply_1q(re: jax.Array, im: jax.Array, U: np.ndarray, q: int,
             n: int = None) -> Tuple[jax.Array, jax.Array]:
    """Apply a 2x2 unitary to qubit q of a state stored as
    (2**n / 128, 128) real/imag planes."""
    return _gate_call(re, im, _u_array(U), int(q), 1)


def apply_2q_row_pair(re: jax.Array, im: jax.Array, U4: np.ndarray,
                      q_lo: int) -> Tuple[jax.Array, jax.Array]:
    """Apply a 4x4 unitary to adjacent qubits (q_lo, q_lo+1); U4 row/col
    index = bit(q_lo+1)*2 + bit(q_lo)."""
    return _gate_call(re, im, _u_array(U4), int(q_lo), 2)


def _canon_terms(ts):
    return tuple(
        tuple((int(p), int(w)) for p, w in conds) for conds in ts
    )


def _profile(terms: tuple, angles, base, bit):
    """``base + sum_t angles[t] * [conds_t hold]`` from 0/1 bit planes
    (``bit[p]``, broadcastable); an empty condition tuple contributes
    its angle unconditionally."""
    ang = base
    for conds, a in zip(terms, angles):
        mask = 1.0
        for p, w in conds:
            mask = mask * (bit[p] if w else 1.0 - bit[p])
        ang = ang + a * mask
    return ang


def _plane_bits(shape, positions):
    """0/1 float32 bit planes of the basis index ``row * 128 + lane`` of
    (rows, 128) planes, per qubit position: lane bits broadcast as
    (1, 128), row bits as (rows, 1), so no flat index is formed."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (shape[0], 1), 0)
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, LANE), 1)
    return {p: (((lanes >> p) if p < 7 else (rows >> (p - 7))) & 1
                ).astype(jnp.float32) for p in positions}


def _rotate(re, im, c, s):
    return re * c - im * s, re * s + im * c


@functools.partial(jax.jit, static_argnums=(0,))
def _diag_profile_call(terms: tuple, ang, re, im):
    positions = sorted({p for conds in terms for p, _ in conds})
    bit = _plane_bits(re.shape, positions)
    a = _profile(terms, [ang[1 + t] for t in range(len(terms))], ang[0],
                 bit)
    return _rotate(re, im, jnp.cos(a), jnp.sin(a))


def apply_diagonal_profile(re, im, terms, angles, base: float = 0.0):
    """One pass applying e^{i*(base + sum_t angles[t]*[conds_t hold])}.

    ``terms`` is a sequence of condition tuples ((pos, want), ...); an
    empty condition tuple contributes its angle unconditionally.
    Angles may be traced (the sharded engine's device-bit angles)."""
    terms = _canon_terms(terms)
    ang = jnp.stack([jnp.asarray(a, jnp.float32)
                     for a in [base] + list(angles)])
    return _diag_profile_call(terms, ang, re, im)


def apply_masked_rotation(re, im, conds, base_angle: float,
                          masked_angle: float):
    """Phase e^{i(base + masked * [all conds hold])} on (rows, 128) planes."""
    return apply_diagonal_profile(re, im, (conds,), (masked_angle,),
                                  base_angle)


# --------------------------------------------------------------------------
# Fused H·D·H sandwiches: k adjacent ancilla blocks in one op.
#
# The reference surrounds each clique's controlled-phase block with
# H(anc) · cU · X(anc) · cU† · X(anc) · H(anc) (QCMRF.py:231-236). After
# the X-deferral fusion the middle is one diagonal profile
# D = diag(e^{i·alpha(x)}, e^{i·beta(x)}) over the ancilla, and
#
#   H · D · H = e^{i·mu(x)} · [[cos nu, -i sin nu], [-i sin nu, cos nu]]
#
# with mu = (alpha+beta)/2, nu = (beta-alpha)/2 — a position-dependent
# Rx on the ancilla. For QCMRF's matched ±2γ profiles mu ≡ 0 and
# cos(nu)·a0 realizes the e^{βθ/2} post-selected branch (SURVEY.md
# Appendix A item 5). QCMRF emits one sandwich per clique on consecutive
# ancillas and no clique's profile mentions another clique's ancilla, so
# k neighbouring sandwiches commute and compose as a position-dependent
# Rx tensor power on the 2^k-way ancilla axis of the (G, 2^k, 2^anc_lo)
# view of the planes.
# --------------------------------------------------------------------------

#: max ancillas the planner (sim.tpu.fuse_primitives) groups into one
#: read-write sandwich op. XLA runs such a group as about one pass per
#: ancilla whatever the grouping, so the cap only bounds the size of one
#: traced op; the write-only uniform fold has no cap (sim.tpu).
_MAX_SANDWICH_K = 6


def _sandwich_angles(nu_angles_k, nu_bases_k, mu_angles, mu_base,
                     extra=()):
    """Flat float32 angle vector ``[mu_base, nu_bases..., mu_angles...,
    nu_angles_0..., nu_angles_1..., ..., extra...]``; entries may be
    traced."""
    vals = ([mu_base] + list(nu_bases_k) + list(mu_angles)
            + [a for al in nu_angles_k for a in al] + list(extra))
    return jnp.stack([jnp.asarray(v, jnp.float32) for v in vals])


def _sandwich_profiles(mu_terms, nu_terms_k, ang, bit):
    """(mu angle, [nu angle per ancilla]) from the flat angle vector."""
    k = len(nu_terms_k)
    i = 1 + k
    mu = _profile(mu_terms, [ang[i + t] for t in range(len(mu_terms))],
                  ang[0], bit)
    i += len(mu_terms)
    nus = []
    for b, terms in enumerate(nu_terms_k):
        nus.append(_profile(terms, [ang[i + t] for t in range(len(terms))],
                            ang[1 + b], bit))
        i += len(terms)
    return mu, nus


def _view_bits(G: int, S: int, anc_lo: int, k: int, positions):
    """Bit planes of the all-ancillas-0 basis index over the
    (G, ., S) sandwich view: bits below ``anc_lo`` come from the (1, S)
    offset iota, bits above the k ancillas from the (G, 1) group iota."""
    g = jax.lax.broadcasted_iota(jnp.int32, (G, 1), 0)
    s = jax.lax.broadcasted_iota(jnp.int32, (1, S), 1)
    bit = {}
    for p in positions:
        assert not anc_lo <= p < anc_lo + k, "profile conditions on an ancilla"
        v = (s >> p) if p < anc_lo else (g >> (p - anc_lo - k))
        bit[p] = (v & 1).astype(jnp.float32)
    return bit


def _positions(mu_terms, nu_terms_k):
    return sorted({p for conds in mu_terms + sum(nu_terms_k, ())
                   for p, _ in conds})


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _hdh_multi_call(mu_terms: tuple, nu_terms_k: tuple, anc_lo: int,
                    has_mu: bool, ang, re, im):
    k = len(nu_terms_k)
    nsub, S = 1 << k, 1 << anc_lo
    G = re.size // (nsub * S)
    bit = _view_bits(G, S, anc_lo, k, _positions(mu_terms, nu_terms_k))
    mu, nus = _sandwich_profiles(mu_terms, nu_terms_k, ang, bit)
    vr = re.reshape(G, nsub, S)
    vi = im.reshape(G, nsub, S)
    # sequential e^{-i nu_b X} on each ancilla bit of the 2^k-way axis
    # (the rotations act on disjoint bits and commute)
    for b in range(k):
        shp = (G, nsub >> (b + 1), 2, 1 << b, S)
        c = jnp.broadcast_to(jnp.cos(nus[b]), (G, S))[:, None, None, :]
        s = jnp.broadcast_to(jnp.sin(nus[b]), (G, S))[:, None, None, :]
        r = vr.reshape(shp)
        i_ = vi.reshape(shp)
        r0, r1, i0, i1 = r[:, :, 0], r[:, :, 1], i_[:, :, 0], i_[:, :, 1]
        vr = jnp.stack([c * r0 + s * i1, s * i0 + c * r1], axis=2)
        vi = jnp.stack([c * i0 - s * r1, c * i1 - s * r0], axis=2)
        vr = vr.reshape(G, nsub, S)
        vi = vi.reshape(G, nsub, S)
    if has_mu:
        cm = jnp.broadcast_to(jnp.cos(mu), (G, S))[:, None, :]
        sm = jnp.broadcast_to(jnp.sin(mu), (G, S))[:, None, :]
        vr, vi = _rotate(vr, vi, cm, sm)
    return vr.reshape(re.shape), vi.reshape(im.shape)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _hdh_multi_uniform_call(mu_terms: tuple, nu_terms_k: tuple,
                            anc_lo: int, has_mu: bool, comp: int,
                            num_qubits: int, ang):
    k = len(nu_terms_k)
    nsub, S = 1 << k, 1 << anc_lo
    G = (1 << num_qubits) // (nsub * S)
    bit = _view_bits(G, S, anc_lo, k, _positions(mu_terms, nu_terms_k))
    mu, nus = _sandwich_profiles(mu_terms, nu_terms_k, ang, bit)
    # the uniform state is nonzero where every non-folded bit is 0; the
    # ancilla bits are 0 in the view's index, so only the bits below and
    # above the ancilla range are tested
    g = jax.lax.broadcasted_iota(jnp.int32, (G, 1), 0)
    s = jax.lax.broadcasted_iota(jnp.int32, (1, S), 1)
    ok = jnp.logical_and((s & (comp & (S - 1))) == 0,
                         (g & (comp >> (anc_lo + k))) == 0)
    amp = jnp.where(ok, ang[-1], 0.0)[:, None, :]      # (G, 1, S)

    def gs(x):  # a profile value as a (G, 1, S) array
        return jnp.broadcast_to(x, (G, S))[:, None, :]

    # column 0 of the Rx tensor power:
    # out[jj] = amp * (-i)^popcount(jj) * prod_b (s_b if jj_b else c_b)
    jj = np.arange(nsub)
    for b in range(k):
        on = ((jj >> b) & 1)[None, :, None].astype(bool)
        amp = amp * jnp.where(on, gs(jnp.sin(nus[b])), gs(jnp.cos(nus[b])))
    pc = np.array([bin(j).count("1") % 4 for j in jj])
    fr = np.array([1.0, 0.0, -1.0, 0.0], np.float32)[pc][None, :, None]
    fi = np.array([0.0, -1.0, 0.0, 1.0], np.float32)[pc][None, :, None]
    vr, vi = amp * fr, amp * fi
    if has_mu:
        vr, vi = _rotate(vr, vi, gs(jnp.cos(mu)), gs(jnp.sin(mu)))
    rows = (1 << num_qubits) // LANE
    return vr.reshape(rows, LANE), vi.reshape(rows, LANE)


def _has_mu(mu_terms, mu_base) -> bool:
    if isinstance(mu_base, (int, float)):
        return bool(mu_terms) or float(mu_base) != 0.0
    # traced base (the sharded engine's device-bit-conditioned angles):
    # it cannot be proven zero at trace time
    return True


def apply_hdh_sandwich_multi(re, im, anc_lo: int, nu_terms_k,
                             nu_angles_k, nu_bases_k, mu_terms=(),
                             mu_angles=(), mu_base=0.0):
    """Apply k H(a+t)·Dt·H(a+t) blocks (t = 0..k-1, a = anc_lo) in one op.

    ``nu_terms_k[t]`` / ``nu_angles_k[t]`` / ``nu_bases_k[t]`` describe
    ancilla ``anc_lo + t``'s half-difference profile; ``mu`` is the
    COMBINED common-phase profile of all k sandwiches. No term may
    condition on any of the k ancillas.
    """
    mu_terms = _canon_terms(mu_terms)
    nu_terms_k = tuple(_canon_terms(ts) for ts in nu_terms_k)
    assert len(nu_terms_k) >= 1
    ang = _sandwich_angles(nu_angles_k, nu_bases_k, mu_angles, mu_base)
    return _hdh_multi_call(mu_terms, nu_terms_k, int(anc_lo),
                           _has_mu(mu_terms, mu_base), ang, re, im)


def apply_hdh_sandwich_multi_uniform(num_qubits: int, folded,
                                     anc_lo: int, nu_terms_k,
                                     nu_angles_k, nu_bases_k,
                                     mu_terms=(), mu_angles=(),
                                     mu_base=0.0, carrier=1.0):
    """Write-only pass producing k sandwiches applied to the uniform
    H-wall state (``sim.tpu.fold_uniform_prefix`` fold followed by
    ``apply_hdh_sandwich_multi``), without materializing the uniform
    planes. ``folded`` must NOT contain any of the k ancillas
    (``fold_uniform_prefix`` never folds them); ``carrier`` is an
    optional traced scalar equal to 1.0 at runtime (benchmark-chain
    data dependence, see ``sim.tpu.uniform_planes``)."""
    mu_terms = _canon_terms(mu_terms)
    nu_terms_k = tuple(_canon_terms(ts) for ts in nu_terms_k)
    k = len(nu_terms_k)
    assert k >= 1
    assert not any(anc_lo <= q < anc_lo + k for q in folded)
    comp = ((1 << num_qubits) - 1) ^ sum(1 << q for q in folded)
    amp = (jnp.asarray(carrier, jnp.float32)
           * np.float32(2.0 ** (-0.5 * len(folded))))
    ang = _sandwich_angles(nu_angles_k, nu_bases_k, mu_angles, mu_base,
                           extra=(amp,))
    return _hdh_multi_uniform_call(mu_terms, nu_terms_k, int(anc_lo),
                                   _has_mu(mu_terms, mu_base), comp,
                                   int(num_qubits), ang)


def apply_hdh_sandwich(re, im, anc: int, nu_terms, nu_angles,
                       nu_base: float = 0.0, mu_terms=(), mu_angles=(),
                       mu_base: float = 0.0):
    """Apply H(anc)·D·H(anc) in one pass on (rows, 128) planes.

    ``D`` is described by its half-sum/half-difference phase profiles:
    ``mu(x) = mu_base + Σ mu_angles[t]·[mu_terms[t] holds]`` (the common
    phase) and ``nu(x)`` likewise (the anc=1 minus anc=0 half-difference).
    Term conditions must not mention ``anc``.
    """
    return apply_hdh_sandwich_multi(re, im, anc, (nu_terms,), (nu_angles,),
                                    (nu_base,), mu_terms, mu_angles,
                                    mu_base)


def apply_hdh_sandwich_pair(re, im, anc_lo: int,
                            nu1_terms, nu1_angles, nu1_base,
                            nu2_terms, nu2_angles, nu2_base,
                            mu_terms=(), mu_angles=(), mu_base=0.0):
    """Apply H(a)·D1·H(a) and H(a+1)·D2·H(a+1) in one op, a = anc_lo:
    ``nu1`` is the low ancilla's profile, ``nu2`` the high one's, ``mu``
    the combined common phase."""
    return apply_hdh_sandwich_multi(
        re, im, anc_lo, (nu1_terms, nu2_terms), (nu1_angles, nu2_angles),
        (nu1_base, nu2_base), mu_terms, mu_angles, mu_base)


def apply_hdh_sandwich_quad(re, im, anc_lo: int, nu_terms4, nu_angles4,
                            nu_bases4, mu_terms=(), mu_angles=(),
                            mu_base=0.0):
    """Four adjacent-ancilla sandwiches in one op (multi with k=4)."""
    return apply_hdh_sandwich_multi(re, im, anc_lo, nu_terms4,
                                    nu_angles4, nu_bases4, mu_terms,
                                    mu_angles, mu_base)
