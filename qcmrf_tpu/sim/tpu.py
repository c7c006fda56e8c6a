"""Gate-level statevector engine on real/imag float32 planes.

The fused counterpart of :mod:`qcmrf_tpu.sim.dense`: amplitudes live as
two ``(2**Q / 128, 128)`` float32 planes, the circuit is lowered and
fused on the host into few passes (:func:`fuse_ops`), and every pass is
an elementwise plane op from :mod:`qcmrf_tpu.ops.kernels` —

* non-diagonal 1q gates and adjacent pairs of them: one strided pass
  (``apply_1q`` / ``apply_2q_row_pair``); a run of them on five or more
  of the low qubits 0-6: one 128x128 dot (``apply_lane``);
* runs of diagonal gates (rz, cp, flags_phase): one phase-profile pass;
* H·D·H ancilla sandwiches: one pass per group of adjacent ancillas;
* cx: X-basis decomposition ``cx = H_t . cp(pi) . H_t`` (keeps the gate
  set closed over the implemented passes).

Requires ``Q >= 7`` (one lane row); smaller circuits use the dense
engine. Measurements are deferred exactly as in the dense engine.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qcmrf_tpu.circuits.ir import Circuit, Gate
from qcmrf_tpu.ops import kernels as K
from qcmrf_tpu.sim.dense import GATES_1Q


def zero_planes(num_qubits: int) -> Tuple[jax.Array, jax.Array]:
    rows = (1 << num_qubits) // 128
    re = jnp.zeros((rows, 128), jnp.float32).at[0, 0].set(1.0)
    return re, jnp.zeros_like(re)


def _diag_conds_and_angles(g: Gate):
    """(conds, base, masked) for a diagonal gate."""
    if g.name == "rz":
        lam = g.params[0]
        return ((g.qubits[0], 1),), -lam / 2.0, lam
    if g.name == "cp":
        lam = g.params[0]
        c, t = g.qubits
        return ((c, 1), (t, 1)), 0.0, lam
    if g.name == "flags_phase":
        *pattern, ctrl = g.qubits
        conds = [(ctrl, 1)]
        for q, f in zip(pattern, g.flags):
            conds.append((q, (f + 1) // 2))
        return tuple(conds), 0.0, g.params[0]
    raise ValueError(f"not diagonal: {g.name}")


def apply_gate(re, im, g: Gate, num_qubits: int):
    if g.name in ("barrier", "measure", "id"):
        return re, im
    if g.name in ("h", "x", "sx", "sxdg"):
        return K.apply_1q(re, im, GATES_1Q[g.name], g.qubits[0], num_qubits)
    if g.name in ("rz", "cp", "flags_phase"):
        conds, base, masked = _diag_conds_and_angles(g)
        return K.apply_masked_rotation(re, im, conds, base, masked)
    if g.name == "cx":
        c, t = g.qubits
        re, im = K.apply_1q(re, im, GATES_1Q["h"], t, num_qubits)
        re, im = K.apply_masked_rotation(
            re, im, ((c, 1), (t, 1)), 0.0, math.pi
        )
        return K.apply_1q(re, im, GATES_1Q["h"], t, num_qubits)
    raise ValueError(f"unsupported gate {g.name}")


_MAX_DIAG_TERMS = 64  # cap per fused pass: bounds the unrolled pass size

#: a run of 1q ops on the low qubits 0-6 that touches at least this many
#: of them becomes one 128x128 dot (kernels.apply_lane). Measured on one
#: H100: strided passes win up to 4 qubits (8.2 against 9.0 ms at
#: w=28), the dot wins at 7 (9.0 against 19.2 ms; PERF.md)
_LANE_DOT_MIN_QUBITS = 5


def _try_sandwich(h1, dg, h2):
    """Recognize [1q H on a] [diag] [1q H on a] and rewrite it as one
    ('sandwich', a, nu_terms, nu_angles, nu_base, mu_terms, mu_angles,
    mu_base) op — see kernels.apply_hdh_sandwich for the algebra. Returns
    None when the triple does not match (non-H matrices, or a term
    conditioning on a twice)."""
    if h1[0] != "1q" or h2[0] != "1q" or dg[0] != "diag":
        return None
    _, U1, q1 = h1
    _, U2, q2 = h2
    if q1 != q2:
        return None
    H = np.asarray(GATES_1Q["h"], np.complex64)
    if not (np.allclose(U1, H, atol=1e-6)
            and np.allclose(U2, H, atol=1e-6)):
        return None
    _, terms, angles, base = dg
    mu = {}
    nu = {}

    def add(d, conds, val):
        d[conds] = d.get(conds, 0.0) + val

    for conds, t in zip(terms, angles):
        want_a = [w for p, w in conds if p == q1]
        if len(want_a) > 1:
            return None  # inconsistent / duplicated anc condition
        rest = tuple(sorted((p, w) for p, w in conds if p != q1))
        if not want_a:
            add(mu, rest, t)  # phases both anc branches equally
        else:
            add(mu, rest, t / 2.0)
            add(nu, rest, t / 2.0 if want_a[0] else -t / 2.0)

    mu_base = base + mu.pop((), 0.0)
    nu_base = nu.pop((), 0.0)
    mu = {k: v for k, v in mu.items() if abs(v) > 1e-12}
    nu = {k: v for k, v in nu.items() if abs(v) > 1e-12}
    return ("sandwich", q1, tuple(nu.keys()), tuple(nu.values()),
            nu_base, tuple(mu.keys()), tuple(mu.values()), mu_base)


def circuit_primitives(circuit: Circuit) -> list:
    """Lower the gate stream to ('1q', U, q) / ('diag', conds, base, angle)
    primitives with X gates DEFERRED (X·D·X is D with the bit condition
    flipped, so a clique's whole H·cU·X·cU†·X·H sandwich collapses to
    H · [one fused diagonal] · H — the X row passes vanish entirely); cx
    decomposes as H_t · cp(pi) · H_t so the sandwich post-pass of
    :func:`fuse_primitives` later collapses it to one pass too."""
    X = np.asarray(GATES_1Q["x"], np.complex64)
    flips = {}  # qubit -> pending deferred X (0/1)

    prim = []

    def push_1q(name, q):
        U = np.asarray(GATES_1Q[name], np.complex64)
        if name == "x":
            flips[q] = flips.get(q, 0) ^ 1
            return
        if flips.get(q):
            U = U @ X  # the deferred X acted first
            flips[q] = 0
        prim.append(("1q", U, q))

    def push_diag(conds, base, masked):
        conds = tuple(
            (pos, want ^ flips.get(pos, 0)) for pos, want in conds
        )
        prim.append(("diag", conds, base, masked))

    for g in circuit.gates:
        if g.name in ("barrier", "measure", "id"):
            continue
        if g.name == "cx":
            c, t = g.qubits
            push_1q("h", t)
            push_diag(((c, 1), (t, 1)), 0.0, math.pi)
            push_1q("h", t)
        elif g.name in ("h", "x", "sx", "sxdg"):
            push_1q(g.name, g.qubits[0])
        elif g.name in ("rz", "cp", "flags_phase"):
            conds, base, masked = _diag_conds_and_angles(g)
            push_diag(conds, base, masked)
        else:
            raise ValueError(f"unsupported gate {g.name}")
    for q in sorted(flips):
        if flips[q]:
            flips[q] = 0
            prim.append(("1q", X, q))
    return prim


def fuse_primitives(prim: list) -> list:
    """Peephole fusion of a primitive stream into HBM-pass-minimal ops.

    * a RUN of consecutive diagonal primitives (rz/cp/flags_phase, incl.
      the cp inside the cx decomposition) -> ONE ``('diag', terms, angles,
      base)`` pass (kernels.apply_diagonal_profile) — this collapses a
      clique's whole cU_C block sequence into a single sweep;
    * consecutive 1q gates on the SAME qubit compose their 2x2s, a run
      of them on five or more of the low qubits 0-6 composes into one
      128x128 dot, and consecutive 1q gates on ADJACENT qubits merge
      into one 4x4 two-qubit pass;
    * H(a)·[diag]·H(a) triples collapse into ONE sandwich pass.

    Angles are handled generically (only +, unary -, /, and abs are used),
    so the sharded engine can pass symbolic angles whose device-bit
    conditions evaluate per-device at trace time (parallel.sharded).
    """
    ops = []
    for p in prim:
        if p[0] == "diag":
            _, conds, base, a = p
            if (ops and ops[-1][0] == "diag"
                    and len(ops[-1][1]) < _MAX_DIAG_TERMS):
                _, terms, angles, b0 = ops[-1]
                ops[-1] = ("diag", terms + (conds,), angles + (a,),
                           b0 + base)
            else:
                ops.append(("diag", (conds,), (a,), base))
        else:
            _, U, q = p
            if ops and ops[-1][0] == "1q" and ops[-1][2] == q:
                ops[-1] = ("1q", U @ ops[-1][1], q)
            else:
                ops.append(("1q", U, q))

    # post-pass 1: collapse H(a)·[diag]·H(a) triples on a row qubit into
    # ONE sandwich pass (kernels.apply_hdh_sandwich) — each clique's whole
    # real-part-extraction block becomes a single HBM sweep (3 passes -> 1)
    fused = []
    i = 0
    while i < len(ops):
        s = (_try_sandwich(ops[i], ops[i + 1], ops[i + 2])
             if i + 2 < len(ops) else None)
        if s is not None:
            fused.append(s)
            i += 3
        else:
            fused.append(ops[i])
            i += 1
    ops = fused

    # post-pass 1b: group runs of consecutive-ancilla sandwiches into ONE
    # multi op (kernels.apply_hdh_sandwich_multi), up to
    # kernels._MAX_SANDWICH_K ancillas per op. QCMRF emits one sandwich
    # per clique on consecutive ancilla qubits and no clique's profile
    # mentions another clique's ancilla, so neighbours commute and
    # compose as a position-dependent Rx tensor power.
    grouped = []   # each group: [list of sandwich ops sorted by ancilla]
    out1b = []
    for op in ops:
        g = grouped[-1] if grouped else None
        if (op[0] == "sandwich" and g is not None
                and len(g) < K._MAX_SANDWICH_K
                and (op[1] == g[-1][1] + 1 or op[1] == g[0][1] - 1)
                and _sandwich_group_independent(g, op)):
            g.append(op) if op[1] == g[-1][1] + 1 else g.insert(0, op)
        elif op[0] == "sandwich":
            grouped.append([op])
            out1b.append(grouped[-1])
        else:
            grouped.append(None)
            out1b.append(op)
    ops = []
    for item in out1b:
        if not isinstance(item, list) or len(item) == 1:
            ops.append(item[0] if isinstance(item, list) else item)
            continue
        mt = sum((s[5] for s in item), ())
        ma = sum((tuple(s[6]) for s in item), ())
        mb = item[0][7]   # may be _SymAngle (sharded): no sum() 0-start
        for s in item[1:]:
            mb = mb + s[7]
        ops.append(("sandwichk", item[0][1],
                    tuple(s[2] for s in item),
                    tuple(s[3] for s in item),
                    tuple(s[4] for s in item),
                    mt, ma, mb))

    # post-pass 1c: a run of low-qubit 1q ops touching enough qubits
    # composes into one 128x128 dot
    lane = []
    i = 0
    while i < len(ops):
        j = i
        while j < len(ops) and ops[j][0] == "1q" and ops[j][2] < 7:
            j += 1
        run = ops[i:j] or [ops[i]]
        if len({op[2] for op in ops[i:j]}) >= _LANE_DOT_MIN_QUBITS:
            M = np.eye(128, dtype=np.complex64)
            for _, U, q in run:
                M = K.lane_gate_matrix(U, q) @ M
            lane.append(("lane", M))
        else:
            lane.extend(run)
        i += len(run)
    ops = lane

    # post-pass 2: merge 1q ops on ADJACENT qubits into one 4x4 pass
    # (matrix index = bit(q_lo+1)*2 + bit(q_lo) -> kron(U_hi, U_lo))
    merged = []
    for op in ops:
        if (op[0] == "1q" and merged and merged[-1][0] == "1q"
                and abs(merged[-1][2] - op[2]) == 1):
            _, U_prev, q_prev = merged[-1]
            _, U, q = op
            if q > q_prev:
                merged[-1] = ("2q", np.kron(U, U_prev), q_prev)
            else:
                merged[-1] = ("2q", np.kron(U_prev, U), q)
        else:
            merged.append(op)
    return merged


def _sandwich_group_independent(group, op) -> bool:
    """True when no profile in ``group + [op]`` conditions on any of the
    combined ancilla set (the commutation requirement for multi fusion).
    Each element is a ('sandwich', a, nt, na, nb, mt, ma, mb) op."""
    ancs = {s[1] for s in group} | {op[1]}
    for s in list(group) + [op]:
        for terms in (s[2], s[5]):  # nu terms, mu terms
            for conds in terms:
                if any(p in ancs for p, _ in conds):
                    return False
    return True


def fold_uniform_prefix(prim: list):
    """Detect the H-wall prefix and fold it into a closed-form init.

    Every leading ``('1q', H, q)`` on a distinct qubit acts on |0...0>, so
    the state after the prefix is the uniform real superposition over the
    folded qubits tensored with |0> elsewhere — a masked CONSTANT that one
    write-only pass produces, instead of one HBM read+write pass per
    fused wall op. A qubit is folded only if
    it has NO LATER 1q primitive: ancilla H's must stay in the stream so
    the H·D·H sandwich fusion still sees its triples.

    Returns ``(folded_qubits, rest)``; ``folded_qubits`` is () when
    nothing folds (no leading H's, e.g. lowered basis-gate streams).
    """
    H = np.asarray(GATES_1Q["h"], np.complex64)
    last_1q = {}
    for k, p in enumerate(prim):
        if p[0] == "1q":
            last_1q[p[2]] = k
    folded = []
    k = 0
    while k < len(prim):
        p = prim[k]
        if p[0] != "1q":
            break
        _, U, q = p
        if (q in folded or last_1q[q] != k
                or not np.allclose(U, H, atol=1e-9)):
            break
        folded.append(q)
        k += 1
    if len(folded) < 2:  # a lone H saves nothing over its own pass
        return (), prim
    return tuple(sorted(folded)), prim[k:]


def sandwich_fold_parts(first_op, folded_locals):
    """If a fused stream's first op is a sandwich group whose ancillas
    avoid ``folded_locals``, return its ``(a, nts, nas, nbs, mt, ma,
    mb)`` normalized to the multi (k-tuple) layout so a write-only
    uniform-init fold can absorb it; else None. Shared by the
    single-device ``sandwichku`` fusion below and the sharded engine's
    mirror of it (parallel.sharded._plan_fused) so the fold condition
    cannot drift between the two dialects."""
    if first_op[0] == "sandwichk":
        _, a, nts, nas, nbs, mt, ma, mb = first_op
        if any(a <= q < a + len(nts) for q in folded_locals):
            return None
        return a, nts, nas, nbs, mt, ma, mb
    if first_op[0] == "sandwich":
        _, a, nt, na, nb, mt, ma, mb = first_op
        if a in folded_locals:
            return None
        return a, (nt,), (na,), (nb,), mt, ma, mb
    return None


def fuse_ops(circuit: Circuit) -> list:
    """Fused op stream of a circuit: :func:`circuit_primitives` (X-deferred
    lowering) composed with :func:`fuse_primitives` (peephole fusion into
    diag/1q/2q/lane/sandwich passes). The H-wall prefix folds into a
    closed-form ``('init_uniform', qubits)`` first op (write-only; see
    :func:`fold_uniform_prefix`)."""
    prim = circuit_primitives(circuit)
    folded, rest = fold_uniform_prefix(prim)
    if not folded:
        return fuse_primitives(prim)
    ops = fuse_primitives(rest)
    fold = fold_sandwich_groups(ops, folded)
    if fold is not None:
        parts, rest = fold
        return [("sandwichku", folded) + parts] + rest
    return [("init_uniform", folded)] + ops


def fold_sandwich_groups(ops: list, folded):
    """Fold the write-only uniform init INTO the leading sandwich groups
    of ``ops`` (kernels.apply_hdh_sandwich_multi_uniform): the uniform
    state's ancilla bits are 0 (ancillas are never folded, see
    fold_uniform_prefix), so the groups' output on it has a closed form,
    and one write-only pass replaces a write pass plus a read+write pass
    per group. The closed form costs one multiply per ancilla and
    output, so every adjacent group joins it (they commute and start
    from ancillas at 0 too). Returns ``(parts, rest)`` — the joined
    group in :func:`sandwich_fold_parts` layout and the ops left — or
    None when ``ops`` does not start with a foldable group. Shared by
    this engine and the sharded one (parallel.sharded._plan_fused)."""
    if not ops:
        return None
    parts = sandwich_fold_parts(ops[0], folded)
    if parts is None:
        return None
    rest = ops[1:]
    while rest:
        more = _join_fold_parts(parts, rest[0], folded)
        if more is None:
            break
        parts, rest = more, rest[1:]
    return parts, rest


def _join_fold_parts(parts, op, folded):
    """``parts`` (a :func:`sandwich_fold_parts` tuple) extended by the
    sandwich group ``op`` when its ancillas sit next to the group's and
    no profile of either conditions on the joined ancilla range; else
    None."""
    nxt = sandwich_fold_parts(op, folded)
    if nxt is None:
        return None
    a, nts, nas, nbs, mt, ma, mb = parts
    a2, nts2, nas2, nbs2, mt2, ma2, mb2 = nxt
    if a2 == a + len(nts):
        lo, joined = a, (nts + nts2, nas + nas2, nbs + nbs2)
    elif a2 + len(nts2) == a:
        lo, joined = a2, (nts2 + nts, nas2 + nas, nbs2 + nbs)
    else:
        return None
    hi = lo + len(joined[0])
    for terms in joined[0] + (mt, mt2):
        for conds in terms:
            if any(lo <= p < hi for p, _ in conds):
                return None
    return (lo,) + joined + (mt + mt2, tuple(ma) + tuple(ma2), mb + mb2)


def uniform_planes(num_qubits: int, folded,
                   carrier=None) -> Tuple[jax.Array, jax.Array]:
    """Planes of the state H^{folded}|0...0>: amplitude 2^{-|S|/2} where
    every bit OUTSIDE ``folded`` is 0, else 0. Built with row/lane iotas
    (no 2**n int32 overflow up to the streaming-lnZ widths). ``carrier``
    (optional traced scalar that must equal 1.0 at runtime) keeps the
    output data-dependent on the caller's input planes — benchmark
    chains vary a dummy argument to defeat jit constant folding, and an
    init that ignored its input would sever that dependence."""
    rows = (1 << num_qubits) // 128
    comp = ((1 << num_qubits) - 1) ^ sum(1 << q for q in folded)
    comp_row, comp_lane = comp >> 7, comp & 127
    ri = jax.lax.broadcasted_iota(jnp.int32, (rows, 128), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (rows, 128), 1)
    ok = jnp.logical_and((ri & comp_row) == 0, (ci & comp_lane) == 0)
    amp = np.float32(2.0 ** (-0.5 * len(folded)))
    if carrier is not None:
        amp = amp * carrier
    re = jnp.where(ok, amp, np.float32(0.0))
    return re, jnp.zeros_like(re)


def _apply_ops(re, im, ops, num_qubits: int):
    for op in ops:
        if op[0] == "init_uniform":
            # overwrites the planes (always the first op when present);
            # re[0, 0] == 1.0 for the |0> planes every caller supplies,
            # and carrying it keeps benchmark dummy-arg dependences alive
            re, im = uniform_planes(num_qubits, op[1], carrier=re[0, 0])
        elif op[0] == "diag":
            _, terms, angles, base = op
            re, im = K.apply_diagonal_profile(re, im, terms, angles, base)
        elif op[0] == "2q":
            _, U4, q_lo = op
            re, im = K.apply_2q_row_pair(re, im, U4, q_lo)
        elif op[0] == "lane":
            re, im = K.apply_lane(re, im, op[1])
        elif op[0] == "sandwich":
            _, a, nt, na, nb, mt, ma, mb = op
            re, im = K.apply_hdh_sandwich(re, im, a, nt, na, nb,
                                          mt, ma, mb)
        elif op[0] == "sandwichk":
            _, a, nts, nas, nbs, mt, ma, mb = op
            re, im = K.apply_hdh_sandwich_multi(
                re, im, a, nts, nas, nbs, mt, ma, mb
            )
        elif op[0] == "sandwichku":
            # write-only (first op when present); the carrier keeps
            # benchmark dummy-arg dependences alive, as for init_uniform
            _, folded, a, nts, nas, nbs, mt, ma, mb = op
            re, im = K.apply_hdh_sandwich_multi_uniform(
                num_qubits, folded, a, nts, nas, nbs, mt, ma, mb,
                carrier=re[0, 0]
            )
        else:
            _, U, q = op
            re, im = K.apply_1q(re, im, U, q, num_qubits)
    return re, im


def run_statevector(circuit: Circuit) -> Tuple[jax.Array, jax.Array]:
    """Final statevector planes with measurements deferred (fused ops)."""
    nq = circuit.num_qubits
    if nq < 7:
        raise ValueError(
            "the plane engine needs >= 7 qubits; use sim.dense below that"
        )
    re, im = zero_planes(nq)
    re, im = _apply_ops(re, im, fuse_ops(circuit), nq)
    if circuit.global_phase:
        c = float(np.cos(circuit.global_phase))
        s = float(np.sin(circuit.global_phase))
        re, im = re * c - im * s, re * s + im * c
    return re, im


def outcome_probs(circuit: Circuit, re, im) -> jax.Array:
    """Joint clbit-value distribution (QCMRF wiring: identity key map)."""
    probs = (re * re + im * im).reshape(-1)
    pairs = circuit.measured_pairs
    # the identity shortcut is only valid when EVERY qubit is measured to
    # its own clbit AND the clbit register is exactly the qubit register
    # (a wider clbit register needs the 2**num_clbits output the dense
    # engine documents) — otherwise mass must be marginalized onto keys
    # with unmeasured clbits zero (dense semantics)
    if not pairs or (
        len(pairs) == circuit.num_qubits
        and circuit.num_clbits == circuit.num_qubits
        and all(q == c for q, c in pairs)
    ):
        return probs
    idx = jnp.arange(probs.shape[0], dtype=jnp.int32)
    keys = jnp.zeros_like(idx)
    for q, c in pairs:
        keys = keys | (((idx >> q) & 1) << c)
    out = jnp.zeros((1 << circuit.num_clbits,), dtype=probs.dtype)
    return out.at[keys].add(probs)


def simulate_probs(circuit: Circuit) -> jax.Array:
    re, im = run_statevector(circuit)
    return outcome_probs(circuit, re, im)
