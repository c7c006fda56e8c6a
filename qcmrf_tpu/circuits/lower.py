"""Lowering pass: high-level QCMRF IR -> hardware basis ``[cx, id, rz, sx, x]``.

Replacement for the qiskit transpiler call of the reference
(``transpile(CIRCS, basis_gates=['cx','id','rz','sx','x'])``,
/root/reference/run_experiment.py:52) and for qiskit's ``AND`` library gate
(QCMRF.py:9, :224-227). Pure circuit-IR rewriting — exact (tracks global
phase so lowered and source circuits agree as full statevectors, not just
up to phase), with two styles:

* ``fused`` (default): each ``flags_phase`` becomes one multi-controlled
  phase over (pattern qubits + control), with X conjugation for negative
  flags. No workspace qubit traffic — the efficient form.
* ``literal``: reproduces the reference's gate structure
  [AND(flags) -> cp -> AND†] through the shared workspace qubit ``n``
  (QCMRF.py:224-227), with AND synthesized as an X-conjugated
  multi-controlled X. For gate-count parity studies.

Multi-controlled phase synthesis uses the exact Z-string expansion of the
all-ones projector: ``e^{i t |1..1><1..1|} = e^{i t/2^m} *
prod_{S != {}} e^{i t (-1)^{|S|} Z_S / 2^m}``, each Z-string rotation
realized as a CX parity chain around one RZ. Exact for any m; gate count
O(2^m), which is optimal-order for unstructured diagonal phases and small
here (m <= max|C| + 1 = 5 in the reference suite).
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence

import numpy as np

from qcmrf_tpu.circuits.ir import Circuit, Gate

BASIS = ("cx", "id", "rz", "sx", "x")

_H_GLOBAL_PHASE = math.pi / 4  # H = e^{i pi/4} RZ(pi/2) SX RZ(pi/2)


def _emit_h(qc: Circuit, q: int) -> None:
    qc.rz(math.pi / 2, q)
    qc.sx(q)
    qc.rz(math.pi / 2, q)
    qc.add_global_phase(_H_GLOBAL_PHASE)


def _emit_sxdg(qc: Circuit, q: int) -> None:
    # SXdg = e^{+i pi/2} RZ(pi) SX RZ(pi): verified by direct matrix algebra
    qc.rz(math.pi, q)
    qc.sx(q)
    qc.rz(math.pi, q)
    qc.add_global_phase(math.pi / 2)


def _emit_cp(qc: Circuit, lam: float, a: int, b: int) -> None:
    # cp(lam) = e^{i lam/4} . rz(lam/2)_a rz(lam/2)_b cx rz(-lam/2)_b cx
    qc.rz(lam / 2, a)
    qc.rz(lam / 2, b)
    qc.cx(a, b)
    qc.rz(-lam / 2, b)
    qc.cx(a, b)
    qc.add_global_phase(lam / 4)


def _emit_zstring_rotation(qc: Circuit, alpha: float, qubits: Sequence[int]) -> None:
    """exp(i * alpha * Z_{q0} Z_{q1} ... ) via CX parity chain + RZ(-2 alpha)."""
    qs = list(qubits)
    for i in range(len(qs) - 1):
        qc.cx(qs[i], qs[i + 1])
    qc.rz(-2.0 * alpha, qs[-1])
    for i in range(len(qs) - 2, -1, -1):
        qc.cx(qs[i], qs[i + 1])


def _emit_mcp(qc: Circuit, theta: float, qubits: Sequence[int]) -> None:
    """Multi-controlled phase: e^{i theta} on the all-ones state of qubits."""
    qs = list(qubits)
    m = len(qs)
    if m == 0:
        qc.add_global_phase(theta)
        return
    if m == 1:
        # p(theta) = e^{i theta/2} rz(theta)
        qc.rz(theta, qs[0])
        qc.add_global_phase(theta / 2)
        return
    scale = theta / (1 << m)
    qc.add_global_phase(scale)  # S = {} term
    for r in range(1, m + 1):
        # coefficient of Z_S in prod (1-Z_i)/2 is (-1)^{|S|} / 2^m
        sign = -1.0 if (r % 2) else 1.0
        for S in itertools.combinations(qs, r):
            _emit_zstring_rotation(qc, sign * scale, S)


def _emit_mcx(qc: Circuit, controls: Sequence[int], target: int) -> None:
    """Multi-controlled X = H(t) . MCP(pi, controls+[t]) . H(t)."""
    _emit_h(qc, target)
    _emit_mcp(qc, math.pi, list(controls) + [target])
    _emit_h(qc, target)


def _emit_flags_phase_fused(qc: Circuit, g: Gate) -> None:
    *pattern, ctrl = g.qubits
    neg = [q for q, f in zip(pattern, g.flags) if f < 0]
    for q in neg:
        qc.x(q)
    _emit_mcp(qc, g.params[0], list(pattern) + [ctrl])
    for q in neg:
        qc.x(q)


def _emit_flags_phase_literal(qc: Circuit, g: Gate, workspace: int) -> None:
    """Reference structure: AND(flags)->workspace; cp(angle, ws, ctrl); AND†."""
    *pattern, ctrl = g.qubits
    neg = [q for q, f in zip(pattern, g.flags) if f < 0]

    def and_gate():
        for q in neg:
            qc.x(q)
        _emit_mcx(qc, pattern, workspace)
        for q in neg:
            qc.x(q)

    and_gate()
    _emit_cp(qc, g.params[0], workspace, ctrl)
    and_gate()  # MCX is self-inverse


def _emit_fused_diagonal(qc: Circuit, run: List[Gate]) -> None:
    """Synthesize the PRODUCT of a run of ``flags_phase`` gates over the
    same qubit set as ONE exact diagonal operator.

    The run's combined action is diagonal: ``e^{i phi(b)}`` with
    ``phi(b) = sum_g angle_g * [pattern(b) == flags_g] * [ctrl(b) == 1]``.
    Expanding phi in the Walsh basis ``phi(b) = sum_S theta_S chi_S(b)``
    (``chi_S(b) = (-1)^{|b & S|}`` = the Z_S eigenvalue) gives the exact
    synthesis ``prod_S exp(i theta_S Z_S)`` — at most ``2^k - 1``
    Z-string rotations for the WHOLE run, vs ``~2^k`` PER GATE when each
    flags_phase expands its own multi-controlled phase. For a QCMRF
    clique of size m (run length 2^m over m+1 qubits) that is a 2^m-fold
    gate reduction — the fused-diagonal pass is what a transpiler's
    commutative-diagonal merge (qiskit O1+) achieves on this circuit
    family, done exactly."""
    *pattern, ctrl = run[0].qubits
    qs = list(pattern) + [ctrl]
    k = len(qs)
    b = np.arange(1 << k)
    bits = (b[:, None] >> np.arange(k)) & 1  # bits[:, i] = value of qs[i]
    phi = np.zeros(1 << k)
    for g in run:
        want = np.asarray([(f + 1) // 2 for f in g.flags])
        match = (bits[:, : k - 1] == want).all(axis=1) & (bits[:, -1] == 1)
        phi += g.params[0] * match
    # Walsh-Hadamard transform: theta_S = 2^-k sum_b phi(b) chi_S(b)
    theta = phi.copy()
    for i in range(k):  # in-place fast WHT over bit axes
        lo = 1 << i
        t = theta.reshape(-1, 2, lo)
        a, c = t[:, 0].copy(), t[:, 1].copy()
        t[:, 0], t[:, 1] = a + c, a - c
    theta /= 1 << k
    qc.add_global_phase(float(theta[0]))
    for S in range(1, 1 << k):
        if abs(theta[S]) < 1e-12:
            continue
        sq = [qs[i] for i in range(k) if (S >> i) & 1]
        _emit_zstring_rotation(qc, float(theta[S]), sq)


def lower(circuit: Circuit, style: str = "fused",
          workspace: int | None = None, optimize: int = 0) -> Circuit:
    """Lower a circuit to the ``[cx, id, rz, sx, x]`` basis.

    ``optimize=1`` (fused style only) merges each maximal run of
    consecutive ``flags_phase`` gates over the same qubit set into one
    exact diagonal synthesis (see :func:`_emit_fused_diagonal`) — up to
    a 2^|C|-fold gate reduction per QCMRF clique block, statevector-
    exact including global phase.

    ``workspace`` names the shared AND-workspace qubit used by
    ``style='literal'``. The safe default is the lowest qubit no gate of
    the circuit touches (measure/barrier excluded) — for QCMRF circuits
    that is exactly qubit ``mrf.n``, which the compiler leaves idle. A
    guess like "max pattern qubit + 1" would collide with a live
    variable qubit whenever variable 0 appears in no clique (the
    reflection v -> (n-1)-v puts it at the TOP of the pattern range),
    silently corrupting the lowered circuit; with no idle qubit at all
    the caller must pass ``workspace`` explicitly.
    """
    if style not in ("fused", "literal"):
        raise ValueError(f"unknown lowering style {style!r}")
    needs_ws = style == "literal" and any(
        g.name == "flags_phase" for g in circuit.gates
    )
    if workspace is None and needs_ws:
        touched = {
            q for g in circuit.gates
            if g.name not in ("measure", "barrier")
            for q in g.qubits
        }
        idle = [q for q in range(circuit.num_qubits) if q not in touched]
        if not idle:
            raise ValueError(
                "literal lowering needs a workspace qubit but every "
                "qubit carries gates; pass workspace= explicitly"
            )
        workspace = idle[0]
    out = Circuit(circuit.num_qubits, circuit.num_clbits,
                  name=circuit.name + "_lowered")
    out.global_phase = circuit.global_phase
    gates = list(circuit.gates)
    if optimize >= 1 and style == "fused":
        merged = []
        i = 0
        while i < len(gates):
            g = gates[i]
            if g.name != "flags_phase":
                merged.append(g)
                i += 1
                continue
            run = [g]
            while (i + len(run) < len(gates)
                   and gates[i + len(run)].name == "flags_phase"
                   and gates[i + len(run)].qubits == g.qubits):
                run.append(gates[i + len(run)])
            merged.append(run)
            i += len(run)
        for item in merged:
            if isinstance(item, list):
                _emit_fused_diagonal(out, item)
            elif item.name in ("cx", "x", "sx", "rz", "id", "measure",
                               "barrier"):
                out.gates.append(item)
            elif item.name == "h":
                _emit_h(out, item.qubits[0])
            elif item.name == "sxdg":
                _emit_sxdg(out, item.qubits[0])
            elif item.name == "cp":
                _emit_cp(out, item.params[0], *item.qubits)
            else:
                raise ValueError(f"cannot lower gate {item.name}")
        return out
    for g in gates:
        if g.name in ("cx", "x", "sx", "rz", "id"):
            out.gates.append(g)
        elif g.name in ("measure", "barrier"):
            out.gates.append(g)
        elif g.name == "h":
            _emit_h(out, g.qubits[0])
        elif g.name == "sxdg":
            _emit_sxdg(out, g.qubits[0])
        elif g.name == "cp":
            _emit_cp(out, g.params[0], *g.qubits)
        elif g.name == "flags_phase":
            if style == "fused":
                _emit_flags_phase_fused(out, g)
            else:
                _emit_flags_phase_literal(out, g, workspace)
        else:
            raise ValueError(f"cannot lower gate {g.name}")
    return out


def basis_gate_counts(circuit: Circuit, style: str = "fused") -> dict:
    """Op counts after lowering — the gate-count parity metric
    (reference transpiles to this basis at run_experiment.py:52)."""
    lowered = lower(circuit, style=style)
    counts = lowered.count_ops()
    counts.pop("measure", None)
    counts.pop("barrier", None)
    return counts
