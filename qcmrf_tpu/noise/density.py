"""Gate-level noisy density-matrix engine (exact, suite widths).

Physical emulation of the reference's hardware runs (SURVEY.md §2.3 N6:
"depolarizing noise on 1q/2q gates", /root/reference/run_experiment.py:65-68
→ stored res_*/result_*.json): a depolarizing channel is applied after
EVERY lowered 1q/2q gate, interleaved with the circuit exactly where the
gate executes, so errors propagate through the subsequent CX/phase
structure — producing the *structured*, circuit-correlated distortions
(fidelity falloff, acceptance collapse) that no closed-form mixing of the
final ideal distribution can express (the round-2 model's weakness).

Engine notes
------------
* Exact density-matrix evolution over the lowered basis ``[cx,id,rz,sx,x]``
  (circuits/lower.py). Suite widths are <= 10 qubits, so rho is at most
  1024x1024 complex64 (8 MB) — cheap on the host CPU. This is a noise/
  validation path, deliberately NOT the accelerator hot path (the ideal
  engines in sim/ and ops/ carry the performance story).
* numpy, not jax: the gate loop is hundreds of small reshaped updates
  whose cost is memory traffic; rz (diagonal phase) and x/cx (index
  permutations) never materialize a matrix.
* IBM convention: ``rz`` is a virtual frame change (zero duration, zero
  error); depolarizing attaches to the physical pulses ``sx``/``x``
  (rate ``p1q``) and ``cx`` (rate ``p2q``, the JOINT 2-qubit channel
  ``rho -> (1-p) rho + p I/4 (x) tr_ab(rho)``). ``id`` and idle periods
  carry no error (no idling/T1 model).
* Mid-circuit measurements are deferred. That stays EXACT under gate
  noise because QCMRF never touches a qubit again after measuring it
  (QCMRF.py:238-239) — every later gate (and hence every later noise
  channel) acts on a disjoint subsystem and commutes with the
  measurement. ``noisy_clbit_probs`` verifies the property and raises
  on circuits that violate it.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from qcmrf_tpu.circuits.ir import Circuit
from qcmrf_tpu.sim.dense import GATES_1Q

_PHYSICAL_1Q = ("sx", "x", "sxdg", "h")  # pulses that carry p1q error


def _check_deferred_ok(circuit: Circuit) -> None:
    measured = set()
    for g in circuit.gates:
        if g.name == "measure":
            measured.add(g.qubits[0])
        elif g.name != "barrier" and measured.intersection(g.qubits):
            raise ValueError(
                "gate on an already-measured qubit: deferred-measurement "
                "noise semantics would be wrong for this circuit"
            )


def _rz_phases(lam: float, q: int, w: int) -> np.ndarray:
    idx = np.arange(1 << w)
    b = (idx >> q) & 1
    return np.exp(1j * (lam / 2.0) * (2.0 * b - 1.0))


def _flip_axis(rho: np.ndarray, q: int, w: int, side: int) -> np.ndarray:
    """X permutation on qubit ``q`` of the row (side=0) or column (side=1)
    index — a reshape + axis reversal (contiguous strided copy; far
    faster than a fancy-index column gather at w=10)."""
    n = 1 << w
    hi, lo = 1 << (w - 1 - q), 1 << q
    if side == 0:
        v = rho.reshape(hi, 2, lo * n)
    else:
        v = rho.reshape(n * hi, 2, lo)
    return np.ascontiguousarray(v[:, ::-1]).reshape(n, n)


def _apply_x(rho: np.ndarray, q: int, w: int) -> np.ndarray:
    return _flip_axis(_flip_axis(rho, q, w, 0), q, w, 1)


def _cx_side(rho: np.ndarray, c: int, t: int, w: int,
             side: int) -> np.ndarray:
    """CX on one index side: flip bit t wherever bit c is 1 — pure
    reshape/slice ops on the (control, target)-separated view."""
    n = 1 << w
    a, b = max(c, t), min(c, t)
    outer, mid, inner = 1 << (w - 1 - a), 1 << (a - 1 - b), 1 << b
    if side == 0:
        v = rho.reshape(outer, 2, mid, 2, inner * n)
    else:
        v = rho.reshape(n * outer, 2, mid, 2, inner)
    ctrl_axis = 1 if a == c else 3
    tgt_axis = 3 if a == c else 1
    sel = (slice(None),) * ctrl_axis + (1,)
    half = v[sel]  # target axis is now tgt_axis or tgt_axis-1
    t_ax = tgt_axis if tgt_axis < ctrl_axis else tgt_axis - 1
    flipped = np.flip(half, axis=t_ax).copy()
    v[sel] = flipped
    return rho


def _apply_cx(rho: np.ndarray, c: int, t: int, w: int) -> np.ndarray:
    rho = _cx_side(rho, c, t, w, 0)
    return _cx_side(rho, c, t, w, 1)


def _apply_1q(rho: np.ndarray, U: np.ndarray, q: int, w: int) -> np.ndarray:
    """U rho U^dagger for a 2x2 unitary on qubit q."""
    n = 1 << w
    hi, lo = 1 << (w - 1 - q), 1 << q
    U = U.astype(rho.dtype)
    # row side: (hi, 2, lo*n)
    r = np.einsum("ab,hbl->hal", U, rho.reshape(hi, 2, lo * n))
    # column side: (n*hi, 2, lo)
    r = np.einsum("jc,hcl->hjl", U.conj(), r.reshape(n * hi, 2, lo))
    return r.reshape(n, n)


def depolarize_qubits(rho: np.ndarray, qs: Sequence[int], p: float,
                      w: int) -> np.ndarray:
    """Joint depolarizing on qubits ``qs``:
    rho -> (1-p) rho + p * (I/2^k (x) tr_qs rho).

    IN-PLACE: mutates ``rho`` (via a reshaped view) and returns it —
    the density-evolution loop owns its buffer and avoids a 4^w copy per
    channel. External callers who need the input preserved must pass
    ``rho.copy()``."""
    if p == 0.0:
        return rho
    k = len(qs)
    order = sorted(qs, reverse=True)  # descending bit position
    # split one side's index into (s0, 2, s1, 2, ..., sk) segments
    segs = []
    prev = w
    for q in order:
        segs.append(1 << (prev - 1 - q))
        segs.append(2)
        prev = q
    segs.append(1 << prev)
    shape = tuple(segs) * 2
    r = rho.reshape(shape)
    m = len(segs)

    def diag_slice(bits):
        sl = []
        for i in range(m):
            sl.append(bits[i // 2] if i % 2 else slice(None))
        return tuple(sl) * 2

    # partial trace over the qubit axes: sum of the 2^k diagonal slices
    patterns = list(itertools.product((0, 1), repeat=k))
    tr = r[diag_slice(patterns[0])].copy()
    for bits in patterns[1:]:
        tr += r[diag_slice(bits)]
    r *= (1.0 - p)
    add = (p / (1 << k)) * tr
    for bits in patterns:
        r[diag_slice(bits)] += add
    return rho


def evolve_density(
    circuit: Circuit,
    p1q: float = 0.0,
    p2q: float = 0.0,
    dtype=np.complex64,
    rates: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Final density matrix of the lowered circuit under per-gate
    depolarizing. ``rates`` optionally overrides the per-gate-name rate
    (e.g. ``{"cx": 0.003}``)."""
    w = circuit.num_qubits
    if w > 13:
        raise ValueError(
            f"density engine is for suite widths (<=13 qubits), got {w}"
        )
    n = 1 << w
    rho = np.zeros((n, n), dtype=dtype)
    rho[0, 0] = 1.0
    rate = dict.fromkeys(_PHYSICAL_1Q, p1q)
    rate["cx"] = p2q
    if rates:
        rate.update(rates)
    for g in circuit.gates:
        if g.name in ("measure", "barrier", "id"):
            continue
        if g.name == "rz":
            z = _rz_phases(g.params[0], g.qubits[0], w).astype(dtype)
            rho *= z[:, None]
            rho *= z.conj()[None, :]
            continue
        if g.name == "x":
            rho = _apply_x(rho, g.qubits[0], w)
        elif g.name == "cx":
            rho = _apply_cx(rho, g.qubits[0], g.qubits[1], w)
        elif g.name in GATES_1Q:
            rho = _apply_1q(rho, np.asarray(GATES_1Q[g.name]), g.qubits[0], w)
        else:
            raise ValueError(
                f"density engine consumes lowered circuits; got {g.name!r}"
            )
        p = rate.get(g.name, 0.0)
        if p:
            rho = depolarize_qubits(rho, g.qubits, p, w)
    return rho


def clbit_probs_from_diag(circuit: Circuit, diag: np.ndarray) -> np.ndarray:
    """Map the 2^w diagonal onto the 2^num_clbits outcome distribution
    (deferred measurement; unwritten clbits read 0)."""
    w = circuit.num_qubits
    idx = np.arange(1 << w)
    keys = np.zeros_like(idx)
    for q, c in circuit.measured_pairs:
        keys |= ((idx >> q) & 1) << c
    out = np.zeros(1 << circuit.num_clbits, dtype=np.float64)
    np.add.at(out, keys, diag)
    return out


def noisy_clbit_probs(
    circuit: Circuit,
    p1q: float = 0.0,
    p2q: float = 0.0,
    dtype=np.complex64,
    rates: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Exact outcome distribution of the noisy circuit over its classical
    register (before any readout error — that is a separate channel on
    the clbit distribution, see noise.channels)."""
    _check_deferred_ok(circuit)
    rho = evolve_density(circuit, p1q, p2q, dtype=dtype, rates=rates)
    diag = np.clip(np.real(np.diagonal(rho)), 0.0, None)
    probs = clbit_probs_from_diag(circuit, diag)
    s = probs.sum()
    if not (0.97 < s < 1.03):  # float32 accumulation sanity bound
        raise RuntimeError(f"density diagonal lost normalization: {s}")
    return probs / s


def confuse_bits(probs: np.ndarray, e01: np.ndarray, e10: np.ndarray,
                 bits: Sequence[int], width: int,
                 invert: bool = False) -> np.ndarray:
    """Per-bit readout confusion (or its inverse) on a key distribution —
    numpy counterpart of channels.apply_readout_confusion for the host-side
    noise pipeline (same column-stochastic convention)."""
    q = probs.astype(np.float64)
    e01 = np.broadcast_to(np.asarray(e01, np.float64), (len(bits),))
    e10 = np.broadcast_to(np.asarray(e10, np.float64), (len(bits),))
    for b, a, c in zip(bits, e01, e10):
        M = np.array([[1.0 - a, c], [a, 1.0 - c]])
        if invert:
            M = np.linalg.inv(M)
        lo, hi = 1 << b, 1 << (width - 1 - b)
        q = np.einsum("mt,htl->hml", M, q.reshape(hi, 2, lo)).reshape(-1)
    return q
