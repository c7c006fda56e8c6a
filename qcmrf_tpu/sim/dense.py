"""Dense single-device statevector engine over the circuit IR.

Replacement for Qiskit Aer's ``qasm_simulator``
(/root/reference/run_experiment.py:54-56). The engine evolves a complex
statevector with **qubit 0 as the least-significant bit** of the state index,
which makes the final ``|psi|^2`` directly indexable by the reference's
measurement keys (``int(key, 2)``; see qcmrf_tpu.utils.bits).

Design notes:

* every gate application is a static-shape reshape + contraction — no
  data-dependent control flow, fully jit-able; XLA fuses the elementwise
  diagonal gates;
* diagonal gates (rz / cp / flags_phase) never materialize a matrix: they
  multiply by a phase selected with vectorized bit tests on the state index;
* mid-circuit measurements are deferred (exact for QCMRF: measured ancillas
  are never reused, QCMRF.py:238-239), so one run yields the full joint
  outcome distribution;
* the per-clique [AND -> cp -> AND†] sandwich is consumed as the fused
  ``flags_phase`` op, so the AND workspace qubit stays |0> and costs nothing
  (SURVEY.md §2.3 N3) — the lowered basis-gate circuit exercises the literal
  sequence instead.

The fused plane engine (:mod:`qcmrf_tpu.sim.tpu`) is tested against this
module, its reference implementation.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from qcmrf_tpu.circuits.ir import Circuit, Gate

_INV_SQRT2 = 1.0 / math.sqrt(2.0)

GATES_1Q = {
    "h": np.array([[_INV_SQRT2, _INV_SQRT2], [_INV_SQRT2, -_INV_SQRT2]],
                  dtype=np.complex64),
    "x": np.array([[0, 1], [1, 0]], dtype=np.complex64),
    "sx": 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]],
                         dtype=np.complex64),
    "sxdg": 0.5 * np.array([[1 - 1j, 1 + 1j], [1 + 1j, 1 - 1j]],
                           dtype=np.complex64),
    "id": np.eye(2, dtype=np.complex64),
}


def zero_state(num_qubits: int, dtype=jnp.complex64) -> jax.Array:
    state = jnp.zeros((1 << num_qubits,), dtype=dtype)
    return state.at[0].set(1.0)


def apply_1q(state: jax.Array, U, q: int, num_qubits: int) -> jax.Array:
    """Apply a 2x2 unitary to qubit ``q`` (LSB convention)."""
    lo = 1 << q
    hi = 1 << (num_qubits - 1 - q)
    st = state.reshape(hi, 2, lo)
    U = jnp.asarray(U, dtype=state.dtype)
    return jnp.einsum("ab,hbl->hal", U, st).reshape(-1)


def apply_2q(state: jax.Array, U4, qa: int, qb: int, num_qubits: int) -> jax.Array:
    """Apply a 4x4 unitary to qubits (qa, qb); row/col index = (bit_a, bit_b)."""
    if qa == qb:
        raise ValueError("qubits must differ")
    swap = qa < qb
    if swap:
        qa, qb = qb, qa
        U4 = np.asarray(U4).reshape(2, 2, 2, 2).transpose(1, 0, 3, 2).reshape(4, 4)
    hi = 1 << (num_qubits - 1 - qa)
    mid = 1 << (qa - qb - 1)
    lo = 1 << qb
    st = state.reshape(hi, 2, mid, 2, lo)
    Ur = jnp.asarray(np.asarray(U4).reshape(2, 2, 2, 2), dtype=state.dtype)
    return jnp.einsum("abcd,hcmdl->hambl", Ur, st).reshape(-1)


def _bit(idx: jax.Array, q: int) -> jax.Array:
    return (idx >> q) & 1


@functools.lru_cache(maxsize=64)
def _state_indices(num_qubits: int):
    # evaluated eagerly even when first reached inside a jit/vmap trace,
    # so the cache never holds a tracer
    with jax.ensure_compile_time_eval():
        return jnp.arange(1 << num_qubits, dtype=jnp.int32)


def apply_diagonal_phase(state, mask_bool, angle) -> jax.Array:
    phase = jnp.exp(1j * jnp.asarray(angle, jnp.float32)).astype(state.dtype)
    return state * jnp.where(mask_bool, phase, 1.0)


def apply_gate(state: jax.Array, g: Gate, num_qubits: int) -> jax.Array:
    name = g.name
    if name in GATES_1Q:
        return apply_1q(state, GATES_1Q[name], g.qubits[0], num_qubits)
    if name == "rz":
        lam = g.params[0]
        idx = _state_indices(num_qubits)
        b = _bit(idx, g.qubits[0])
        # diag(e^{-i lam/2}, e^{+i lam/2})
        phase = jnp.exp(1j * (lam / 2.0) * (2.0 * b - 1.0)).astype(state.dtype)
        return state * phase
    if name == "cx":
        c, t = g.qubits
        U4 = np.array(
            [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
            dtype=np.complex64,
        )  # rows/cols indexed by (bit_c, bit_t)
        return apply_2q(state, U4, c, t, num_qubits)
    if name == "cp":
        c, t = g.qubits
        idx = _state_indices(num_qubits)
        mask = (_bit(idx, c) & _bit(idx, t)) == 1
        return apply_diagonal_phase(state, mask, g.params[0])
    if name == "flags_phase":
        *pattern, ctrl = g.qubits
        idx = _state_indices(num_qubits)
        mask = _bit(idx, ctrl) == 1
        for q, f in zip(pattern, g.flags):
            want = (f + 1) // 2  # +1 -> bit 1, -1 -> bit 0
            mask = mask & (_bit(idx, q) == want)
        return apply_diagonal_phase(state, mask, g.params[0])
    if name in ("barrier", "measure"):
        return state
    raise ValueError(f"unknown gate {name}")


def run_statevector(
    circuit: Circuit, initial_state: Optional[jax.Array] = None
) -> jax.Array:
    """Final statevector with measurements deferred (jit-friendly trace)."""
    nq = circuit.num_qubits
    state = zero_state(nq) if initial_state is None else initial_state
    for g in circuit.gates:
        state = apply_gate(state, g, nq)
    if circuit.global_phase:
        state = state * jnp.exp(1j * jnp.float32(circuit.global_phase)).astype(
            state.dtype
        )
    return state


def outcome_probs(circuit: Circuit, state: jax.Array) -> jax.Array:
    """Joint distribution over classical-register values.

    Deferred-measurement semantics: clbit ``c`` reads the final value of its
    measured qubit; unwritten clbits are 0. Returns a ``2**num_clbits``
    probability vector indexed by ``int(key, 2)`` of the counts key.
    """
    nq = circuit.num_qubits
    probs = jnp.abs(state) ** 2
    pairs = circuit.measured_pairs
    if not pairs:
        return probs
    idx = _state_indices(nq)
    keys = jnp.zeros_like(idx)
    for q, c in pairs:
        keys = keys | (_bit(idx, q) << c)
    out = jnp.zeros((1 << circuit.num_clbits,), dtype=probs.dtype)
    return out.at[keys].add(probs)


def simulate_probs(circuit: Circuit) -> jax.Array:
    """Convenience: run + outcome distribution."""
    return outcome_probs(circuit, run_statevector(circuit))


def statevector_fidelity(a: jax.Array, b: jax.Array) -> float:
    """|<a|b>|^2 — used by tests to compare engines up to global phase."""
    return float(jnp.abs(jnp.vdot(a, b)) ** 2)
