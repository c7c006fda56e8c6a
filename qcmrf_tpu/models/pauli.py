"""Lightweight Pauli algebra for diagonal (I/Z) operators.

JAX replacement for the reference's use of ``qiskit.opflow``
(/root/reference/QCMRF.py:6, :159-197). The QCMRF sufficient statistics and
Hamiltonian are built purely from tensor products of ``I``, ``(I+Z)/2`` and
``(I-Z)/2`` — all *diagonal* in the computational basis — so instead of a
generic operator-algebra system we represent an operator as a sparse sum of
Z-strings: a dict mapping a Z-support bitmask to its real coefficient. The
dense diagonal over the computational basis is a single vectorized popcount
expression, evaluated lazily (and jit-compatible).

Bitmask convention: bit ``(n-1-v)`` of a mask corresponds to variable ``v``
(variable 0 = MSB of a state id), matching qcmrf_tpu.utils.bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class PauliSum:
    """Real linear combination of Z-strings on ``n`` qubits.

    ``terms[mask]`` is the coefficient of ``prod_{v in mask} Z_v``.
    The identity is ``mask == 0``.
    """

    n: int
    terms: Tuple[Tuple[int, float], ...]  # sorted (mask, coeff) pairs

    @staticmethod
    def from_dict(n: int, d: Dict[int, float]) -> "PauliSum":
        items = tuple(sorted((m, float(c)) for m, c in d.items() if c != 0.0))
        return PauliSum(n=n, terms=items)

    def as_dict(self) -> Dict[int, float]:
        return dict(self.terms)

    # ---- algebra --------------------------------------------------------

    def __add__(self, other: "PauliSum") -> "PauliSum":
        assert self.n == other.n
        d = dict(self.terms)
        for m, c in other.terms:
            d[m] = d.get(m, 0.0) + c
        return PauliSum.from_dict(self.n, d)

    def __mul__(self, scalar: float) -> "PauliSum":
        return PauliSum.from_dict(
            self.n, {m: c * scalar for m, c in self.terms}
        )

    __rmul__ = __mul__

    def __matmul__(self, other: "PauliSum") -> "PauliSum":
        """Operator product; Z-strings multiply by XOR of masks."""
        assert self.n == other.n
        d: Dict[int, float] = {}
        for m1, c1 in self.terms:
            for m2, c2 in other.terms:
                m = m1 ^ m2
                d[m] = d.get(m, 0.0) + c1 * c2
        return PauliSum.from_dict(self.n, d)

    def adjoint(self) -> "PauliSum":
        """Z-strings with real coefficients are self-adjoint."""
        return self

    # ---- evaluation ------------------------------------------------------

    def diagonal(self) -> jnp.ndarray:
        """Dense diagonal over the ``2**n`` computational-basis states.

        Eigenvalue of ``Z_S`` at state ``x`` is ``(-1)^{popcount(x & S)}``;
        vectorized over all states (no Python loop over states).
        """
        x = np.arange(1 << self.n, dtype=np.uint64)
        out = np.zeros(1 << self.n, dtype=np.float64)
        for mask, coeff in self.terms:
            par = np.bitwise_count(x & np.uint64(mask)).astype(np.int64) & 1
            out += coeff * (1.0 - 2.0 * par)
        return jnp.asarray(out)


def identity(n: int) -> PauliSum:
    return PauliSum.from_dict(n, {0: 1.0})


def z_on(n: int, v: int) -> PauliSum:
    return PauliSum.from_dict(n, {1 << (n - 1 - v): 1.0})


def projector(n: int, v: int, value: int) -> PauliSum:
    """``|value><value|`` on variable ``v``: ``(I +/- Z)/2``."""
    sign = 1.0 if value == 0 else -1.0
    return PauliSum.from_dict(n, {0: 0.5, 1 << (n - 1 - v): 0.5 * sign})


def sufficient_statistic(
    n: int, C: Sequence[int], y: Sequence[int]
) -> PauliSum:
    """Pauli-Markov sufficient statistic ``phi_{C,y}``.

    Parity with reference QCMRF.sufficient_statistic (QCMRF.py:159-179):
    tensor product of ``(I+Z)/2`` on variables with ``y_i = 0`` and
    ``(I-Z)/2`` on variables with ``y_i = 1`` (identity elsewhere).
    """
    result = identity(n)
    for v, yi in zip(C, y):
        result = result @ projector(n, v, int(yi))
    return result


def hamiltonian(n: int, cliques, theta) -> PauliSum:
    """MRF Hamiltonian ``H = sum_i -theta_i * phi_i``.

    Parity with reference QCMRF.Hamiltonian (QCMRF.py:181-193); the result
    is diagonal and its diagonal equals ``-theta^T phi(x)`` per state.
    """
    import itertools

    H = PauliSum.from_dict(n, {})
    i = 0
    theta = np.asarray(theta, dtype=np.float64)
    for C in cliques:
        for y in itertools.product([0, 1], repeat=len(C)):
            H = H + sufficient_statistic(n, C, y) * float(-theta[i])
            i += 1
    return H


def conjugate_blocks(A: PauliSum) -> PauliSum:
    """Block unitary with ``A`` and ``A†`` on its diagonal, on n+1 qubits.

    Parity with reference QCMRF._conjugateBlocks (QCMRF.py:195-197, unused
    there): ``((I+Z)/2) ⊗ A + ((I-Z)/2) ⊗ A†`` with the new qubit as the
    leading (MSB) variable.
    """
    n1 = A.n + 1
    d: Dict[int, float] = {}
    for m, c in A.terms:
        # A is self-adjoint in this real Z-string algebra, so the two
        # blocks coincide: ((I+Z)/2 + (I-Z)/2) ⊗ A = I ⊗ A.
        d[m] = d.get(m, 0.0) + c
    return PauliSum.from_dict(n1, d)
