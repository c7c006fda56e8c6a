"""QCMRF circuit compiler: MRF -> circuit IR.

Reproduces the construction of the reference's ``QCMRF._build``
(/root/reference/QCMRF.py:199-243) exactly, on the IR of
:mod:`qcmrf_tpu.circuits.ir`:

* qubit budget ``n + num_cliques + 1`` (QCMRF.py:78): qubits ``0..n-1``
  hold the variables with the reflection ``v -> (n-1)-v`` (QCMRF.py:219),
  qubit ``n`` is the shared AND-workspace qubit (only materialized by the
  basis-gate lowering), qubits ``n+1+ii`` are per-clique ancillas;
* a Hadamard wall on the variable qubits (QCMRF.py:204-205);
* per clique a controlled factor unitary cU_C of per-state blocks
  [AND(flags) -> cp(2*gamma_i) -> AND†] (QCMRF.py:221-228), represented
  here as one fused ``flags_phase`` per clique state (the diagonal
  semantics of the sandwich), skipping near-zero gamma exactly as the
  reference does (QCMRF.py:223);
* the real-part-extraction sandwich H · cU_C · X · cU_C^-1 · X · H on the
  clique ancilla (QCMRF.py:230-236);
* ancilla and variable measurements (QCMRF.py:238-243).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence

import numpy as np

from qcmrf_tpu.circuits import params as cparams
from qcmrf_tpu.circuits.ir import Circuit
from qcmrf_tpu.models.mrf import MRF


@dataclasses.dataclass
class QCMRF:
    """A compiled QCMRF: the MRF model plus its measurement circuit.

    API-parity facade for the reference's ``QCMRF(QuantumCircuit)`` class
    (QCMRF.py:13-157) — same constructor arguments and properties, but
    idiomatically a *composition* of an :class:`MRF` and a :class:`Circuit`
    rather than a circuit subclass.
    """

    #: default lowering basis, parity with the reference's stored-but-
    #: unused ctor argument (QCMRF.py:25,43); consumed by circuits.lower
    DEFAULT_BASIS_GATES = ("cx", "id", "rz", "sx", "x")

    mrf: MRF
    circuit: Circuit
    with_measurements: bool = True
    with_barriers: bool = False
    basis_gates: Sequence[str] = DEFAULT_BASIS_GATES

    # ---- constructor ------------------------------------------------------

    @staticmethod
    def build(
        cliques: Sequence[Sequence[int]],
        theta=None,
        gamma=None,
        beta: float = 1.0,
        name: str = "QCMRF",
        with_measurements: bool = True,
        with_barriers: bool = False,
        basis_gates: Sequence[str] = DEFAULT_BASIS_GATES,
        init_key=None,
    ) -> "QCMRF":
        # dimension check happens in MRF.create; resolve theta first
        probe = MRF.create(cliques)
        dim = probe.dimension
        if gamma is not None:
            gamma = np.asarray(gamma, dtype=np.float64)
            if gamma.shape != (dim,):
                raise ValueError(
                    "The QCMRF parameter vector has an incorrect dimension. "
                    f"Expected: {dim}"
                )
            # this facade is MRF-backed: gamma must map to a finite
            # theta <= 0, i.e. cos(2*gamma) in (0, 1] (|gamma| < pi/4).
            # The reference accepts any gamma (QCMRF.py:221-228 feeds it
            # straight into the phase gates, converting to theta only
            # lazily), but such circuits correspond to no MRF (c2 > 1 is
            # not a probability) — raise rather than silently building
            # an all-NaN circuit through 2*log(cos(2*gamma)).
            if not np.all(np.cos(2.0 * gamma) > 0.0):
                raise ValueError(
                    "gamma must satisfy |gamma| < pi/4 so that "
                    "cos(2*gamma) in (0, 1] defines a valid MRF weight"
                )
            theta = np.asarray(cparams.gamma_to_theta(gamma, beta))
        elif theta is None:
            # uniform U(-5, 0) init, parity with QCMRF.py:210-213
            if init_key is not None:
                import jax

                theta = jax.random.uniform(
                    init_key, (dim,), minval=-5.0, maxval=0.0
                )
                theta = np.asarray(theta, dtype=np.float64)
            else:
                theta = np.random.uniform(low=-5.0, high=0.0, size=dim)
        else:
            theta = np.asarray(theta, dtype=np.float64)
            if theta.shape != (dim,):
                raise ValueError(
                    "The parameter vector has an incorrect dimension. "
                    f"Expected: {dim}"
                )
            cparams.validate_theta_domain(theta)

        mrf = MRF.create(cliques, theta=theta, beta=beta)
        circuit = compile_qcmrf(
            mrf,
            with_measurements=with_measurements,
            with_barriers=with_barriers,
            name=name,
        )
        return QCMRF(
            mrf=mrf,
            circuit=circuit,
            with_measurements=with_measurements,
            with_barriers=with_barriers,
            basis_gates=tuple(basis_gates),
        )

    # ---- reference-parity properties ---------------------------------------

    @property
    def dimension(self) -> int:
        return self.mrf.dimension

    @property
    def cliques(self):
        return [list(C) for C in self.mrf.cliques]

    @property
    def num_vertices(self) -> int:
        return self.mrf.n

    num_nodes = num_vertices  # alias (QCMRF.py:109)

    @property
    def num_cliques(self) -> int:
        return self.mrf.num_cliques

    @property
    def max_clique(self) -> int:
        return self.mrf.max_clique

    @property
    def theta(self) -> List[float]:
        return np.asarray(self.mrf.theta, dtype=np.float64).tolist()

    @property
    def gamma(self) -> List[float]:
        g = cparams.theta_to_gamma(
            np.asarray(self.mrf.theta, np.float64), float(self.mrf.beta)
        )
        return np.asarray(g).tolist()

    @property
    def num_qubits(self) -> int:
        return self.circuit.num_qubits

    def lowered(self, style: str = "fused", optimize: int = 0) -> Circuit:
        """The circuit lowered to ``self.basis_gates`` (the reference's
        ``transpile(..., basis_gates=...)``, run_experiment.py:52). Only
        the reference basis is implemented; a different basis raises.
        ``optimize=1`` applies the fused-diagonal merge (the analog of
        qiskit's optimization_level=1 commuting-diagonal collection)."""
        if set(self.basis_gates) != set(self.DEFAULT_BASIS_GATES):
            raise ValueError(
                f"unsupported basis {self.basis_gates!r}; the lowering "
                f"pass targets {self.DEFAULT_BASIS_GATES!r}"
            )
        from qcmrf_tpu.circuits.lower import lower

        # workspace passed explicitly: the compiler's layout reserves
        # qubit n, and the facade knows n (the IR alone does not)
        return lower(self.circuit, style=style, workspace=self.mrf.n,
                     optimize=optimize)

    # ---- operator-level helpers (reference QCMRF.py:159-197) --------------

    def sufficient_statistic(self, C, y):
        """Pauli-Markov sufficient statistic phi_{C,y} as a Z-string sum
        (parity with QCMRF.sufficient_statistic, QCMRF.py:159-179)."""
        from qcmrf_tpu.models import pauli

        return pauli.sufficient_statistic(self.mrf.n, C, y)

    def Hamiltonian(self):
        """Diagonal MRF Hamiltonian H = sum_i -theta_i phi_i (parity with
        QCMRF.Hamiltonian, QCMRF.py:181-193)."""
        from qcmrf_tpu.models import pauli

        return pauli.hamiltonian(
            self.mrf.n, self.mrf.cliques, np.asarray(self.mrf.theta)
        )

    def _conjugate_blocks(self, A):
        """Block unitary diag(A, A†) (parity with QCMRF._conjugateBlocks,
        QCMRF.py:195-197 — unused by the reference build as well)."""
        from qcmrf_tpu.models import pauli

        return pauli.conjugate_blocks(A)

    # ---- layout -----------------------------------------------------------

    @property
    def workspace_qubit(self) -> int:
        return self.mrf.n

    @property
    def ancilla_qubits(self) -> List[int]:
        n = self.mrf.n
        return [n + 1 + ii for ii in range(self.mrf.num_cliques)]


def compile_qcmrf(
    mrf: MRF,
    with_measurements: bool = True,
    with_barriers: bool = False,
    name: str = "QCMRF",
    gamma=None,
) -> Circuit:
    """Emit the QCMRF circuit IR for an MRF (see module docstring).

    ``gamma`` (optional, may be traced) replaces the angles derived from
    ``mrf.theta`` and keeps every phase block, zero angles included, so
    one gate structure serves a vmapped batch of parameter draws."""
    n = mrf.n
    K = mrf.num_cliques
    num_main = n + 1  # variables + workspace (QCMRF.py:202)
    nq = n + K + 1
    qc = Circuit(num_qubits=nq, num_clbits=nq, name=name)

    skip_zero = gamma is None
    if skip_zero:
        theta = np.asarray(mrf.theta, dtype=np.float64)
        cparams.validate_theta_domain(theta)
        gamma = np.asarray(
            cparams.theta_to_gamma(theta, float(mrf.beta)),
            dtype=np.float64)

    for q in range(n):
        qc.h(q)
    if with_barriers:
        qc.barrier()

    i = 0
    for ii, C in enumerate(mrf.cliques):
        anc = num_main + ii
        var_qubits = [(n - 1) - v for v in C]  # reflection, QCMRF.py:219

        # cU_C as a list of fused per-state diagonal phases
        blocks = []  # (flags, angle)
        for y in itertools.product([0, 1], repeat=len(C)):
            # skip rule, QCMRF.py:223
            if not skip_zero or not np.isclose(gamma[i], 0):
                flags = tuple(int(b) * 2 - 1 for b in y)
                blocks.append((flags, 2.0 * gamma[i]))
            i += 1

        # Real part extraction: H · cU_C · X · cU_C^-1 · X · H (QCMRF.py:230-236)
        qc.h(anc)
        for flags, angle in blocks:
            qc.flags_phase(var_qubits, flags, angle, control=anc)
        qc.x(anc)
        for flags, angle in reversed(blocks):
            qc.flags_phase(var_qubits, flags, -angle, control=anc)
        qc.x(anc)
        qc.h(anc)

        if with_measurements:
            qc.measure(anc, anc)  # success when 0 (QCMRF.py:239)
        if with_barriers:
            qc.barrier()

    if with_measurements:
        for q in range(n):
            qc.measure(q, q)  # QCMRF.py:242-243

    return qc
