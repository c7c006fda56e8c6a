"""Noise channels applied to outcome distributions.

Replaces the reference's IBM-hardware execution + readout-error machinery
(run_experiment.py:65-78; stored quasi-dists in res_*/result_{torino,
sherbrooke,ehningen}.json) with JAX emulation (SURVEY.md §2.3 N6).

Because every QCMRF observable is a *measurement distribution*, noise can be
applied directly to the joint outcome distribution:

* **Depolarizing accumulation** — a depolarizing channel of rate ``p`` per
  2-qubit gate composes into a global mixture: after ``G`` gates the outcome
  distribution is ``(1-p)^G * ideal + (1 - (1-p)^G) * uniform``. ``G`` is
  taken from the lowered basis-gate circuit (cx count), so bigger graphs
  degrade more — reproducing the stored fidelity-vs-size falloff.
* **Readout confusion** — per-measured-bit 2x2 stochastic matrices
  ``[[1-e01, e10], [e01, 1-e10]]`` applied as tensor contractions over the
  key distribution (the probability-space analog of a 1q gate apply; same
  reshape pattern as sim.dense.apply_1q, XLA-fused).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class ReadoutError:
    """Asymmetric per-qubit readout flip rates."""

    e01: float  # P(read 1 | true 0)
    e10: float  # P(read 0 | true 1)

    @property
    def confusion(self) -> np.ndarray:
        """Column-stochastic: M[m, t] = P(measured m | true t)."""
        return np.array(
            [[1 - self.e01, self.e10], [self.e01, 1 - self.e10]],
            dtype=np.float64,
        )

    @property
    def inverse(self) -> np.ndarray:
        return np.linalg.inv(self.confusion)


def apply_bit_matrix(probs: jax.Array, M, bit: int, width: int) -> jax.Array:
    """Contract a 2x2 matrix over one bit of a ``2**width`` distribution."""
    lo = 1 << bit
    hi = 1 << (width - 1 - bit)
    p = probs.reshape(hi, 2, lo)
    M = jnp.asarray(M, dtype=probs.dtype)
    return jnp.einsum("mt,htl->hml", M, p).reshape(-1)


def apply_readout_confusion(
    probs: jax.Array,
    errors: Sequence[ReadoutError],
    width: int,
    measured_bits: Optional[Sequence[int]] = None,
    invert: bool = False,
) -> jax.Array:
    """Apply (or invert) per-bit readout confusion on a key distribution."""
    if measured_bits is None:
        measured_bits = range(width)
    for bit, err in zip(measured_bits, errors):
        M = err.inverse if invert else err.confusion
        probs = apply_bit_matrix(probs, M, bit, width)
    return probs


def depolarize(probs: jax.Array, p_per_gate: float, num_gates: int) -> jax.Array:
    """Global depolarizing mixture after ``num_gates`` noisy gates."""
    keep = float((1.0 - p_per_gate) ** num_gates)
    u = 1.0 / probs.shape[0]
    return keep * probs + (1.0 - keep) * u


def mitigation_overhead(errors: Sequence[ReadoutError]) -> float:
    """1-norm amplification of the tensored inverse-confusion map — the
    analog of the per-circuit ``readout_mitigation_overhead`` recorded in
    the stored hardware metadata (1.13-2.68x in the reference files)."""
    total = 1.0
    for e in errors:
        total *= float(np.abs(e.inverse).sum(axis=0).max())
    return total
