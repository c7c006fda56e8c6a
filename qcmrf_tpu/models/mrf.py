"""Markov random field model core (pure JAX, no circuits).

This module is the JAX replacement for the reference's external
``kiopto_native`` exact-inference engine (reference call sites:
/root/reference/eval.py:84-93, /root/reference/run_experiment.py:26-27) and
for the model bookkeeping in ``QCMRF.__init__`` (/root/reference/QCMRF.py:36-80).

Representation
--------------
An :class:`MRF` over ``n`` binary variables is a pytree with

* ``theta`` — flat parameter vector of dimension ``d = sum_C 2**|C|``,
  laid out **clique-major**, within a clique in binary-counting order of the
  clique state ``y`` with ``y[0]`` slowest (the verified kiopto/QCMRF layout,
  SURVEY.md Appendix A item 2; reference /root/reference/QCMRF.py:188-192).
* ``beta`` — inverse temperature (reference QCMRF.py:21).
* static metadata: the clique structure.

State ids use variable 0 as the **MSB** (SURVEY.md Appendix A item 3).

All heavy ops are vectorized gathers over padded clique index arrays so they
trace to a handful of XLA ops regardless of the number of cliques — no Python
loop over states, and shardable over the state axis (see
``qcmrf_tpu.parallel``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _normalize_cliques(cliques) -> Tuple[Tuple[int, ...], ...]:
    if (
        not isinstance(cliques, (list, tuple))
        or len(cliques) == 0
        or not isinstance(cliques[0], (list, tuple))
        or len(cliques[0]) == 0
        or not isinstance(cliques[0][0], (int, np.integer))
    ):
        raise ValueError(
            "The set of cliques is not set properly. "
            "Type must be list of list of int."
        )
    return tuple(tuple(int(v) for v in C) for C in cliques)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MRF:
    """A binary pairwise-or-higher-order MRF in log-linear form.

    ``p(x) = exp(beta * theta^T phi(x)) / Z(beta)`` where ``phi`` is the
    one-hot clique-state indicator vector (reference semantics verified in
    SURVEY.md Appendix A item 4).
    """

    theta: jax.Array
    beta: jax.Array
    cliques: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    n: int = dataclasses.field(metadata=dict(static=True))

    # ---- constructors -------------------------------------------------

    @staticmethod
    def create(
        cliques: Sequence[Sequence[int]],
        theta=None,
        beta: float = 1.0,
        n: int = None,
    ) -> "MRF":
        """``n`` defaults to ``max clique variable + 1``; pass it
        explicitly when trailing variables appear in no clique (isolated
        variables contribute a free factor of 2 to Z and a uniform bit
        to samples — e.g. evidence-reduced models from
        ``models.moments.reduce_evidence``)."""
        cliques = _normalize_cliques(cliques)
        n_min = max(v for C in cliques for v in C) + 1
        if n is None:
            n = n_min
        elif n < n_min:
            raise ValueError(
                f"n={n} is smaller than the largest clique variable "
                f"requires (>= {n_min})")
        dim = sum(1 << len(C) for C in cliques)
        if theta is None:
            theta = jnp.zeros((dim,), dtype=jnp.float32)
        else:
            theta = jnp.asarray(theta, dtype=jnp.float32)
            if theta.shape != (dim,):
                raise ValueError(
                    "The parameter vector has an incorrect dimension. "
                    f"Expected: {dim}"
                )
        return MRF(
            theta=theta,
            beta=jnp.asarray(beta, dtype=jnp.float32),
            cliques=cliques,
            n=n,
        )

    # ---- static structure ---------------------------------------------

    @property
    def num_vertices(self) -> int:
        return self.n

    # alias, matching reference QCMRF.py:109
    num_nodes = num_vertices

    @property
    def num_cliques(self) -> int:
        return len(self.cliques)

    @property
    def dimension(self) -> int:
        return sum(1 << len(C) for C in self.cliques)

    @property
    def max_clique(self) -> int:
        return max(len(C) for C in self.cliques)

    @property
    def num_states(self) -> int:
        return 1 << self.n

    @property
    def theta_offsets(self) -> Tuple[int, ...]:
        """Start offset of each clique's parameter block in ``theta``."""
        offs, o = [], 0
        for C in self.cliques:
            offs.append(o)
            o += 1 << len(C)
        return tuple(offs)

    @functools.cached_property
    def _index_tables(self):
        """Padded numpy constants used by the vectorized gathers.

        Returns (shifts, places, offsets):
          * ``shifts[k, i]`` — right-shift extracting variable ``i`` of
            clique ``k`` from a state id (``n-1-v``), 0 where padded.
          * ``places[k, i]`` — left-shift placing that bit into the clique
            state index ``y`` (``|C|-1-i``), with padded slots masked by -1.
          * ``offsets[k]`` — flat offset of clique ``k``'s block in theta.
        """
        K = self.num_cliques
        cmax = self.max_clique
        shifts = np.zeros((K, cmax), dtype=np.int32)
        places = np.full((K, cmax), -1, dtype=np.int32)
        for k, C in enumerate(self.cliques):
            m = len(C)
            for i, v in enumerate(C):
                shifts[k, i] = self.n - 1 - v
                places[k, i] = m - 1 - i
        offsets = np.asarray(self.theta_offsets, dtype=np.int32)
        return shifts, places, offsets

    # ---- clique-state indexing -----------------------------------------

    def clique_state_indices(self, x) -> jax.Array:
        """For state ids ``x``: index ``y`` of each clique's local state.

        Shape ``x.shape + (num_cliques,)``; entry ``[..., k]`` is the
        binary-counting index of clique ``k``'s configuration in ``x``.
        """
        shifts, places, _ = self._index_tables
        x = jnp.asarray(x, dtype=jnp.int32)
        bits = (x[..., None, None] >> shifts) & 1  # (..., K, cmax)
        valid = places >= 0
        contrib = jnp.where(valid, bits << jnp.maximum(places, 0), 0)
        return contrib.sum(axis=-1).astype(jnp.int32)  # (..., K)

    def suff_stat_flat_indices(self, x) -> jax.Array:
        """Flat indices into ``theta`` of the active clique-states of ``x``."""
        _, _, offsets = self._index_tables
        return self.clique_state_indices(x) + offsets

    def phi(self, x) -> jax.Array:
        """Dense one-hot sufficient-statistics vector(s), shape (..., d)."""
        idx = self.suff_stat_flat_indices(x)
        return (
            jax.nn.one_hot(idx, self.dimension, dtype=self.theta.dtype)
            .sum(axis=-2)
        )

    # ---- potentials & exact inference ----------------------------------

    def log_potential(self, x) -> jax.Array:
        """``theta^T phi(x)`` for integer state ids ``x`` (any shape).

        Parity with ``px.logpot(b, xid)`` (reference eval.py:92).
        """
        return self.theta[self.suff_stat_flat_indices(x)].sum(axis=-1)

    def all_log_potentials(self) -> jax.Array:
        """``theta^T phi(x)`` for all ``2**n`` states (n <= ~26 single chip)."""
        x = jnp.arange(self.num_states, dtype=jnp.int32)
        return self.log_potential(x)

    def log_partition(self) -> jax.Array:
        """``ln Z(beta)``; parity with ``px.infer(b, task='partition')``
        (reference eval.py:88)."""
        return jax.scipy.special.logsumexp(self.beta * self.all_log_potentials())

    def gibbs_probs(self) -> jax.Array:
        """Exact Gibbs distribution over all ``2**n`` states."""
        return jax.nn.softmax(self.beta * self.all_log_potentials())

    def success_rate(self) -> jax.Array:
        """Theoretical post-selection success rate ``Z / 2**n`` of the
        QCMRF circuit (SURVEY.md Appendix A item 5). Requires theta <= 0."""
        return jnp.exp(self.log_partition() - self.n * jnp.log(2.0))

    # ---- training-facing quantities ------------------------------------

    def nll(self, x_batch) -> jax.Array:
        """Average negative log-likelihood of observed state ids.

        ``jax.grad`` of this w.r.t. ``theta`` is ``E_p[phi] - E_data[phi]``
        (autodiff through logsumexp), enabling maximum-likelihood fitting —
        a new capability with no reference counterpart (the reference only
        evaluates fixed random draws).
        """
        return self.log_partition() - self.beta * jnp.mean(
            self.log_potential(x_batch)
        )

    def with_theta(self, theta) -> "MRF":
        return dataclasses.replace(self, theta=jnp.asarray(theta, self.theta.dtype))


def chain_mrf(n: int, theta=None, beta: float = 1.0) -> MRF:
    """Convenience: n-variable chain with edges (i, i+1)."""
    return MRF.create([[i, i + 1] for i in range(n - 1)], theta=theta, beta=beta)


def grid_mrf(rows: int, cols: int, theta=None, beta: float = 1.0) -> MRF:
    """Convenience: rows x cols grid MRF (used for the >20-qubit scaling
    benchmarks; BASELINE.json config 5)."""
    def vid(r, c):
        return r * cols + c

    cliques = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                cliques.append([vid(r, c), vid(r, c + 1)])
            if r + 1 < rows:
                cliques.append([vid(r, c), vid(r + 1, c)])
    return MRF.create(cliques, theta=theta, beta=beta)
