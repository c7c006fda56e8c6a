"""Batched (vmapped) suite execution, bucketed by graph shape.

The reference submits all 70 circuits to Aer in one call
(run_experiment.py:52-56) and lets OpenMP parallelize; the equivalent here
is ``jax.vmap`` over the parameter axis for every group of same-shape
circuits (the 10 reps of each graph share a shape, SURVEY.md §7 item 3),
jit-compiled once per shape bucket.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.sim import analytic, dense

#: widest circuit the vmapped dense suite path takes: each draw holds a
#: complex64 2^width statevector (the reference suite's circuits have
#: <= 10 qubits; wider circuits belong to sim.tpu or parallel.sharded)
MAX_SUITE_WIDTH = 20


@functools.partial(jax.jit, static_argnums=(0,))
def _batched_joint_probs(cliques: Tuple[Tuple[int, ...], ...],
                         thetas: jax.Array, beta: jax.Array) -> jax.Array:
    template = MRF.create(cliques)

    def one(theta):
        m = MRF(theta=theta, beta=beta, cliques=template.cliques,
                n=template.n)
        return analytic.joint_outcome_probs(m)

    return jax.vmap(one)(thetas)


def batched_joint_probs(cliques, thetas, beta: float = 1.0) -> jax.Array:
    """Joint outcome distributions for a stack of thetas on one graph.

    Returns ``(B, 2**(n+K+1))``.
    """
    cliques = tuple(tuple(int(v) for v in C) for C in cliques)
    thetas = jnp.asarray(thetas, jnp.float32)
    return _batched_joint_probs(cliques, thetas,
                                jnp.asarray(beta, jnp.float32))


@functools.partial(jax.jit, static_argnums=(0, 3))
def _batched_sample(cliques, thetas, key, shots):
    template = MRF.create(cliques)

    def one(theta, k):
        m = MRF(theta=theta, beta=jnp.float32(1.0),
                cliques=template.cliques, n=template.n)
        return analytic.sample_outcomes(k, m, shots)

    keys = jax.random.split(key, thetas.shape[0])
    return jax.vmap(one)(thetas, keys)


def batched_sample_outcomes(cliques, thetas, key, shots: int) -> jax.Array:
    """Shot-sampled measurement keys for a stack of thetas, ``(B, shots)``.

    Never materializes any 2**n-sized array — the n=20+ throughput path.
    """
    cliques = tuple(tuple(int(v) for v in C) for C in cliques)
    thetas = jnp.asarray(thetas, jnp.float32)
    return _batched_sample(cliques, thetas, key, shots)


@functools.partial(jax.jit, static_argnums=(0,))
def _batched_gibbs_probs(cliques, thetas, beta):
    template = MRF.create(cliques)

    def one(theta):
        m = MRF(theta=theta, beta=beta, cliques=template.cliques,
                n=template.n)
        return m.gibbs_probs()

    return jax.vmap(one)(thetas)


def batched_gibbs_probs(cliques, thetas, beta: float = 1.0) -> jax.Array:
    """Exact Gibbs distributions for a stack of thetas on one graph,
    ``(B, 2**n)`` — one jit dispatch per graph instead of one per rep
    (the evaluation harness hot path)."""
    cliques = tuple(tuple(int(v) for v in C) for C in cliques)
    thetas = jnp.asarray(thetas, jnp.float32)
    return _batched_gibbs_probs(cliques, thetas,
                                jnp.asarray(beta, jnp.float32))


@functools.partial(jax.jit, static_argnums=(0,))
def _batched_circuit_probs(cliques, gammas):
    from qcmrf_tpu.circuits.compiler import compile_qcmrf

    template = MRF.create([list(C) for C in cliques])

    def one(gamma):
        return dense.simulate_probs(compile_qcmrf(template, gamma=gamma))

    return jax.vmap(one)(gammas)


def batched_circuit_probs(cliques, thetas, beta: float = 1.0) -> jax.Array:
    """Gate-level outcome distributions for a stack of thetas on one
    graph, ``(B, 2**(n+K+1))``: the dense complex-statevector engine over
    the compiled QCMRF circuit, vmapped over the draws (one dispatch per
    graph)."""
    from qcmrf_tpu.circuits.params import (theta_to_gamma,
                                           validate_theta_domain)

    cliques = tuple(tuple(int(v) for v in C) for C in cliques)
    template = MRF.create([list(C) for C in cliques])
    width = template.n + template.num_cliques + 1
    if width > MAX_SUITE_WIDTH:
        raise ValueError(
            f"circuit width {width} exceeds the vmapped dense path's "
            f"limit (max {MAX_SUITE_WIDTH}); use sim.tpu or "
            "parallel.sharded for wider circuits")
    # the arccos runs in float64 on the host: float32 loses the
    # conditioning near theta = 0 (circuits.params._xp)
    thetas64 = np.asarray(thetas, np.float64)
    validate_theta_domain(thetas64)
    gammas = jnp.asarray(np.asarray(theta_to_gamma(thetas64, beta)),
                         jnp.float32)
    return _batched_circuit_probs(cliques, gammas)


def run_suite_probs(suite) -> List[np.ndarray]:
    """Exact joint distributions for every circuit of a suite, suite order."""
    out: List[np.ndarray] = []
    for j, C in enumerate(suite.graphs):
        thetas = np.asarray(suite.thetas[j], dtype=np.float32)
        probs = np.asarray(batched_joint_probs(C, thetas))
        out.extend(list(probs))
    return out
