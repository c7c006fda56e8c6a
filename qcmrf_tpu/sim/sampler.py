"""Shot sampling and counts-dict conversion.

Replaces Aer's multinomial shot sampling (reference run_experiment.py:56-57)
with ``jax.random.categorical`` and produces counts dicts in the exact JSON
schema of the stored ``result_simulation_*.json`` files: ``{bitstring:
count}`` with keys of width ``n + K + 1`` summing to the shot count.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from qcmrf_tpu.utils.bits import key_string


@functools.partial(jax.jit, static_argnums=(2,))
def sample_from_probs(key: jax.Array, probs: jax.Array, shots: int) -> jax.Array:
    """Draw ``shots`` outcome indices from a probability vector.

    Inverse-CDF multinomial: ``shots`` uniforms + a vectorized binary
    search. ``jax.random.categorical`` would materialize a
    ``(shots, num_states)`` Gumbel table — 4e8 threefry draws for 400k
    shots over 1024 outcomes (~5 min on one CPU core, measured; this
    formulation takes milliseconds, on an accelerator too). Zero-
    probability outcomes are never selected: their inclusive-cdf entry
    equals their predecessor's, so no ``u`` lands strictly inside.
    """
    p = probs / jnp.sum(probs)
    cdf = jnp.cumsum(p)
    u = jax.random.uniform(key, (shots,), dtype=cdf.dtype)
    idx = jnp.searchsorted(cdf, u, side="right")
    return jnp.clip(idx, 0, probs.shape[0] - 1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(1,))
def histogram(samples: jax.Array, length: int) -> jax.Array:
    """Dense outcome histogram on device."""
    return jnp.bincount(samples, length=length)


def counts_from_samples(samples, width: int) -> Dict[str, int]:
    """Counts dict (reference result-JSON schema) from outcome indices."""
    samples = np.asarray(samples)
    vals, cnts = np.unique(samples, return_counts=True)
    return {key_string(int(v), width): int(c) for v, c in zip(vals, cnts)}


def counts_to_probs(counts: Dict[str, float], width: int) -> np.ndarray:
    """Dense outcome distribution from a counts / quasi-prob dict."""
    out = np.zeros(1 << width, dtype=np.float64)
    total = 0.0
    for k, v in counts.items():
        out[int(k, 2)] += v
        total += v
    if total > 0:
        out /= total
    return out


def sample_counts(key: jax.Array, probs: jax.Array, shots: int,
                  width: int) -> Dict[str, int]:
    """One-call helper: multinomial shots -> counts dict."""
    samples = sample_from_probs(key, probs, shots)
    return counts_from_samples(samples, width)
