"""Shared multilinear (Moebius) machinery.

One home for the two code shapes shared by sim.analytic and ops.kernels:

* :func:`transform` — fast Moebius (finite-difference) transform of padded
  per-clique tables, turning value tables into multilinear coefficients;
* :func:`eval_multilinear` — incremental bit-monomial FMA chain evaluating
  ``sum_s coef(s) * prod_{i in s} bits[i]`` with subset monomials built
  from their lowest-bit predecessor (each product computed once).

Both are pure jnp / python and work identically on any broadcastable
arrays: (…, K)-broadcast state batches and the sweeps' low planes.
"""

from __future__ import annotations

from typing import Callable, List


def transform(tab, cmax: int):
    """In-graph fast Moebius transform along the slot bits.

    ``tab``: (K, 2**cmax) padded per-clique tables, slot-encoded (bit i of
    the index <-> clique slot i). Returns the multilinear coefficients in
    the same layout; aliased padding slots produce zero coefficients.
    """
    import jax.numpy as jnp

    K = tab.shape[0]
    for i in range(cmax):
        t = tab.reshape(K, 1 << (cmax - 1 - i), 2, 1 << i)
        tab = jnp.concatenate(
            [t[:, :, :1], t[:, :, 1:] - t[:, :, :1]], axis=2
        ).reshape(K, 1 << cmax)
    return tab


def extract_bit_planes(x, variables, n: int):
    """0/1 float32 bit-plane per variable of state ids ``x`` (variable 0 =
    MSB convention; see qcmrf_tpu.utils.bits). Returns {var: plane} with
    one plane per *unique* variable, shared across cliques."""
    import jax.numpy as jnp

    return {
        v: ((x >> (n - 1 - v)) & 1).astype(jnp.float32)
        for v in sorted(set(variables))
    }


def eval_multilinear(bits: List, m: int, coef: Callable[[int], object],
                     acc):
    """``acc + sum_{s=0}^{2^m-1} coef(s) * prod_{i in s} bits[i]``.

    ``bits[i]`` are 0/1-valued arrays (any broadcastable shape), ``coef(s)``
    returns the coefficient for slot-subset ``s`` (scalar or array). The
    monomial for each subset is built from its lowest-set-bit predecessor,
    so every product is computed exactly once.
    """
    prods = {0: None}
    acc = acc + coef(0)
    for s in range(1, 1 << m):
        low = s & (-s)
        rest = s ^ low
        b = bits[low.bit_length() - 1]
        p = b if prods[rest] is None else prods[rest] * b
        prods[s] = p
        acc = acc + coef(s) * p
    return acc
