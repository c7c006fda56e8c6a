"""Annealed importance sampling: stochastic ln Z for ANY structure/size.

The exact backends cover bounded induced width at any n (elimination,
models/elimination.py) and arbitrary width to n <= 47 (streaming sweeps,
models/moments.py). A wide structure PAST that structural cap has no
exact ln Z — the reference oracle (px, SURVEY.md §2.3 N5) simply refuses
there too. AIS (Neal 2001) fills the hole with an unbiased-in-Z,
diagnosable estimator built from pieces the framework already has:

* the annealing path p_t(x) ∝ exp(beta_t · beta · theta^T phi(x)) runs
  from the UNIFORM distribution (beta_0 = 0, ln Z_0 = n ln 2 — exactly
  samplable) to the target model (beta_T = 1);
* the transition at each rung is the systematic-scan bit-array Gibbs
  sweep (the local-delta core shared with models/sample.py::
  sample_gibbs_bits via ``bits_site_delta_fn`` — no state-id width
  limit, so any n);
* chains are vmapped (one (M, n) bit matrix), rungs run under
  ``lax.scan`` — a single jit-compiled program per (structure, M, T).

ln Z_hat = n ln 2 + logsumexp(log w) − ln M is consistent as M → ∞ and
its importance weights carry their own error bar: the effective sample
size and a delta-method standard error are returned alongside.
Device notes: the per-site updates are O(K) scalar gathers vmapped over
M chains — an (M,)-wide elementwise program, compiling once per structure
(same profile as the bit-array Gibbs sampler it reuses).
"""

import functools

import jax
import jax.numpy as jnp

from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.models.sample import bits_site_delta_fn

__all__ = ["ais_log_partition", "ais_clique_marginals",
           "ais_event_prob", "logpot_bits"]


def logpot_bits(mrf: MRF, bits: jax.Array) -> jax.Array:
    """``theta^T phi(x)`` for one bit-array state ``bits`` of shape
    ``(n,)`` int32 (variable v at index v; no state-id width limit).

    The bit-array counterpart of ``MRF.log_potential`` (which takes
    int32 state ids and therefore caps at n = 30)."""
    offs = mrf.theta_offsets
    val = jnp.zeros((), mrf.theta.dtype)
    for k, C in enumerate(mrf.cliques):
        m = len(C)
        idx = jnp.zeros((), jnp.int32)
        for j, u in enumerate(C):
            idx = idx + (bits[u] << (m - 1 - j))
        val = val + mrf.theta[offs[k] + idx]
    return val


def _ais_body(key, mrf, num_chains, num_temps, sweeps_per_temp):
    """(log-weights (M,), final bits (M, n)) for the linear schedule.

    Pure body shared by the single-device jit (:data:`_ais_run`) and
    the per-device program of the mesh path (:func:`_build_mesh_run`)."""
    n = mrf.n
    site_delta = bits_site_delta_fn(mrf)
    lp = jax.vmap(lambda b: logpot_bits(mrf, b))

    def sweep(bits, key_sweep, scale):
        keys = jax.random.split(key_sweep, n)
        for v in range(n):  # static unroll: structure differs per site
            d = jax.vmap(lambda b: site_delta(v, b))(bits)
            p1 = jax.nn.sigmoid(scale * mrf.beta * d)
            b = jax.random.bernoulli(keys[v], p1)
            bits = bits.at[:, v].set(b.astype(jnp.int32))
        return bits

    key_init, key_chain = jax.random.split(key)
    bits0 = jax.random.bernoulli(
        key_init, 0.5, (num_chains, n)).astype(jnp.int32)
    betas = jnp.linspace(0.0, 1.0, num_temps + 1)

    def rung(carry, inp):
        bits, logw = carry
        b_prev, b_cur, k = inp
        # weight update at the PREVIOUS state (Neal 2001 eq. 3):
        # log w += (beta_t − beta_{t−1}) · beta · theta^T phi(x_{t−1})
        logw = logw + (b_cur - b_prev) * mrf.beta * lp(bits)
        ks = jax.random.split(k, sweeps_per_temp)
        for s in range(sweeps_per_temp):
            bits = sweep(bits, ks[s], b_cur)
        return (bits, logw), None

    keys = jax.random.split(key_chain, num_temps)
    (bits, logw), _ = jax.lax.scan(
        rung, (bits0, jnp.zeros((num_chains,), mrf.theta.dtype)),
        (betas[:-1], betas[1:], keys))
    return logw, bits


_ais_run = functools.partial(jax.jit, static_argnums=(2, 3, 4))(_ais_body)


@functools.lru_cache(maxsize=64)
def _build_mesh_run(cliques, n, chains_per_dev, num_temps,
                    sweeps_per_temp, mesh):
    """Compiled mesh program: every device anneals its own
    ``chains_per_dev`` chains (key fold_in by device index — chains are
    IID, so sharding them is pure data parallelism with no communication until
    the host-side weight pooling), log-weights and final bits return
    sharded along the chain axis."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    template = MRF.create([list(C) for C in cliques])

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(axis), P(axis)), check_vma=False,
    )
    def run(key, theta, beta):
        m = MRF(theta=theta, beta=beta, cliques=template.cliques, n=n)
        dkey = jax.random.fold_in(key, jax.lax.axis_index(axis))
        return _ais_body(dkey, m, chains_per_dev, num_temps,
                         sweeps_per_temp)

    return run


def _run_any(key, mrf, num_chains, num_temps, sweeps_per_temp, mesh):
    if mesh is None:
        return _ais_run(key, mrf, int(num_chains), int(num_temps),
                        int(sweeps_per_temp))
    from qcmrf_tpu.parallel.sharded import _sweep_mesh

    mesh = _sweep_mesh(mesh)  # flatten a multi-axis AxB mesh
    D = mesh.devices.size
    if num_chains % D:
        raise ValueError(
            f"num_chains={num_chains} must divide over the "
            f"{D}-device mesh")
    run = _build_mesh_run(mrf.cliques, mrf.n, num_chains // D,
                          int(num_temps), int(sweeps_per_temp), mesh)
    return run(key, mrf.theta, mrf.beta)


def ais_log_partition(
    key: jax.Array,
    mrf: MRF,
    num_chains: int = 256,
    num_temps: int = 128,
    sweeps_per_temp: int = 1,
    return_diagnostics: bool = False,
    mesh=None,
):
    """AIS estimate of ``ln Z(beta)`` (optionally with diagnostics).

    With ``mesh``, the IID chains shard over the devices (pure data
    parallelism — each device anneals ``num_chains / D`` chains under
    a per-device folded key; the only cross-device work is pooling the
    (M,) log-weights at the end).

    With ``return_diagnostics=True`` returns ``(lnZ_hat, diag)`` where
    ``diag`` carries:

    * ``ess`` — Kish effective sample size of the importance weights
      (1/sum of squared normalized weights; M when all weights equal,
      → 1 as one chain dominates);
    * ``stderr`` — delta-method standard error of ln Z_hat
      (std of max-normalized weights / (mean · sqrt(M)));
    * ``log_weights`` — the raw (M,) log-weights, for custom pooling
      (estimates from independent keys combine by logsumexp − ln total).

    Unbiased in Z (not ln Z; Jensen makes ln Z_hat a stochastic LOWER
    bound in expectation) — report alongside ``ess``: a collapsed ESS
    means more rungs (``num_temps``) are needed, the usual failure mode
    under strong coupling."""
    logw, _ = _run_any(key, mrf, num_chains, num_temps,
                       sweeps_per_temp, mesh)
    M = logw.shape[0]
    lse = jax.scipy.special.logsumexp(logw)
    lnZ = mrf.n * jnp.log(2.0) + lse - jnp.log(float(M))
    if not return_diagnostics:
        return lnZ
    wn = jax.nn.softmax(logw)
    ess = 1.0 / jnp.sum(wn * wn)
    r = jnp.exp(logw - jnp.max(logw))
    stderr = jnp.std(r) / (jnp.mean(r) * jnp.sqrt(float(M)))
    return lnZ, {"ess": ess, "stderr": stderr, "log_weights": logw}


def ais_event_prob(
    key: jax.Array,
    mrf: MRF,
    v: int,
    value: int,
    num_chains: int = 256,
    num_temps: int = 128,
    sweeps_per_temp: int = 1,
    return_diagnostics: bool = False,
    mesh=None,
):
    """Self-normalized IS estimate of ``P(x_v = value)`` under the model.

    Same machinery and no-cap reach as :func:`ais_clique_marginals`
    (the final annealed states reweighted by their normalized
    importance weights), specialized to a single-variable event — the
    ``prob`` query's route where both exact backends refuse. Biased at
    finite M (ratio estimator); ``ess`` is the health signal."""
    logw, bits = _run_any(key, mrf, num_chains, num_temps,
                          sweeps_per_temp, mesh)
    wn = jax.nn.softmax(logw)
    p = jnp.sum(wn * (bits[:, int(v)] == int(value)))
    if not return_diagnostics:
        return p
    ess = 1.0 / jnp.sum(wn * wn)
    return p, {"ess": ess, "log_weights": logw}


def ais_clique_marginals(
    key: jax.Array,
    mrf: MRF,
    num_chains: int = 256,
    num_temps: int = 128,
    sweeps_per_temp: int = 1,
    return_diagnostics: bool = False,
    mesh=None,
):
    """Self-normalized IS estimate of ``E_p[phi]`` in theta layout.

    The final AIS states, reweighted by their normalized importance
    weights, are asymptotically distributed as the target — so a
    weighted one-hot scatter of each chain's clique-state indices gives
    consistent clique marginals with the same no-cap reach as
    :func:`ais_log_partition` (the `marginals` query's route where both
    exact backends refuse). Self-normalization makes this biased at
    finite M (ratio estimator); the returned ``ess`` is the health
    signal, exactly as for ln Z."""
    logw, bits = _run_any(key, mrf, num_chains, num_temps,
                          sweeps_per_temp, mesh)
    wn = jax.nn.softmax(logw)
    offs = mrf.theta_offsets
    mu = jnp.zeros((mrf.dimension,), mrf.theta.dtype)
    for k, C in enumerate(mrf.cliques):
        m = len(C)
        idx = jnp.zeros((logw.shape[0],), jnp.int32)
        for j, u in enumerate(C):
            idx = idx + (bits[:, u] << (m - 1 - j))
        mu = mu.at[offs[k] + idx].add(wn)
    if not return_diagnostics:
        return mu
    ess = 1.0 / jnp.sum(wn * wn)
    return mu, {"ess": ess, "log_weights": logw}
