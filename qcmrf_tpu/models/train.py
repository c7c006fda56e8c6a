"""Maximum-likelihood MRF training (autodiff + optax), single- and multi-chip.

A new capability with no reference counterpart: the reference only
*evaluates* fixed random parameter draws (run_experiment.py:30), while this
module fits ``theta`` to observed samples by gradient descent on the exact
negative log-likelihood. The gradient is ``E_p[phi] - E_data[phi]``, obtained
for free by autodiff through the ``logsumexp`` partition function — no
contrastive-divergence approximation needed at the scales the exact table
supports (n <= ~28 sharded).

The multi-chip step shards along two axes of a ``jax.sharding.Mesh``:

* ``amp`` — the 2**n state table (the model-parallel axis; analog of
  tensor/sequence parallelism for this workload), reduced with ``psum``;
* ``data`` — the observed-sample batch (pure data parallelism).

The constraint ``theta <= 0`` (required by the circuit parameter map,
QCMRF.py:139) is kept by optimizing through a softplus reparameterization
when ``nonpositive=True``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from qcmrf_tpu.models.mrf import MRF

#: max induced width routed through variable elimination (defined with
#: every other regime cap in models/capability.py — one source of truth;
#: the historical underscore name stays for its many import sites)
from qcmrf_tpu.models.capability import ELIM_WIDTH_CAP as _ELIM_WIDTH_CAP


def _nll(mrf: MRF, theta: jax.Array, data: jax.Array) -> jax.Array:
    m = mrf.with_theta(theta)
    if mrf.n > 22:
        # enumeration's 2^n table stops scaling; bounded-treewidth models
        # use the (differentiable) variable-elimination lnZ, and
        # high-induced-width structures fall back to the streaming
        # custom-VJP sweep (exact for ANY cliques, n <= 31)
        from qcmrf_tpu.models import elimination

        if elimination.induced_width(m.cliques, m.n) <= _ELIM_WIDTH_CAP:
            lnZ = elimination.log_partition(m)
        else:
            from qcmrf_tpu.models import moments

            lnZ = moments.log_partition_streaming(m)
    else:
        lnZ = m.log_partition()
    return lnZ - m.beta * jnp.mean(m.log_potential(data))


@dataclasses.dataclass
class TrainState:
    raw: jax.Array          # unconstrained parameters
    opt_state: optax.OptState
    step: int = 0


def _to_theta(raw: jax.Array, nonpositive: bool) -> jax.Array:
    return -jax.nn.softplus(raw) if nonpositive else raw


def _from_theta(theta: jax.Array, nonpositive: bool) -> jax.Array:
    if not nonpositive:
        return jnp.asarray(theta)
    t = jnp.minimum(jnp.asarray(theta), -1e-4)
    # inverse softplus: raw = log(exp(-theta) - 1)
    return jnp.log(jnp.expm1(-t))


def make_train_step(
    template: MRF,
    optimizer: optax.GradientTransformation,
    nonpositive: bool = True,
) -> Callable:
    """Jitted single-device training step: (state, batch) -> (state, loss)."""

    @jax.jit
    def step(raw, opt_state, batch):
        def loss_fn(r):
            return _nll(template, _to_theta(r, nonpositive), batch)

        loss, g = jax.value_and_grad(loss_fn)(raw)
        updates, opt_state = optimizer.update(g, opt_state, raw)
        raw = optax.apply_updates(raw, updates)
        return raw, opt_state, loss

    return step


def fit_mle(
    mrf0: MRF,
    data: jax.Array,
    steps: int = 300,
    learning_rate: float = 0.1,
    nonpositive: bool = True,
    optimizer: Optional[optax.GradientTransformation] = None,
) -> Tuple[MRF, jax.Array]:
    """Fit theta to observed state ids; returns (fitted MRF, final loss)."""
    opt = optimizer or optax.adam(learning_rate)
    raw = _from_theta(mrf0.theta, nonpositive)
    opt_state = opt.init(raw)
    step = make_train_step(mrf0, opt, nonpositive)
    loss = jnp.inf
    for _ in range(steps):
        raw, opt_state, loss = step(raw, opt_state, data)
    return mrf0.with_theta(_to_theta(raw, nonpositive)), loss


# --------------------------------------------------------------------------
# Multi-chip training step (amp x data mesh)
# --------------------------------------------------------------------------


def make_sharded_train_step(
    template: MRF,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    nonpositive: bool = True,
) -> Callable:
    """Training step over a 2-D (amp, data) mesh.

    The state table is sharded over ``amp`` (each amp-shard evaluates its
    contiguous slice of log-potentials; logsumexp combines with psum), the
    batch over ``data`` (per-shard mean, psum-averaged). Parameters are
    replicated. Gradients flow through both collectives.
    """
    amp_axis, data_axis = mesh.axis_names
    n_amp = mesh.shape[amp_axis]
    dlog = int(math.log2(n_amp))
    assert (1 << dlog) == n_amp, "amp axis must be a power of two"
    chunk = template.num_states // n_amp

    def sharded_nll(raw, data):
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(data_axis)),
            out_specs=P(),
            check_vma=False,
        )
        def compute(raw_rep, data_local):
            from qcmrf_tpu.sim.analytic import log_potentials_fast

            theta = _to_theta(raw_rep, nonpositive)
            m = template.with_theta(theta)
            # --- amp axis: sharded exact logZ over the state table
            # (gather-free evaluation; the Moebius transform is linear in
            # theta so gradients flow through it exactly)
            d = jax.lax.axis_index(amp_axis)
            x = d * chunk + jnp.arange(chunk, dtype=jnp.int32)
            lp = log_potentials_fast(m, x)
            # max-shift is numerics only; no gradient should flow through
            # it (pmax has no differentiation rule anyway)
            mx = jax.lax.stop_gradient(
                jax.lax.pmax(jnp.max(jax.lax.stop_gradient(lp)), amp_axis)
            )
            z_local = jnp.sum(jnp.exp(lp - mx))
            lnZ = mx + jnp.log(jax.lax.psum(z_local, amp_axis))
            # --- data axis: sharded batch moment
            mean_lp = jax.lax.pmean(
                jnp.mean(m.beta * m.log_potential(data_local)), data_axis
            )
            return (lnZ - mean_lp)[None]

        return compute(raw, data)[0]

    @jax.jit
    def step(raw, opt_state, batch):
        loss, g = jax.value_and_grad(sharded_nll)(raw, batch)
        updates, opt_state = optimizer.update(g, opt_state, raw)
        raw = optax.apply_updates(raw, updates)
        return raw, opt_state, loss

    return step


def fit_mle_sharded(
    mrf0: MRF,
    data: jax.Array,
    mesh: Mesh,
    steps: int = 100,
    learning_rate: float = 0.1,
    nonpositive: bool = True,
) -> Tuple[MRF, jax.Array]:
    opt = optax.adam(learning_rate)
    raw = _from_theta(mrf0.theta, nonpositive)
    opt_state = opt.init(raw)
    step = make_sharded_train_step(mrf0, opt, mesh, nonpositive)
    loss = jnp.inf
    for _ in range(steps):
        raw, opt_state, loss = step(raw, opt_state, data)
    return mrf0.with_theta(_to_theta(raw, nonpositive)), loss


# --------------------------------------------------------------------------
# Shot-based training: model moments from circuit samples
# --------------------------------------------------------------------------


def make_shots_train_step(
    template: MRF,
    optimizer: optax.GradientTransformation,
    shots: int,
    data_marg: jax.Array,
    nonpositive: bool = True,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Shot-gradient training step: (raw, opt_state, key) ->
    (raw, opt_state, delta_hat).

    ``grad_theta NLL = beta * (E_model[phi] - E_data[phi])``; the model
    moments are the empirical clique-marginal vector of post-selected
    circuit shots (`evaluation.estimators.clique_marginals_from_samples`),
    an unbiased estimate because accepted samples are exact Gibbs draws.
    Stochastic-gradient noise ~ 1/sqrt(delta * shots), so scale ``shots``
    with ``2**n / Z``.

    With ``mesh`` (any mesh whose device count divides ``shots``;
    multi-axis meshes are flattened by the sharded entry point), the shot
    draw and moment accumulation shard over the devices with one (d,)
    psum per step (parallel.sharded.sharded_shot_moments) — mesh-parallel
    quantum-in-the-loop training.
    """
    import numpy as np

    from qcmrf_tpu.evaluation.estimators import (
        clique_marginals_from_samples)
    from qcmrf_tpu.sim import analytic

    data_marg = jnp.asarray(data_marg, jnp.float32)

    @jax.jit
    def apply(raw, opt_state, model_marg):
        _theta, vjp = jax.vjp(lambda r: _to_theta(r, nonpositive), raw)
        (g_raw,) = vjp(template.beta * (model_marg - data_marg))
        updates, opt_state = optimizer.update(g_raw, opt_state, raw)
        return optax.apply_updates(raw, updates), opt_state

    def step(raw, opt_state, key):
        m = template.with_theta(_to_theta(raw, nonpositive))
        if mesh is not None:
            from qcmrf_tpu.parallel import sharded

            model_marg, delta = sharded.sharded_shot_moments(
                key, m, mesh, shots
            )
            raw, opt_state = apply(raw, opt_state, model_marg)
            return raw, opt_state, delta
        x, acc = analytic.sample_postselected(key, m, shots)
        x, acc = np.asarray(x), np.asarray(acc)
        model_marg = jnp.asarray(
            clique_marginals_from_samples(m, x, acc), jnp.float32)
        raw, opt_state = apply(raw, opt_state, model_marg)
        return raw, opt_state, float(acc.mean())

    return step


def fit_mle_shots(
    mrf0: MRF,
    data: jax.Array,
    key: jax.Array,
    steps: int = 200,
    shots: int = 1 << 14,
    learning_rate: float = 0.05,
    nonpositive: bool = True,
    optimizer: Optional[optax.GradientTransformation] = None,
) -> Tuple[MRF, float]:
    """Quantum-in-the-loop MLE: the model-moment term of the NLL gradient
    comes from post-selected QCMRF circuit shots instead of exact
    inference — the loop a hardware user would run, with no 2^n
    enumeration or elimination anywhere in the gradient path. Returns
    (fitted MRF, final delta-hat)."""
    import numpy as np

    from qcmrf_tpu.evaluation.estimators import (
        clique_marginals_from_samples)

    opt = optimizer or optax.adam(learning_rate)
    raw = _from_theta(mrf0.theta, nonpositive)
    opt_state = opt.init(raw)
    data_marg = clique_marginals_from_samples(mrf0, np.asarray(data))
    step = make_shots_train_step(mrf0, opt, shots, data_marg, nonpositive)
    delta = 0.0
    for _ in range(steps):
        key, sub = jax.random.split(key)
        raw, opt_state, delta = step(raw, opt_state, sub)
    return mrf0.with_theta(_to_theta(raw, nonpositive)), delta


# --------------------------------------------------------------------------
# AIS-moment training: the past-both-caps regime (induced width beyond
# elimination AND n beyond the streaming sweeps) where no exact gradient
# exists — the reference oracle's moments role (/root/reference/
# eval.py:84-93) served stochastically, with ESS-gated step acceptance.
# --------------------------------------------------------------------------


def make_ais_train_step(
    template: MRF,
    optimizer: optax.GradientTransformation,
    data_marg: jax.Array,
    num_chains: int = 256,
    num_temps: int = 64,
    sweeps_per_temp: int = 1,
    ess_min_frac: float = 0.1,
    nonpositive: bool = True,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Stochastic-moment MLE step with NO structural cap:
    ``(raw, opt_state, key) -> (raw, opt_state, info)``.

    ``grad_theta NLL = beta * (E_model[phi] - mu_hat)`` exactly as in
    :func:`make_shots_train_step`, but the model moments come from
    annealed importance sampling (`models.ais.ais_clique_marginals`) —
    the only estimator in the framework that reaches induced width >
    the elimination cap AND n > the streaming cap simultaneously.

    **ESS gate**: a step whose importance weights collapse
    (``ess < ess_min_frac * num_chains``) is *skipped* — the
    self-normalized moment estimate is then dominated by a handful of
    chains and its gradient is closer to noise than signal. ``info``
    carries ``{"ess", "skipped"}``; a caller seeing persistent skips
    should raise ``num_temps`` (more anneal rungs), the standard AIS
    remedy under strong coupling.

    With ``mesh`` the chains shard over the devices (pure data
    parallelism; ``num_chains`` is rounded up to a device multiple).
    """
    from qcmrf_tpu.models import ais as mais

    if mesh is not None:
        from qcmrf_tpu.parallel.sharded import _sweep_mesh

        d = _sweep_mesh(mesh).devices.size
        num_chains = -(-int(num_chains) // d) * d
    data_marg = jnp.asarray(data_marg, jnp.float32)
    ess_min = float(ess_min_frac) * float(num_chains)

    @jax.jit
    def apply(raw, opt_state, model_marg):
        _theta, vjp = jax.vjp(lambda r: _to_theta(r, nonpositive), raw)
        (g_raw,) = vjp(template.beta * (model_marg - data_marg))
        updates, opt_state = optimizer.update(g_raw, opt_state, raw)
        return optax.apply_updates(raw, updates), opt_state

    def step(raw, opt_state, key):
        m = template.with_theta(_to_theta(raw, nonpositive))
        model_marg, diag = mais.ais_clique_marginals(
            key, m, num_chains=num_chains, num_temps=num_temps,
            sweeps_per_temp=sweeps_per_temp, return_diagnostics=True,
            mesh=mesh)
        ess = float(diag["ess"])
        if ess < ess_min:
            return raw, opt_state, {"ess": ess, "skipped": True}
        raw, opt_state = apply(
            raw, opt_state, jnp.asarray(model_marg, jnp.float32))
        return raw, opt_state, {"ess": ess, "skipped": False}

    return step


# --------------------------------------------------------------------------
# Moment-target training on bit-array data: exact MLE past the int32
# state-id ceiling (n > 30), powered by differentiable elimination.
# --------------------------------------------------------------------------


def empirical_moments_from_bits(template: MRF, bits) -> jax.Array:
    """Empirical ``E_data[phi]`` (d,) from per-variable bit arrays (S, n).

    The sufficient statistics of the data are all the NLL ever needs
    (``mean log-lik = beta * theta^T mu_hat - lnZ``), so data at any ``n``
    reduces to one (d,) vector — no state ids, no 2^n anywhere. Bit
    conventions match the theta layout (clique-major, y binary counting,
    first clique variable slowest; CLAUDE.md conventions)."""
    import numpy as np

    bits = np.asarray(bits)
    if bits.ndim != 2 or bits.shape[1] != template.n:
        raise ValueError(
            f"bits must be (samples, n={template.n}), got {bits.shape}"
        )
    if not np.isin(bits, (0, 1)).all():
        raise ValueError("bits must be 0/1 arrays")
    S = bits.shape[0]
    mu = np.zeros(template.dimension)
    for k, C in enumerate(template.cliques):
        m = len(C)
        y = np.zeros(S, dtype=np.int64)
        for i, v in enumerate(C):
            y |= bits[:, v].astype(np.int64) << (m - 1 - i)
        np.add.at(mu, template.theta_offsets[k] + y, 1.0)
    return jnp.asarray(mu / max(S, 1), jnp.float32)


def make_lnz_fn(template: MRF, mesh: Optional[Mesh] = None,
                enumerate_max_n: int = 22) -> Callable:
    """``lnZ(theta) -> scalar`` routed by structure, differentiable on
    every branch — the one lnZ router shared by moment training and
    structure learning (verdict item 4: the selection NLL must reach
    wherever training's does).

    Routing: enumeration below ``2^enumerate_max_n`` states (fast,
    well-fused XLA logsumexp), differentiable variable elimination for
    bounded induced width at any n, else the streaming custom-VJP sweep
    (arbitrary structure, n <= the streaming cap) — which optionally
    SHARDS over ``mesh`` (ignored on the other branches, whose reach a
    2^n sweep cannot match). Raises ``ValueError`` past both exact
    backends (the AIS route has no deterministic lnZ to offer here).
    """
    from qcmrf_tpu.models import elimination

    beta_c = float(template.beta)
    if template.n <= enumerate_max_n:
        def lnZ_fn(theta):
            return template.with_theta(theta).log_partition()
    elif (elimination.induced_width(template.cliques, template.n)
          <= _ELIM_WIDTH_CAP):
        elim = elimination._build_lnZ(template.cliques, template.n)

        def lnZ_fn(theta):
            return elim(theta, template.beta)
    else:
        from qcmrf_tpu.models import moments

        if template.n > moments._MAX_N:
            raise ValueError(
                f"no exact lnZ: induced width > {_ELIM_WIDTH_CAP} and "
                f"n={template.n} > streaming cap {moments._MAX_N}")

        def lnZ_fn(theta):
            if mesh is None:
                return moments._lnZ_streaming(
                    template.cliques, template.n, beta_c, theta)
            return moments._lnZ_streaming_sharded(
                template.cliques, template.n, beta_c, mesh, theta)

    return lnZ_fn


def make_moment_train_step(
    template: MRF,
    optimizer: optax.GradientTransformation,
    mu_hat: jax.Array,
    nonpositive: bool = True,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Jitted exact-MLE step on the sufficient statistics:
    ``loss(theta) = lnZ(theta) - beta * theta^T mu_hat`` (the exact mean
    NLL of the data). lnZ comes from variable elimination (bounded
    treewidth at any ``n`` — the CLI uses it past the int32-state-id
    ceiling) or, past the induced-width cap, from the streaming
    custom-VJP sweep (arbitrary structure, block-unit state coordinates;
    models/moments.py) — that sweep optionally SHARDS over ``mesh``
    (devices split the block range, one psum per moment vector; ``mesh``
    is ignored on the elimination branch, whose any-n reach a 2^n sweep
    cannot match). Signature matches make_train_step's
    (raw, opt_state, batch) -> (raw, opt_state, loss); ``batch`` is
    ignored (the moments are baked in)."""
    mu_hat = jnp.asarray(mu_hat, jnp.float32)
    # enumerate_max_n=-1: route by width/streaming only (this step
    # exists for the past-int32 big-n regime; enumeration never applies)
    lnZ_fn = make_lnz_fn(template, mesh=mesh, enumerate_max_n=-1)

    @jax.jit
    def step(raw, opt_state, batch=None):
        def loss_fn(r):
            theta = _to_theta(r, nonpositive)
            return (lnZ_fn(theta)
                    - template.beta * jnp.vdot(theta, mu_hat))

        loss, g = jax.value_and_grad(loss_fn)(raw)
        updates, opt_state = optimizer.update(g, opt_state, raw)
        raw = optax.apply_updates(raw, updates)
        return raw, opt_state, loss

    return step
