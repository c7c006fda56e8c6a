"""Sharded statevector simulation and exact inference over a device mesh.

The distributed layer — a *new* first-class component with no reference
counterpart (the reference caps at 10 qubits and has no mechanism to scale,
SURVEY.md §2.2/§5): statevectors and state tables beyond one device's memory
are sharded over a 1-D device mesh on the **leading state bits** (the top
``log2 D`` qubits), via ``jax.shard_map``.

Design (the scaling-book recipe, specialized to amplitude sharding):

* gates on *local* qubits are embarrassingly parallel — identical local
  contractions per shard, zero communication;
* *diagonal* gates (rz / cp / flags_phase — everything after the QCMRF
  Hadamard wall) never need communication even on sharded qubits: the
  sharded bits' values are a function of ``jax.lax.axis_index``, so each
  device computes its own phase mask locally;
* non-diagonal gates on sharded qubits trigger a **targeted qubit
  exchange**: one ``lax.ppermute`` swaps the needed device bit with one
  local bit (the analog of a Ulysses-style head/sequence swap, but moving
  only half of each shard instead of (D-1)/D of it), after which the gate
  is local. The evicted local qubit is chosen by Belady's rule (furthest
  next use); the logical->physical permutation is tracked statically in
  Python, so each remap compiles to exactly one collective, and any final
  layout restores via a short exchange sequence + one local bit transpose;
* scalar results (norms, partition functions) reduce with ``psum``;
* shard-local work between exchanges runs the single-device engine's
  fused plane passes (X-deferral, diagonal profiles, H·D·H sandwiches,
  adjacent-pair composition) once the per-device chunk is >= 2**10
  amplitudes — device-bit diagonal conditions fold into per-device
  symbolic angles, so fusion costs no extra communication.

Complex amplitudes are real/imag float32 planes, matching
:mod:`qcmrf_tpu.ops.kernels`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from qcmrf_tpu.circuits.ir import Circuit
from qcmrf_tpu.models.mrf import MRF
from qcmrf_tpu.ops import kernels as K
from qcmrf_tpu.sim.dense import GATES_1Q

AXIS = "amp"


def make_mesh(num_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        if len(devs) < num_devices:
            raise ValueError(
                f"requested a {num_devices}-device mesh but only "
                f"{len(devs)} device(s) are visible — a silently smaller "
                "mesh would misreport every sharded result"
            )
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (axis,))


# --------------------------------------------------------------------------
# Sharded exact inference (the kiopto replacement at n = 24-28)
# --------------------------------------------------------------------------


def _dlog(mesh: Mesh) -> int:
    """log2 of the mesh size; rejects non-power-of-two meshes (a silent
    wrong-coverage bug otherwise: each device owns a 2^(n-dlog) slice)."""
    D = mesh.devices.size
    dlog = int(math.log2(D))
    if (1 << dlog) != D:
        raise ValueError(
            f"sharded inference needs a power-of-two mesh, got {D} devices"
        )
    return dlog


def mesh_fits(mesh: Mesh, n: int) -> bool:
    """Whether an ``n``-variable state-space sweep can shard over this
    mesh: each device owns a ``2^(n - log2(D))`` slice, so ``n`` below
    ``log2(D)`` leaves some devices with no slice (and a negative shift
    count in the slice arithmetic). Callers drop the mesh and run the
    single-device backend — identical result — when this is False;
    evidence-reduced models routinely shrink below mesh size (round-4
    review finding)."""
    return n >= _dlog(mesh)


def fit_mesh(mesh, n: int):
    """``mesh`` if an ``n``-variable sweep can shard over it, else
    ``None`` — the one-line form of the drop-the-mesh fallback every
    conditional entry point needs (evidence-reduced models routinely
    shrink below mesh size; round-4 review found four hand-copied
    variants of this guard drifting apart). Accepts ``None``."""
    return mesh if mesh is not None and mesh_fits(mesh, n) else None


@functools.lru_cache(maxsize=32)
def _sweep_mesh(mesh: Mesh) -> Mesh:
    """1-D view of ``mesh`` for the sweep / statevector / shot paths,
    which all shard over a SINGLE named axis. A multi-axis mesh (e.g.
    the train CLI's 2-D (amp, data)) must be flattened first: passed
    through directly, every slice is sized by the TOTAL device count
    while offsets/seeds/psums use only ``axis_names[0]``'s index — a
    silently wrong result (a fraction of the state space swept, or
    duplicated sample streams), not an error (round-4 review finding)."""
    if len(mesh.axis_names) == 1:
        return mesh
    return Mesh(mesh.devices.reshape(-1), ("sweep",))


def _use_slice_kernel(n: int, dlog: int) -> bool:
    """Whether the per-device-slice sweeps apply (static: local width at
    or over the sweep floor). ALL sharded sweep paths (table, streaming
    lnZ, streaming MAP) must take this one gate so they stay in
    lockstep."""
    return n - dlog >= K._MIN_KERNEL_N


def _kernel_slice_args(mrf: MRF, dlog: int, axis: str):
    """Shared gate + argument prep for the per-device-slice sweeps (see
    :func:`_use_slice_kernel`).

    Returns ``(chunk, coef, beta32, x0)``; ``coef``/``beta32`` are None
    when the kernel path does not apply, but the slice offset ``x0`` is
    always computed here so no caller re-derives it."""
    chunk = 1 << (mrf.n - dlog)
    d = jax.lax.axis_index(axis)
    if chunk < (1 << 31):
        x0 = jnp.reshape((d * chunk).astype(jnp.int32), (1,))
    else:
        # state-unit offsets overflow int32 at this scale; the only
        # consumer that runs here (streaming lnZ) derives its own
        # BLOCK-unit offset instead (kernels.lse_block_states)
        x0 = jnp.zeros((1,), jnp.int32)
    if not _use_slice_kernel(mrf.n, dlog):
        return chunk, None, None, x0
    coef = K._moebius_coefficients(mrf)
    beta32 = jnp.reshape(jnp.asarray(mrf.beta, jnp.float32), (1,))
    return chunk, coef, beta32, x0


def _local_log_potentials(mrf: MRF, dlog: int, axis: str) -> jax.Array:
    """This device's contiguous slice of the beta*logpot table."""
    chunk, coef, beta, x0 = _kernel_slice_args(mrf, dlog, axis)
    if chunk >= (1 << 31):
        # the zeroed x0 above would make every device compute the SAME
        # slice — a silently wrong table. Only the streaming-lnZ path
        # (block-unit offsets, no local table) runs at this scale.
        raise ValueError(
            f"per-device table slices of 2^{mrf.n - dlog} states need "
            "state-unit offsets, which overflow int32; use "
            "sharded_log_partition (streaming, block-unit offsets) or a "
            "larger mesh"
        )
    if coef is not None:
        return K._logpot_call_sized(
            mrf.cliques, mrf.n, False, chunk, coef, beta, x0
        )
    from qcmrf_tpu.sim.analytic import log_potentials_fast

    if mrf.n - dlog > 18:
        # large chunk off the sweep path: gather-free evaluation,
        # sub-chunked with lax.map to bound intermediates
        sub = 1 << 16
        starts = x0[0] + jnp.arange(chunk // sub, dtype=jnp.int32) * sub

        def one(s):
            return log_potentials_fast(
                mrf, s + jnp.arange(sub, dtype=jnp.int32)
            )

        return jax.lax.map(one, starts).reshape(-1)
    x = x0[0] + jnp.arange(chunk, dtype=jnp.int32)
    return log_potentials_fast(mrf, x)


@functools.lru_cache(maxsize=128)
def _build_lnZ_fn(cliques: tuple, n: int, mesh: Mesh):
    """Compiled sharded lnZ, cached per (structure, mesh): theta/beta are
    runtime arguments so repeated calls hit one executable (a fresh
    shard_map closure per call would re-trace every time)."""
    dlog = _dlog(mesh)
    axis = mesh.axis_names[0]
    template = MRF.create([list(C) for C in cliques])

    @jax.jit
    # check_vma=False: the sweep's loop carries start replicated and
    # become device-varying through the slice offset
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
        check_vma=False,
    )
    def compute(theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=template.cliques, n=n)
        chunk, coef, beta32, x0 = _kernel_slice_args(mrf, dlog, axis)
        if coef is not None:
            # streaming per-lane (max, scaled-sum) partials: no local
            # 2^(n-dlog) table materializes on any device, so the sharded
            # ceiling is compute-bound, not memory-bound. The slice
            # offset is passed in BLOCK units (device * blocks-per-chunk,
            # int32-safe past n=31; kernels.lse_block_states).
            x0b = (jax.lax.axis_index(axis).astype(jnp.int32)
                   * (chunk // K.lse_block_states(template.cliques, n,
                                                  chunk)))[None]
            ml, sl = K._lse_partials_call(template.cliques, n, chunk,
                                          coef, beta32, x0b)
            m = jax.lax.pmax(jnp.max(ml), axis)
            local = jnp.sum(sl * jnp.exp(ml - m))
        else:
            lp = _local_log_potentials(mrf, dlog, axis)
            m = jax.lax.pmax(jnp.max(lp), axis)
            local = jnp.sum(jnp.exp(lp - m))
        return (m + jnp.log(jax.lax.psum(local, axis)))[None]

    return compute


def sharded_log_partition(mrf: MRF, mesh: Mesh) -> jax.Array:
    """``ln Z`` with the 2**n state table sharded over the mesh."""
    mesh = _sweep_mesh(mesh)
    fn = _build_lnZ_fn(mrf.cliques, mrf.n, mesh)
    return fn(mrf.theta, mrf.beta)[0]


@functools.lru_cache(maxsize=128)
def _build_gibbs_fn(cliques: tuple, n: int, mesh: Mesh):
    dlog = _dlog(mesh)
    axis = mesh.axis_names[0]
    template = MRF.create([list(C) for C in cliques])

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P()), out_specs=P(axis),
        check_vma=False,
    )
    def compute(theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=template.cliques, n=n)
        lp = _local_log_potentials(mrf, dlog, axis)
        m = jax.lax.pmax(jnp.max(lp), axis)
        z = jax.lax.psum(jnp.sum(jnp.exp(lp - m)), axis)
        return jnp.exp(lp - m) / z

    return compute


def sharded_gibbs_probs(mrf: MRF, mesh: Mesh) -> jax.Array:
    """Exact Gibbs distribution, returned sharded over the mesh."""
    mesh = _sweep_mesh(mesh)
    fn = _build_gibbs_fn(mrf.cliques, mrf.n, mesh)
    return fn(mrf.theta, mrf.beta)


def sharded_success_rate(mrf: MRF, mesh: Mesh) -> jax.Array:
    """Z / 2**n without materializing anything unsharded."""
    lnZ = sharded_log_partition(mrf, mesh)
    return jnp.exp(lnZ - mrf.n * jnp.log(2.0))


@functools.lru_cache(maxsize=128)
def _build_moments_fn(cliques: tuple, n: int, mesh: Mesh):
    """Compiled sharded streaming-moments sweep: each device scans its
    contiguous block range of the 2**n state space in (block, offset)
    coordinates (models/moments.py::_chunk_mono_partials — no flat state
    id, int32-safe past n=31), one psum reduces the (m,) deduplicated
    MONOMIAL partials (m < d, so less traffic than theta-layout partials
    would cost), and the theta-layout transform runs replicated once."""
    from qcmrf_tpu.models import moments as M

    dlog = _dlog(mesh)
    axis = mesh.axis_names[0]
    template = MRF.create([list(C) for C in cliques])
    chunk = 1 << (n - dlog)  # states per device
    layout = M._monomial_layout(template.cliques)
    cb = min(M._CHUNK_BITS if n <= 31 else M._CHUNK_BITS_BIG, n - dlog)
    nblk = 1 << (n - dlog - cb)  # XLA-path blocks per device

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
        check_vma=False,
    )
    def compute(theta, beta, lnZ):
        mrf = MRF(theta=theta, beta=beta, cliques=template.cliques, n=n)
        d = jax.lax.axis_index(axis)
        coef_mono = M._coef_mono(M._beta_coef(mrf), layout)
        offset = jnp.arange(1 << cb, dtype=jnp.int32)
        base = d.astype(jnp.int32) * nblk
        # the device's first block doubles as the scan init (pytree)
        acc = M._chunk_mono_partials(
            mrf, coef_mono, lnZ[0], base, offset, cb)
        if nblk > 1:
            # fori_loop, not scan-over-arange: near the n<=47 cap the
            # block-index xs array alone would be hundreds of MB
            def step(i, acc):
                new = M._chunk_mono_partials(
                    mrf, coef_mono, lnZ[0], base + i, offset, cb)
                return jax.tree.map(jnp.add, acc, new)

            acc = jax.lax.fori_loop(1, nblk, step, acc)
        mono = jax.lax.psum(
            M._assemble_mono(acc, template.cliques), axis)
        return M._masks_from_monomials(mono, template.cliques)

    return compute


def sharded_clique_moments(mrf: MRF, mesh: Mesh, lnZ=None) -> jax.Array:
    """Exact model moments ``E_p[phi]`` with the streaming state sweep
    SHARDED over the mesh — the multi-device form of
    :func:`qcmrf_tpu.models.moments.clique_moments_streaming` (arbitrary
    clique structure, no 2^n array on any device, block-unit coordinates
    past the int32 state-id limit). ``lnZ`` may be passed to skip the
    sharded lnZ sweep."""
    mesh = _sweep_mesh(mesh)
    if mrf.n > moments_cap():
        raise ValueError(
            f"streaming moments cap at n={moments_cap()} (int32 block "
            f"ids); got n={mrf.n}"
        )
    if lnZ is None:
        lnZ = sharded_log_partition(mrf, mesh)
    fn = _build_moments_fn(mrf.cliques, mrf.n, mesh)
    return fn(mrf.theta, mrf.beta,
              jnp.asarray(lnZ, jnp.float32).reshape(1))


def moments_cap() -> int:
    from qcmrf_tpu.models import moments as M

    return M._MAX_N


def sharded_lnz_and_moments(mrf: MRF, mesh: Mesh):
    """``(lnZ, E_p[phi])`` sharded over the mesh — the multi-device form
    of :func:`qcmrf_tpu.models.moments.lnz_and_moments_streaming`: the
    sharded lnZ sweep, then the sharded moment sweep it normalizes."""
    mesh = _sweep_mesh(mesh)
    if mrf.n > moments_cap():
        raise ValueError(
            f"streaming moments cap at n={moments_cap()} (int32 block "
            f"ids); got n={mrf.n}"
        )
    lnZ = sharded_log_partition(mrf, mesh)
    return lnZ, sharded_clique_moments(mrf, mesh, lnZ)


def _map_slice_parts(cliques: tuple, n: int, mesh: Mesh):
    """(per-device MAP-partials fn, host id reconstructor) shared by the
    sharded MAP and PAM paths — the block-unit id contract is pinned
    HERE, once, for both (a MAP-only block-size tweak that updated one
    caller but not the other would silently decode wrong states).

    The partials fn maps (mrf, device_index) to a (value, block, row,
    lane) f32 row for that device's slice; coordinates stay split
    because a flat id can exceed int32/f32-exact range past n=31 — same
    convention as the single-device kernels.map_state_streaming. ``blk``
    is the ABSOLUTE sweep-tile index on the sweep path (the sweep
    carries x0_blocks + i) and the DEVICE coordinate on the table
    fallback (valid for any chunk size, including shards smaller than
    one 128-lane row)."""
    dlog = _dlog(mesh)
    axis = mesh.axis_names[0]
    chunk = 1 << (n - dlog)
    use_kernel = _use_slice_kernel(n, dlog)
    if use_kernel:
        block_rows = K.map_block_states(cliques, n, chunk) // 128

        def reconstruct(blk: int, row: int, lane: int) -> int:
            return (blk * block_rows + row) * 128 + lane
    else:
        def reconstruct(blk: int, row: int, lane: int) -> int:
            return blk * chunk + row * 128 + lane

    def device_partials(mrf: MRF, d):
        if use_kernel:
            coef = K._moebius_coefficients(mrf)
            beta32 = jnp.reshape(jnp.asarray(mrf.beta, jnp.float32),
                                 (1,))
            x0b = (d.astype(jnp.int32)
                   * (chunk // (block_rows * 128)))[None]
            out = K._map_partials_call(cliques, n, chunk, coef,
                                       beta32, x0b)
            lane = jnp.argmax(out[0])
            val, blk, row = out[0, lane], out[1, lane], out[2, lane]
        else:
            lp = _local_log_potentials(mrf, dlog, axis)
            i = jnp.argmax(lp)
            val = lp[i]
            blk = d.astype(jnp.float32)
            row = (i // 128).astype(jnp.float32)
            lane = i % 128
        return jnp.stack([val, blk, row, lane.astype(jnp.float32)])

    return device_partials, reconstruct


@functools.lru_cache(maxsize=128)
def _build_map_fn(cliques: tuple, n: int, mesh: Mesh):
    """Compiled sharded streaming-MAP partials, plus the host-side id
    reconstructor (both from :func:`_map_slice_parts`)."""
    axis = mesh.axis_names[0]
    template = MRF.create([list(C) for C in cliques])
    device_partials, reconstruct = _map_slice_parts(cliques, n, mesh)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P()), out_specs=P(axis),
        check_vma=False,
    )
    def compute(theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=template.cliques, n=n)
        return device_partials(mrf, jax.lax.axis_index(axis))[None]

    return compute, reconstruct


def sharded_map_state(mrf: MRF, mesh: Mesh):
    """Exact MAP state by streaming argmax SHARDED over the mesh: each
    device sweeps its contiguous slice of the 2**n state space with the
    block-split argmax sweep (kernels._map_partials_call) and the
    host combines D per-device (value, block, row, lane) partials.
    Arbitrary clique structure at any width the sharded sweep covers
    (block-unit bases keep the sweep int32-safe past n=31). Returns
    ``(state_id, beta*logpot)`` with a host-int id, exactly like the
    single-device :func:`qcmrf_tpu.ops.kernels.map_state_streaming`.
    Cross-device value ties resolve to the lowest device (measure-zero
    for generic theta)."""
    mesh = _sweep_mesh(mesh)
    fn, reconstruct = _build_map_fn(mrf.cliques, mrf.n, mesh)
    out = np.asarray(fn(mrf.theta, mrf.beta))  # (D, 4)
    j = int(np.argmax(out[:, 0]))
    val, blk, row, lane = out[j]
    return reconstruct(int(blk), int(row), int(lane)), float(val)


@functools.lru_cache(maxsize=128)
def _build_pam_fn(cliques: tuple, n: int, mesh: Mesh):
    """Compiled sharded perturb-and-MAP partials: a ``lax.scan`` over
    sample keys of the per-device streaming-MAP sweep, each iteration on
    a freshly Gumbel-perturbed model. Keys arrive replicated, so every
    device perturbs IDENTICALLY and sweeps its own slice of the same
    perturbed model; the host combines (value, block, row, lane) rows
    per sample. Partials body and id-reconstruction contract shared with
    the sharded MAP through :func:`_map_slice_parts`."""
    axis = mesh.axis_names[0]
    template = MRF.create([list(C) for C in cliques])
    device_partials, reconstruct = _map_slice_parts(cliques, n, mesh)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=P(axis), check_vma=False,
    )
    def compute(theta, beta, keys):
        d = jax.lax.axis_index(axis)

        def step(_, k):
            g = jax.random.gumbel(
                k, (template.dimension,), jnp.float32)
            pm = MRF(theta=beta * theta + g, beta=1.0,
                     cliques=template.cliques, n=n)
            return 0, device_partials(pm, d)

        rows = jax.lax.scan(step, 0, keys)[1]  # (num, 4)
        return rows[None]

    return compute, reconstruct


def sharded_sample_pam(key: jax.Array, mrf: MRF, mesh: Mesh,
                       num_samples: int) -> jax.Array:
    """Low-order perturb-and-MAP samples as bit arrays (num, n) with the
    per-sample MAP sweep SHARDED over the mesh — the multi-device form of
    :func:`qcmrf_tpu.models.sample.sample_pam_streaming` (arbitrary
    clique structure, no 2^n array on any device; same perturbation
    semantics, so with the same key it returns the single-device sampler's
    exact samples)."""
    mesh = _sweep_mesh(mesh)
    fn, reconstruct = _build_pam_fn(mrf.cliques, mrf.n, mesh)
    rows = np.asarray(fn(
        mrf.theta, jnp.asarray(mrf.beta, jnp.float32),
        jax.random.split(key, num_samples)))  # (D, num, 4)
    n = mrf.n
    bits = np.zeros((num_samples, n), np.int32)
    for i in range(num_samples):
        j = int(np.argmax(rows[:, i, 0]))
        _, blk, row, lane = rows[j, i]
        state = reconstruct(int(blk), int(row), int(lane))
        bits[i] = (state >> (n - 1 - np.arange(n))) & 1
    return jnp.asarray(bits)


@functools.lru_cache(maxsize=128)
def _build_sample_fn(cliques: tuple, n: int, mesh: Mesh, per_dev: int):
    from qcmrf_tpu.sim import analytic

    _dlog(mesh)  # validate mesh size
    axis = mesh.axis_names[0]
    template = MRF.create([list(C) for C in cliques])

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(axis), P(axis)), check_vma=False,
    )
    def draw(seed, theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=template.cliques, n=n)
        d = jax.lax.axis_index(axis)
        key = jax.random.fold_in(jax.random.PRNGKey(seed[0]), d)
        return analytic.sample_postselected(key, mrf, per_dev)

    return draw


@functools.lru_cache(maxsize=128)
def _build_estimate_fn(cliques: tuple, n: int, mesh: Mesh, per_dev: int,
                       iters: int):
    from qcmrf_tpu.sim import analytic

    _dlog(mesh)  # validate mesh size
    axis = mesh.axis_names[0]
    D = mesh.devices.size
    template = MRF.create([list(C) for C in cliques])

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=P(), check_vma=False,
    )
    def est(seed, theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=template.cliques, n=n)
        d = jax.lax.axis_index(axis)

        def step(carry, i):
            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(seed[0]), d), i
            )
            # the accept count is a sum fused into the sampler: neither
            # the draws nor the flags need to be written out
            _x, acc = analytic.sample_postselected(key, mrf, per_dev)
            return carry, jnp.sum(acc.astype(jnp.float32))

        _, sums = jax.lax.scan(
            step, jnp.int32(0), jnp.arange(iters, dtype=jnp.int32)
        )
        return jax.lax.psum(sums, axis) / (per_dev * D)

    return est


def sharded_estimate_delta(
    key: jax.Array, mrf: MRF, mesh: Mesh, shots: int, iters: int
) -> jax.Array:
    """``iters`` independent delta-hat estimates of ``shots`` draws each,
    fused into ONE jitted dispatch (a lax.scan over the per-device
    sampler). The unfused loop (sharded_sample_postselected per round)
    pays several host round-trips per iteration; this path's host cost
    is one dispatch regardless of ``iters``. Returns the (iters,)
    acceptance rates, E = Z / 2**n.
    """
    mesh = _sweep_mesh(mesh)
    D = mesh.devices.size
    if shots % D:
        raise ValueError(
            f"shots ({shots}) must be divisible by the mesh size ({D})"
        )
    fn = _build_estimate_fn(mrf.cliques, mrf.n, mesh, shots // D, iters)
    seed = jax.random.randint(key, (1,), 0, 2**31 - 1, dtype=jnp.int32)
    return fn(seed, mrf.theta, mrf.beta)


@functools.lru_cache(maxsize=128)
def _build_shot_moments_fn(cliques: tuple, n: int, mesh: Mesh,
                           per_dev: int):
    from qcmrf_tpu.sim import analytic

    axis = mesh.axis_names[0]
    D = mesh.devices.size
    template = MRF.create([list(C) for C in cliques])

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(), P()), check_vma=False,
    )
    def moments(seed, theta, beta):
        mrf = MRF(theta=theta, beta=beta, cliques=template.cliques, n=n)
        d = jax.lax.axis_index(axis)
        key = jax.random.fold_in(jax.random.PRNGKey(seed[0]), d)
        x, acc = analytic.sample_postselected(key, mrf, per_dev)
        accf = acc.astype(jnp.float32)
        # accepted-weighted scatter of the active clique states: the
        # empirical E_model[phi] partial of this device's shots
        idx = mrf.suff_stat_flat_indices(x)  # (per_dev, K)
        marg = jnp.zeros((template.dimension,), jnp.float32)
        marg = marg.at[idx].add(accf[:, None])
        marg = jax.lax.psum(marg, axis)
        cnt = jax.lax.psum(jnp.sum(accf), axis)
        return marg / jnp.maximum(cnt, 1.0), (cnt / (per_dev * D))[None]

    return moments


def sharded_shot_moments(
    key: jax.Array, mrf: MRF, mesh: Mesh, shots: int
) -> Tuple[jax.Array, float]:
    """Clique-marginal estimate ``E_model[phi]`` from post-selected
    circuit shots sharded over the mesh (pure shot parallelism — any mesh
    size dividing ``shots``). Each device draws its slice with the fused
    sampler, scatter-adds its accepted sufficient statistics locally, and one
    psum combines the (d,)-sized partials — shots never leave their
    device. Returns ``(marginals, delta_hat)``; powers mesh-parallel
    quantum-in-the-loop training (models.train.make_shots_train_step)."""
    mesh = _sweep_mesh(mesh)
    D = mesh.devices.size
    if shots % D:
        raise ValueError(
            f"shots ({shots}) must be divisible by the mesh size ({D})"
        )
    fn = _build_shot_moments_fn(mrf.cliques, mrf.n, mesh, shots // D)
    seed = jax.random.randint(key, (1,), 0, 2**31 - 1, dtype=jnp.int32)
    marg, delta = fn(seed, mrf.theta, mrf.beta)
    return marg, float(delta[0])


def sharded_sample_postselected(
    key: jax.Array, mrf: MRF, mesh: Mesh, shots: int
) -> Tuple[jax.Array, jax.Array]:
    """Data-parallel shot sampling over the mesh (shots axis sharded).

    Returns (x, accepted) exactly like analytic.sample_postselected but with
    each device drawing its own shots slice — no cross-device traffic at
    all (the factorized sampler needs none).
    """
    mesh = _sweep_mesh(mesh)
    D = mesh.devices.size
    if shots % D:
        raise ValueError(
            f"shots ({shots}) must be divisible by the mesh size ({D}); "
            "a silent floor would bias delta-hat estimates"
        )
    fn = _build_sample_fn(mrf.cliques, mrf.n, mesh, shots // D)
    seed = jax.random.randint(key, (1,), 0, 2**31 - 1, dtype=jnp.int32)
    return fn(seed, mrf.theta, mrf.beta)


# --------------------------------------------------------------------------
# Sharded gate-level statevector engine
# --------------------------------------------------------------------------


def _apply_1q_local(re, im, U: np.ndarray, pos: int, local_n: int):
    """2x2 unitary on local bit ``pos`` of flat real/imag planes."""
    U = np.asarray(U, dtype=np.complex64)
    hi = 1 << (local_n - 1 - pos)
    lo = 1 << pos
    r = re.reshape(hi, 2, lo)
    i_ = im.reshape(hi, 2, lo)
    ur = jnp.asarray(U.real.astype(np.float32))
    ui = jnp.asarray(U.imag.astype(np.float32))
    # HIGHEST: a reduced-precision f32 contraction (bf16 / TF32 passes)
    # drifts the statevector norm by ~1e-3 over a gate sequence
    em = functools.partial(
        jnp.einsum, precision=jax.lax.Precision.HIGHEST
    )
    nr = em("ab,hbl->hal", ur, r) - em("ab,hbl->hal", ui, i_)
    ni = em("ab,hbl->hal", ur, i_) + em("ab,hbl->hal", ui, r)
    return nr.reshape(-1), ni.reshape(-1)


def _flip_local(re, im, pos: int, local_n: int):
    hi = 1 << (local_n - 1 - pos)
    lo = 1 << pos
    r = re.reshape(hi, 2, lo)[:, ::-1].reshape(-1)
    i_ = im.reshape(hi, 2, lo)[:, ::-1].reshape(-1)
    return r, i_


class _Layout:
    """Tracks logical qubit -> physical bit position. Positions
    [0, local_n) are local bits; [local_n, n) are device bits."""

    def __init__(self, n: int, local_n: int):
        self.n = n
        self.local_n = local_n
        self.pos = list(range(n))  # logical -> physical
        self.remaps = 0  # collectives issued (trace-time count)

    def is_local(self, q: int) -> bool:
        return self.pos[q] < self.local_n

    def at_physical(self, p: int) -> int:
        return self.pos.index(p)

    def exchange(self, dev_j: int, loc_p: int):
        """Record a device-bit ``dev_j`` <-> local-bit ``loc_p`` swap."""
        a = self.pos.index(self.local_n + dev_j)
        b = self.pos.index(loc_p)
        self.pos[a], self.pos[b] = loc_p, self.local_n + dev_j
        self.remaps += 1


def _exchange_device_local(re, im, axis: str, D: int, dev_j: int,
                           loc_p: int, local_n: int):
    """Swap device bit ``dev_j`` with local bit position ``loc_p``.

    The targeted analog of a Ulysses head/sequence swap: ONE ``ppermute``
    with the device differing in bit ``dev_j``, moving exactly half of
    each shard — vs. (D-1)/D of it for a full qubit-block ``all_to_all``
    — and leaving every other qubit's position untouched, so arbitrary
    gate orders don't thrash whole-block toggles.
    """
    perm = [(s, s ^ (1 << dev_j)) for s in range(D)]
    bj = _device_bit(axis, dev_j)  # this device's value of bit j (traced)
    lo = 1 << loc_p
    hi = 1 << (local_n - 1 - loc_p)
    r3 = re.reshape(hi, 2, lo)
    i3 = im.reshape(hi, 2, lo)
    # each device keeps the half where local bit == its own device bit and
    # trades the other half with its bit-j partner
    send = jnp.where(bj == 0,
                     jnp.stack([r3[:, 1, :], i3[:, 1, :]]),
                     jnp.stack([r3[:, 0, :], i3[:, 0, :]]))
    recv = jax.lax.ppermute(send, axis, perm)
    new0 = jnp.where(bj == 0, jnp.stack([r3[:, 0, :], i3[:, 0, :]]), recv)
    new1 = jnp.where(bj == 0, recv, jnp.stack([r3[:, 1, :], i3[:, 1, :]]))
    re = jnp.stack([new0[0], new1[0]], axis=1).reshape(-1)
    im = jnp.stack([new0[1], new1[1]], axis=1).reshape(-1)
    return re, im


def _locality_needs(gates) -> list:
    """Per-gate tuple of qubits that must live on local bits: targets of
    non-diagonal gates. Diagonal gates (rz/cp/flags_phase) and cx controls
    read bit values, which works on device bits without communication."""
    out = []
    for g in gates:
        if g.name == "cx":
            out.append((g.qubits[1],))
        elif g.name in GATES_1Q and g.name != "id":
            out.append((g.qubits[0],))
        else:
            out.append(())
    return out


def _device_bit(axis: str, dev_pos: int) -> jax.Array:
    """Value of device bit ``dev_pos`` (0 = lowest device bit)."""
    return (jax.lax.axis_index(axis) >> dev_pos) & 1


def _local_bits(x_local: jax.Array, pos: int) -> jax.Array:
    return (x_local >> pos) & 1


#: collectives issued by the most recent run_statevector_sharded call
#: (trace-time count; read by tests/benchmarks)
LAST_REMAP_COUNT = 0
_SV_EXEC_CACHE: dict = {}

#: minimum per-device qubit count for the FUSED shard-local path: the
#: plane passes need whole 128-lane rows (local_n >= 7); below this the
#: gate-by-gate path is cheaper anyway (test-scale circuits)
_FUSED_MIN_LOCAL = 10


class _SymAngle:
    """Trace-time symbolic angle: ``sum_k coef_k * [devconds_k hold]``.

    Folds diagonal conditions on DEVICE bits into fused-pass angles with
    zero communication: the fusion machinery (sim.tpu.fuse_primitives /
    _try_sandwich) only needs +, unary -, / and abs — all stay symbolic —
    and the executor evaluates per device from ``jax.lax.axis_index``
    masks (each device's bits are constants of its shard), so one compiled
    profile/sandwich pass serves every device.
    """

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = dict(parts)  # {devconds tuple ((j, want), ...): coef}

    @staticmethod
    def _of(v):
        if isinstance(v, _SymAngle):
            return v
        return _SymAngle({(): float(v)})

    def __add__(self, other):
        out = dict(self.parts)
        for k, v in _SymAngle._of(other).parts.items():
            out[k] = out.get(k, 0.0) + v
        return _SymAngle(out)

    __radd__ = __add__

    def __neg__(self):
        return _SymAngle({k: -v for k, v in self.parts.items()})

    def __truediv__(self, d):
        return _SymAngle({k: v / d for k, v in self.parts.items()})

    def __abs__(self):
        return max((abs(v) for v in self.parts.values()), default=0.0)

    def evaluate(self, devbit):
        """Per-device traced value; ``devbit(j)`` is this device's bit j."""
        out = self.parts.get((), 0.0)
        for conds, coef in self.parts.items():
            if not conds:
                continue
            m = None
            for j, want in conds:
                b = devbit(j).astype(jnp.float32)
                f = b if want else 1.0 - b
                m = f if m is None else m * f
            out = out + coef * m
        return out


def _plan_fused(circuit: Circuit, local_n: int, dlog: int):
    """Static execution plan for the fused sharded engine.

    Returns ``(plan, remaps)`` where ``plan`` is a list of
    ``('ops', fused_ops)`` / ``('ex', dev_j, loc_p)`` / ``('perm', axes)``
    items. The circuit's X-deferred primitive stream
    (sim.tpu.circuit_primitives) is segmented at the targeted qubit
    exchanges (victims Belady-chosen among local positions); each
    segment gets the SAME peephole fusion as the single-device engine
    (sim.tpu.fuse_primitives) with qubits rewritten to physical positions
    and device-bit diagonal conditions folded into symbolic angles, so
    the single-device engine's whole fusion factor reaches the
    shard-local work.
    """
    import bisect

    from qcmrf_tpu.sim import tpu as stpu

    n = circuit.num_qubits
    prim = stpu.circuit_primitives(circuit)
    layout = _Layout(n, local_n)

    plan = []
    # H-wall prefix -> closed-form uniform init (one write-only pass per
    # shard; see sim.tpu.fold_uniform_prefix). Layout is identity here,
    # so folded qubit q sits at position q: local when q < local_n,
    # device bit q - local_n otherwise. Devices whose UNTOUCHED device
    # bits are nonzero hold all-zero shards (the (1 - devbit) product).
    folded, prim = stpu.fold_uniform_prefix(prim)
    if folded:
        s_local = tuple(q for q in folded if q < local_n)
        comp_dev = tuple(j for j in range(dlog)
                         if (local_n + j) not in folded)
        plan.append(("ops", [
            ("init_uniform", s_local, comp_dev, len(folded))
        ]))

    uses = {q: [] for q in range(n)}
    for pi, p in enumerate(prim):
        if p[0] == "1q":
            uses[p[2]].append(pi)

    def next_use(q, pi):
        lst = uses[q]
        k = bisect.bisect_right(lst, pi)
        return lst[k] if k < len(lst) else 1 << 30

    seg = []

    def flush():
        if seg:
            plan.append(("ops", stpu.fuse_primitives(list(seg))))
            seg.clear()

    def exchange(dev_j, loc_p):
        flush()
        plan.append(("ex", dev_j, loc_p))
        layout.exchange(dev_j, loc_p)

    for pi, p in enumerate(prim):
        if p[0] == "1q":
            _, U, q = p
            if not layout.is_local(q):
                victim_pos = max(
                    range(local_n),
                    key=lambda lp: next_use(layout.at_physical(lp), pi),
                )
                exchange(layout.pos[q] - local_n, victim_pos)
            seg.append(("1q", U, layout.pos[q]))
        else:
            _, conds, base, ang = p
            lconds = []
            dconds = []
            for qq, want in conds:
                pp = layout.pos[qq]
                if pp < local_n:
                    lconds.append((pp, want))
                else:
                    dconds.append((pp - local_n, want))
            if dconds:
                ang = _SymAngle({tuple(sorted(dconds)): float(ang)})
            seg.append(("diag", tuple(sorted(lconds)), base, ang))
    flush()

    # restore the canonical layout (same scheme as the unfused path):
    # place every destined device qubit with targeted exchanges, then one
    # local bit transpose fixes the remaining local permutation
    for j in range(dlog):
        t = local_n + j
        p = layout.pos[t]
        if p == local_n + j:
            continue
        if p >= local_n:
            lp = next(
                (q for q in range(local_n)
                 if layout.at_physical(q) < local_n),
                0,
            )
            exchange(p - local_n, lp)
        exchange(j, layout.pos[t])
    if layout.pos != list(range(n)):
        L = local_n
        axes = tuple(L - 1 - layout.pos[L - 1 - k] for k in range(L))
        plan.append(("perm", axes))

    # fold the write-only uniform init INTO the leading local sandwich
    # groups (the same fold as sim.tpu.fuse_ops' sandwichku fusion — the
    # shared fold_sandwich_groups keeps the condition from drifting; the
    # fold is valid because ancillas are never folded, so the uniform
    # shard's group-ancilla bits are 0).
    if (len(plan) >= 2 and plan[0][0] == "ops"
            and plan[0][1] and plan[0][1][0][0] == "init_uniform"
            and plan[1][0] == "ops" and plan[1][1]):
        _, s_local, comp_dev, total = plan[0][1][0]
        fold = stpu.fold_sandwich_groups(plan[1][1], s_local)
        if fold is not None:
            parts, rest = fold
            fold = ("sandwichku", s_local, comp_dev, total) + parts
            plan = ([("ops", [fold] + rest)] + plan[2:])
    return plan, layout.remaps


def _uniform_carrier(s_local, comp_dev, total: int, devbit):
    """Per-device amplitude factor of the folded uniform init: uniform
    2^{-total/2} with every untouched DEVICE bit forced to 0 (the
    all-zero shard elsewhere); the local passes contribute the
    remaining 2^{-|s_local|/2} via their own masks."""
    dv = jnp.float32(2.0 ** (-0.5 * (total - len(s_local))))
    for j in comp_dev:
        dv = dv * (1.0 - devbit(j).astype(jnp.float32))
    return dv


def _apply_fused_local(re, im, ops, local_n: int, devbit):
    """Apply one fused segment to this device's (rows, 128) planes with
    the single-device plane passes (sim.tpu._apply_ops semantics), with
    symbolic angles evaluated per device."""

    def ev(a):
        return a.evaluate(devbit) if isinstance(a, _SymAngle) else a

    for op in ops:
        kind = op[0]
        if kind == "init_uniform":
            from qcmrf_tpu.sim import tpu as stpu

            _, s_local, comp_dev, total = op
            dv = _uniform_carrier(s_local, comp_dev, total, devbit)
            re, im = stpu.uniform_planes(local_n, s_local, carrier=dv)
        elif kind == "diag":
            _, terms, angles, base = op
            re, im = K.apply_diagonal_profile(
                re, im, terms, [ev(a) for a in angles], ev(base)
            )
        elif kind == "2q":
            _, U4, q_lo = op
            re, im = K.apply_2q_row_pair(re, im, U4, q_lo)
        elif kind == "lane":
            re, im = K.apply_lane(re, im, op[1])
        elif kind == "sandwich":
            _, a, nt, na, nb, mt, ma, mb = op
            re, im = K.apply_hdh_sandwich(
                re, im, a, nt, [ev(x) for x in na], ev(nb),
                mt, [ev(x) for x in ma], ev(mb),
            )
        elif kind == "sandwichk":
            _, a, nts, nas, nbs, mt, ma, mb = op
            re, im = K.apply_hdh_sandwich_multi(
                re, im, a, nts,
                tuple(tuple(ev(x) for x in na) for na in nas),
                tuple(ev(b) for b in nbs),
                mt, [ev(x) for x in ma], ev(mb),
            )
        elif kind == "sandwichku":
            # write-only uniform-init + first-group fusion: the shard's
            # uniform amplitude (incl. the all-zero-shard device-bit
            # product) rides the carrier, as init_uniform's does
            _, s_local, comp_dev, total, a, nts, nas, nbs, mt, ma, mb = op
            dv = _uniform_carrier(s_local, comp_dev, total, devbit)
            re, im = K.apply_hdh_sandwich_multi_uniform(
                local_n, s_local, a, nts,
                tuple(tuple(ev(x) for x in na) for na in nas),
                tuple(ev(b) for b in nbs),
                mt, [ev(x) for x in ma], ev(mb), carrier=dv,
            )
        else:  # 1q
            _, U, q = op
            re, im = K.apply_1q(re, im, U, q, local_n)
    return re, im


def _run_fused_sharded(circuit: Circuit, mesh: Mesh, cache_key):
    """Fused-pass sharded statevector execution (local_n >= 10)."""
    global LAST_REMAP_COUNT
    n = circuit.num_qubits
    D = mesh.devices.size
    dlog = _dlog(mesh)
    local_n = n - dlog
    axis = mesh.axis_names[0]
    plan, remaps = _plan_fused(circuit, local_n, dlog)
    rows = (1 << local_n) // 128

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(),
        out_specs=(P(axis), P(axis)), check_vma=False,
    )
    def run():
        d = jax.lax.axis_index(axis)
        re = jnp.zeros((rows, 128), jnp.float32).at[0, 0].set(
            jnp.where(d == 0, 1.0, 0.0)
        )
        im = jnp.zeros((rows, 128), jnp.float32)

        def devbit(j):
            return _device_bit(axis, j)

        for item in plan:
            if item[0] == "ops":
                re, im = _apply_fused_local(
                    re, im, item[1], local_n, devbit
                )
            elif item[0] == "ex":
                r, i_ = _exchange_device_local(
                    re.reshape(-1), im.reshape(-1), axis, D,
                    item[1], item[2], local_n,
                )
                re = r.reshape(rows, 128)
                im = i_.reshape(rows, 128)
            else:  # perm: one local bit transpose
                axes = item[1]
                re = re.reshape((2,) * local_n).transpose(axes)
                im = im.reshape((2,) * local_n).transpose(axes)
                re = re.reshape(rows, 128)
                im = im.reshape(rows, 128)
        if circuit.global_phase:
            cs = float(np.cos(circuit.global_phase))
            sn = float(np.sin(circuit.global_phase))
            re, im = re * cs - im * sn, re * sn + im * cs
        return re.reshape(-1), im.reshape(-1)

    fn = jax.jit(run)
    out = jax.block_until_ready(fn())
    if len(_SV_EXEC_CACHE) >= 64:
        _SV_EXEC_CACHE.pop(next(iter(_SV_EXEC_CACHE)))
    _SV_EXEC_CACHE[cache_key] = (fn, remaps)
    LAST_REMAP_COUNT = remaps
    return out


def run_statevector_sharded(
    circuit: Circuit, mesh: Mesh
) -> Tuple[jax.Array, jax.Array]:
    """Simulate a circuit with the statevector sharded over the mesh.

    Returns (re, im) planes sharded on the leading axis. The whole gate
    sequence runs inside a single ``shard_map`` trace. A non-diagonal gate
    on a sharded qubit triggers a targeted device-bit <-> local-bit
    exchange (one ``ppermute`` moving half of each shard); the evicted
    local qubit is chosen by Belady's rule (furthest next non-diagonal
    use), and an arbitrary final layout is restored by a sequence of such
    exchanges plus one local bit transpose — no single-swap restriction.

    Shards of >= 2**10 amplitudes take the FUSED path: the shard-local
    work between exchanges runs the single-device engine's pass fusion
    (X-deferral, diagonal profiles, H·D·H sandwiches, adjacent-pair
    composition) and plane passes, with diagonal conditions on
    device bits folded into per-device symbolic angles (zero extra
    communication). Smaller shards keep the plain jnp gate-by-gate path.
    """
    global LAST_REMAP_COUNT
    mesh = _sweep_mesh(mesh)
    n = circuit.num_qubits
    D = mesh.devices.size
    dlog = _dlog(mesh)
    if dlog > n - 1:
        raise ValueError("more device bits than qubits")
    local_n = n - dlog
    axis = mesh.axis_names[0]

    # compiled-executable cache keyed by (gate stream, mesh): a fresh
    # shard_map closure per call would re-trace the whole circuit every
    # time (the hazard _build_lnZ_fn's docstring warns about); the remap
    # count is determined at trace time, so it is cached alongside
    cache_key = (
        n, circuit.num_clbits, float(circuit.global_phase or 0.0),
        tuple((g.name, g.qubits, tuple(float(p) for p in g.params),
               g.flags) for g in circuit.gates),
        mesh,
    )
    hit = _SV_EXEC_CACHE.get(cache_key)
    if hit is not None:
        fn, remaps = hit
        LAST_REMAP_COUNT = remaps
        return fn()

    if local_n >= _FUSED_MIN_LOCAL:
        # large shards: fused plane-pass path
        return _run_fused_sharded(circuit, mesh, cache_key)

    # Belady eviction: per-qubit sorted gate indices of future locality
    # needs, so ensure_local can evict the local qubit needed last
    needs = _locality_needs(circuit.gates)
    uses = {q: [] for q in range(n)}
    for gi, qs in enumerate(needs):
        for q in qs:
            uses[q].append(gi)

    def next_use(q: int, gi: int) -> int:
        import bisect

        lst = uses[q]
        k = bisect.bisect_right(lst, gi)
        return lst[k] if k < len(lst) else 1 << 30

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(),
        out_specs=(P(axis), P(axis)),
    )
    def run():
        layout = _Layout(n, local_n)
        chunk = 1 << local_n
        d = jax.lax.axis_index(axis)
        re = jnp.zeros((chunk,), jnp.float32)
        im = jnp.zeros((chunk,), jnp.float32)
        re = re.at[0].set(jnp.where(d == 0, 1.0, 0.0))
        x_local = jnp.arange(chunk, dtype=jnp.int32)

        def exchange(dev_j, loc_p):
            nonlocal re, im
            re, im = _exchange_device_local(
                re, im, axis, D, dev_j, loc_p, local_n
            )
            layout.exchange(dev_j, loc_p)

        def ensure_local(q, gi):
            p = layout.pos[q]
            if p < local_n:
                return
            # evict the local-resident qubit whose next locality need is
            # furthest in the future (Belady-optimal for this gate list)
            victim = max(
                range(local_n),
                key=lambda lp: next_use(layout.at_physical(lp), gi),
            )
            exchange(p - local_n, victim)

        def bit_of(q):
            p = layout.pos[q]
            if p < local_n:
                return _local_bits(x_local, p)
            return _device_bit(axis, p - local_n)

        for gi, g in enumerate(circuit.gates):
            if g.name in ("barrier", "measure"):
                continue
            if g.name == "id":
                continue  # no-op: never worth a remap
            if g.name in GATES_1Q or g.name == "rz":
                q = g.qubits[0]
                if g.name == "rz":
                    # diagonal: never needs a remap
                    lam = g.params[0]
                    b = bit_of(q).astype(jnp.float32)
                    ang = (lam / 2.0) * (2.0 * b - 1.0)
                    c, s = jnp.cos(ang), jnp.sin(ang)
                    re, im = re * c - im * s, re * s + im * c
                    continue
                ensure_local(q, gi)
                re, im = _apply_1q_local(
                    re, im, GATES_1Q[g.name], layout.pos[q], local_n
                )
            elif g.name == "cp":
                c, t = g.qubits
                lam = g.params[0]
                mask = (bit_of(c) & bit_of(t)).astype(jnp.float32)
                ang = lam * mask
                cs, sn = jnp.cos(ang), jnp.sin(ang)
                re, im = re * cs - im * sn, re * sn + im * cs
            elif g.name == "flags_phase":
                *pattern, ctrl = g.qubits
                lam = g.params[0]
                mask = bit_of(ctrl)
                for q, f in zip(pattern, g.flags):
                    want = (f + 1) // 2
                    mask = mask & (bit_of(q) == want).astype(mask.dtype)
                ang = lam * mask.astype(jnp.float32)
                cs, sn = jnp.cos(ang), jnp.sin(ang)
                re, im = re * cs - im * sn, re * sn + im * cs
            elif g.name == "cx":
                c, t = g.qubits
                ensure_local(t, gi)
                # control bit may be a scalar (device bit) or per-state
                # array (local bit) — jnp.where broadcasts both
                sel = bit_of(c) == 1
                fr, fi = _flip_local(re, im, layout.pos[t], local_n)
                re = jnp.where(sel, fr, re)
                im = jnp.where(sel, fi, im)
            else:
                raise ValueError(f"unsupported sharded gate {g.name}")

        # ---- restore the canonical layout (arbitrary permutation) ------
        # 1) place every destined device qubit with targeted exchanges
        for j in range(dlog):
            t = local_n + j
            p = layout.pos[t]
            if p == local_n + j:
                continue
            if p >= local_n:
                # wrong device bit: route through any local position,
                # preferring a resident that belongs on a local bit
                lp = next(
                    (q for q in range(local_n)
                     if layout.at_physical(q) < local_n),
                    0,
                )
                exchange(p - local_n, lp)
            exchange(j, layout.pos[t])
        # 2) one local bit transpose fixes the remaining local permutation
        if layout.pos != list(range(n)):
            L = local_n
            axes = [L - 1 - layout.pos[L - 1 - k] for k in range(L)]
            re = re.reshape((2,) * L).transpose(axes).reshape(-1)
            im = im.reshape((2,) * L).transpose(axes).reshape(-1)
            layout.pos = list(range(n))
        if circuit.global_phase:
            cs = float(np.cos(circuit.global_phase))
            sn = float(np.sin(circuit.global_phase))
            re, im = re * cs - im * sn, re * sn + im * cs
        stats["remaps"] = layout.remaps
        return re, im

    stats = {"remaps": 0}
    fn = jax.jit(run)
    out = jax.block_until_ready(fn())  # trace + compile now (fills stats)
    if len(_SV_EXEC_CACHE) >= 64:
        _SV_EXEC_CACHE.pop(next(iter(_SV_EXEC_CACHE)))
    _SV_EXEC_CACHE[cache_key] = (fn, stats["remaps"])
    LAST_REMAP_COUNT = stats["remaps"]
    return out


def sharded_outcome_probs(circuit: Circuit, mesh: Mesh) -> jax.Array:
    """Outcome distribution over classical-register values, sharded.

    Identity measurement wiring (every measured qubit wired to clbit ==
    qubit and num_clbits == num_qubits — the QCMRF convention) stays the
    fast path: |psi|^2 IS the key distribution and the result stays
    sharded over the mesh. Unmeasured qubits under identity wiring (the
    QCMRF workspace) are VERIFIED to carry no |1> mass with one masked
    psum before the fast path is trusted; circuits that fail the check
    fall through to the exact marginalizing path.

    Any other wiring — permuted qubit->clbit maps, measured subsets —
    is marginalized SHARD-SIDE and stays SHARDED over key space (no
    NotImplementedError carve-out; VERDICT round-2 item 6): device o
    owns the keys whose top ``dlog`` bits equal o, and a ring
    reduce-scatter builds each owner's chunk — every device scatter-adds
    its local |psi|^2 into the chunk the travelling accumulator targets,
    then ppermutes it one hop (D-1 hops of 2**num_clbits / D floats; D
    scatter passes instead of one, traded for never materializing
    2**num_clbits on any device). This scales exactly like the sharded
    statevector itself, up to the int32 key limit of 31 clbits
    (round-3 weak item 7 removed the replicated 2^26 ceiling; keys are
    built bitwise in int32, so registers past 31 clbits raise rather
    than silently wrap). Registers smaller than
    the device count keep the trivial replicated scatter + psum.
    Callers with unmeasured qubits get them marginalized out
    (deferred-measurement semantics of sim.dense.outcome_probs)."""
    mesh = _sweep_mesh(mesh)
    axis = mesh.axis_names[0]
    nq = circuit.num_qubits
    pairs = circuit.measured_pairs
    measured = {q for q, _ in pairs}
    # no measurements at all -> the raw |psi|^2 distribution over the
    # full register, exactly like sim.dense.outcome_probs' empty-pairs
    # special case (the dryrun's oracle comparison relies on this)
    identity = (not pairs
                or (all(q == c for q, c in pairs)
                    and circuit.num_clbits == nq))
    if not identity and circuit.num_clbits > 31:
        # keys are built bitwise in int32 below: bit 31 would set the
        # sign bit and the ring reduce-scatter's owner arithmetic-shift
        # would silently drop that mass. Fail fast, before the
        # statevector runs.
        raise ValueError(
            f"keyed marginalization caps at 31 clbits (int32 keys); got "
            f"{circuit.num_clbits}"
        )
    re, im = run_statevector_sharded(circuit, mesh)

    if identity:
        @functools.partial(
            jax.shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
            out_specs=P(axis),
        )
        def probs(r, i_):
            return r * r + i_ * i_

        p2 = probs(re, im)
        if not pairs:
            return p2
        unmeasured = sorted(set(range(nq)) - measured)
        if not unmeasured:
            return p2
        # identity wiring with unmeasured qubits (the QCMRF workspace):
        # |psi|^2 IS the key distribution iff those qubits carry no |1>
        # mass (unwritten clbits read 0). Verify that cheaply instead of
        # assuming it — one masked reduction + psum — and only fall back
        # to the (replicated, 2^num_clbits) keyed path when it fails.
        local = re.shape[0] // mesh.devices.size
        lbits = local.bit_length() - 1

        @functools.partial(
            jax.shard_map, mesh=mesh, in_specs=(P(axis),), out_specs=P(),
        )
        def stray_mass(p):
            dev = jax.lax.axis_index(axis)
            idx = jnp.arange(local, dtype=jnp.int32)
            mask = jnp.zeros((local,), jnp.bool_)
            for q in unmeasured:
                b = ((idx >> q) & 1) if q < lbits else (
                    (dev >> (q - lbits)) & 1) * jnp.ones_like(idx)
                mask = mask | (b == 1)
            return jax.lax.psum(
                jnp.where(mask, p.reshape(-1), 0.0).sum(), axis)

        # fixed tolerance: the fused QCMRF path never touches the
        # workspace (its stray mass is exactly 0), and a genuinely-|0>
        # workspace accumulates only O(eps)-scale rounding, so 1e-6 has
        # plenty of headroom. Rerouting on failure now costs only
        # performance, never correctness: the keyed path below is exact
        # at any width up to the int32 key limit (it no longer raises
        # past 26 clbits), so a loose tolerance would trade silent
        # ~1e-4-scale probability errors for nothing.
        tol = 1e-6
        stray = float(stray_mass(p2))
        if stray <= tol:
            return p2
        if circuit.num_clbits > 31:
            raise ValueError(
                "identity-wired circuit with an unmeasured qubit "
                f"carrying |1> mass {stray:.2e} needs the keyed "
                "marginalization, which caps at 31 clbits (int32 keys); "
                f"got {circuit.num_clbits}"
            )
        # fall through to the exact marginalizing path below (sharded
        # over key space, so no width carve-out remains)

    D = mesh.devices.size
    dlog = _dlog(mesh)
    local = re.shape[0] // D
    lbits = local.bit_length() - 1
    C = circuit.num_clbits

    def local_keys(dev):
        idx = jnp.arange(local, dtype=jnp.int32)
        keys = jnp.zeros((local,), jnp.int32)
        # global-index bit q: low bits come from the local index, high
        # bits from the device coordinate — no wide arithmetic, so no
        # uint32 wrap at 33+ qubits
        for q, c in pairs:
            b = ((idx >> q) & 1) if q < lbits else (
                (dev >> (q - lbits)) & 1) * jnp.ones_like(idx)
            keys = keys | (b << c)
        return keys

    if (1 << C) < D:
        # register smaller than the mesh: the keyed buffer is tiny —
        # replicated scatter + psum beats any routing
        @functools.partial(
            jax.shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
            out_specs=P(),
        )
        def keyed_small(r, i_):
            p2 = (r * r + i_ * i_).reshape(-1)
            out = jnp.zeros((1 << C,), p2.dtype)
            return jax.lax.psum(
                out.at[local_keys(jax.lax.axis_index(axis))].add(p2),
                axis,
            )

        return keyed_small(re, im)

    # ring reduce-scatter, SHARDED over key space: device o owns keys
    # [o, o+1) * 2**C / D. Chunk o's accumulator starts at device o+1
    # with that device's partial, hops +1 per step collecting each
    # visited device's partial, and lands fully reduced on device o
    # after D-1 hops. Peak memory per device: 2 * 2**C / D floats.
    chunk_k = (1 << C) // D
    perm = [(i, (i + 1) % D) for i in range(D)]

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=P(axis), check_vma=False,
    )
    def keyed_ring(r, i_):
        dev = jax.lax.axis_index(axis)
        keys = local_keys(dev)
        owner = keys >> (C - dlog) if dlog else jnp.zeros_like(keys)
        pos = keys & (chunk_k - 1)
        p2 = (r * r + i_ * i_).reshape(-1)

        def partial_for(o):
            sel = (owner == o).astype(p2.dtype)
            return jnp.zeros((chunk_k,), p2.dtype).at[pos].add(p2 * sel)

        acc = partial_for((dev - 1) % D)
        for step in range(1, D):
            acc = jax.lax.ppermute(acc, axis, perm)
            acc = acc + partial_for((dev - 1 - step) % D)
        return acc

    return keyed_ring(re, im).reshape(-1)
