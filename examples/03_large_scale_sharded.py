"""Beyond the reference's 10-qubit ceiling: sharded inference at n=24.

The reference caps at 10 qubits (SURVEY.md §5) — its largest stored
circuit. This example runs a 2^24-state grid MRF with the state table
sharded over every visible device (one GPU, several GPUs, or a
virtual CPU mesh), and estimates ln Z two ways:

* exactly, with the psum-logsumexp sharded state-table pass;
* from circuit shots, with the fused repeated-estimation sampler
  (ln Z-hat = ln delta-hat + n ln 2).

To try it on an 8-device virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/03_large_scale_sharded.py
    # (inside Python, set jax.config jax_platforms BEFORE importing jax
    #  code if your environment pins another platform)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run — an 8-device
# virtual CPU mesh (flags must land before JAX's backend initializes)
# and an n=12 table so the smoke run finishes in seconds.
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
if SMOKE:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if SMOKE:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from qcmrf_tpu.models.mrf import grid_mrf
from qcmrf_tpu.parallel import sharded

template = grid_mrf(3, 4) if SMOKE else grid_mrf(4, 6)  # n=24, 38 edges
rng = np.random.RandomState(0)
mrf = template.with_theta(jnp.asarray(
    -np.abs(rng.randn(template.dimension)).astype(np.float32) * 0.1
))

mesh = sharded.make_mesh()  # every visible device
print(f"n={mrf.n} ({mrf.num_states} states, "
      f"{mrf.num_states * 4 / 1e6:.0f} MB table) on "
      f"{mesh.devices.size} {jax.default_backend()} device(s)")

lnZ = float(sharded.sharded_log_partition(mrf, mesh))
print(f"exact   lnZ = {lnZ:.6f}")

shots = 1 << 14 if SMOKE else 1 << 20
deltas = np.asarray(sharded.sharded_estimate_delta(
    jax.random.PRNGKey(0), mrf, mesh, shots=shots, iters=5
))
lnZ_hat = float(np.log(deltas.mean()) + mrf.n * np.log(2.0))
print(f"shot-estimated lnZ = {lnZ_hat:.6f} "
      f"(5 x {shots} shots, |err| = {abs(lnZ_hat - lnZ):.2e})")
