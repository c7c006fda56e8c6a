"""JAX platform selection for every CLI.

Every runner routes its ``--platform`` flag (``cpu | gpu | default``)
through :func:`resolve_platform`:

* ``cpu`` pins the host platform (before any backend initializes);
* ``gpu`` requires a GPU and fails with a clear message when JAX finds
  none, instead of running on whatever backend exists;
* ``default`` takes JAX's default backend. A CLI that declares its
  workload small (e.g. the infer CLI below the enumeration threshold)
  is routed to the CPU with a note: tiny models spend more time in
  per-graph accelerator compiles than in math.

No code path branches on the platform; entry points that measure the
card call :func:`require_gpu`.
"""

from __future__ import annotations

import sys


def gpu_devices() -> list:
    """The GPUs JAX can see (empty on a CPU-only host)."""
    import jax

    try:
        return jax.devices("gpu")
    except RuntimeError:  # no GPU backend registered or initialized
        return []


def require_gpu(prog: str = "qcmrf_tpu", hint: str = "") -> list:
    """The visible GPUs, or ``SystemExit`` naming the missing GPU."""
    devs = gpu_devices()
    if not devs:
        import jax

        raise SystemExit(
            f"{prog}: no GPU found: JAX sees only "
            f"{sorted({d.platform for d in jax.devices()})} devices{hint}")
    return devs


def resolve_platform(requested: str, *, small: bool = False,
                     small_reason: str = "", prog: str = "qcmrf_tpu") -> str:
    """Apply a CLI's ``--platform`` choice; returns the platform selected.

    ``small`` declares the workload too small to benefit from the
    accelerator (the ``default`` choice then routes to the CPU with a
    note carrying ``small_reason``).
    """
    import jax

    if requested == "cpu" or (requested == "default" and small):
        if requested != "cpu":
            note = f" ({small_reason})" if small_reason else ""
            print(f"{prog}: running on cpu{note}; pass --platform gpu "
                  "to use the accelerator", file=sys.stderr)
        jax.config.update("jax_platforms", "cpu")
        return "cpu"
    if requested == "gpu":
        require_gpu(prog, hint="; run with --platform cpu to use the host")
        return "gpu"
    return jax.default_backend()
