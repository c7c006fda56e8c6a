"""Typed configuration for the framework's drivers.

The reference scatters its configuration across module constants
(``SHOTS/REPS/SCALE``, run_experiment.py:16-18), argparse flags
(eval.py:17-22, whisker.py:22-25) and a global seed (run_experiment.py:3).
This dataclass unifies them (SURVEY.md §5 "Config / flag system"): one
typed object covering suite scale, execution engine, shots, noise preset,
sharding mesh, and reproducibility seed — constructible from CLI args and
serializable to JSON for experiment provenance.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # suite
    scale: float = 0.5
    reps: int = 10
    seed: int = 1984          # suite-generation seed (reference parity)
    models_path: Optional[str] = None   # load instead of regenerate

    # execution
    engine: str = "analytic"  # analytic | statevector | noisy:<preset>
    shots: int = 10_000
    sample_seed: int = 0      # shot-sampling stream (run_experiment)
    data_seed: int = 0        # training-data generation (train CLI)
    platform: str = "default"  # cpu | gpu | default

    # sharding
    mesh_shape: Tuple[int, ...] = ()    # () = single device
    mesh_axes: Tuple[str, ...] = ("amp",)

    # io
    outdir: str = "."

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        d["mesh_shape"] = tuple(d.get("mesh_shape", ()))
        d["mesh_axes"] = tuple(d.get("mesh_axes", ("amp",)))
        fields = {f.name for f in dataclasses.fields(Config)}
        return Config(**{k: v for k, v in d.items() if k in fields})

    def make_mesh(self):
        if not self.mesh_shape:
            return None
        import numpy as np
        import jax
        from jax.sharding import Mesh

        n = int(np.prod(self.mesh_shape))
        devs = np.array(jax.devices()[:n]).reshape(self.mesh_shape)
        return Mesh(devs, self.mesh_axes[: len(self.mesh_shape)])


#: the compile cache's fixed home inside the checkout (listed in
#: .gitignore): a fixed path, because the path is part of the cache key
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> Optional[str]:
    """Persistent XLA compilation cache shared across runs; returns the
    directory in use, or None when the cache stays off.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and
    no other directory is set here. Otherwise it goes to
    :data:`CHECKOUT_CACHE_DIR` on an accelerator; on the CPU it stays off
    (reloading an XLA:CPU executable whose recorded machine features
    don't match the host's can SIGILL, and CPU compiles are fast).
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        if jax.default_backend() == "cpu":
            return None
        path = CHECKOUT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # the default threshold (1 s) would skip the many small per-graph
    # programs the suite runners compile on every invocation
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return path


# --------------------------------------------------------------------------
# CLI integration: every runner accepts --config and dumps its effective
# configuration next to its outputs (experiment provenance)
# --------------------------------------------------------------------------


def parse_with_config(parser, argv=None):
    """Parse args with ``--config cfg.json`` support: the Config file's
    fields become the parser's defaults (explicit CLI flags still win,
    via a re-parse after installing the defaults)."""
    parser.add_argument("--config", type=str, default=None,
                        help="JSON Config file supplying defaults "
                             "(explicit flags override).")
    args = parser.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
        # only keys PRESENT in the file become defaults — filling in the
        # Config dataclass's own defaults here would silently override
        # each CLI's defaults (e.g. eval's platform="cpu") for every
        # field the user did not mention
        fields = {f.name for f in dataclasses.fields(Config)}
        known_dests = {a.dest for a in parser._actions}
        unknown = set(raw) - fields
        if unknown:
            raise SystemExit(
                f"--config {args.config}: unknown keys {sorted(unknown)}; "
                f"valid keys: {sorted(fields)}"
            )
        # valid Config keys this particular CLI has no flag for are NOT
        # silently dropped: say so (a shared config file may legitimately
        # carry keys for several runners, but the user must see which
        # ones this command ignored)
        ignored = sorted(k for k in raw if k not in known_dests)
        if ignored:
            import sys

            print(
                f"--config {args.config}: keys {ignored} have no "
                f"corresponding flag on this command and were ignored",
                file=sys.stderr,
            )
        parser.set_defaults(**{
            k: v for k, v in raw.items()
            if k in known_dests and v is not None
        })
        args = parser.parse_args(argv)
    return args


def dump_effective_config(args, path: str) -> None:
    """Write the parsed namespace as JSON next to the run's outputs."""
    d = {k: v for k, v in vars(args).items()
         if isinstance(v, (int, float, str, bool, type(None), list, tuple))}
    with open(path, "w") as f:
        json.dump(d, f, indent=2, default=str)
