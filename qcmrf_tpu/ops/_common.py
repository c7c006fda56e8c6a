"""Shared bits for Pallas kernels."""

from __future__ import annotations

import jax


def interpret() -> bool:
    """Run Pallas kernels in interpret mode: on the CPU only (the tests).
    On a GPU a kernel is always compiled for the card."""
    return jax.default_backend() == "cpu"
