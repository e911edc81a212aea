"""Backend-dependent choices, each in one place.

Every choice is a function of the platform JAX reports for the default
device (``jax.devices()[0].platform``: "gpu", "cpu", ...), so callers ask
here instead of testing the backend themselves. Each GPU value was set by
a timing on an NVIDIA H100 recorded in PERF.md; the CPU values are what
the CPU test suite was tuned with.
"""
from __future__ import annotations

import jax

__all__ = [
    "platform",
    "detection_stage1_fused",
    "init_camera_batched",
]


def platform() -> str:
    """Platform of the default device."""
    return jax.devices()[0].platform


def detection_stage1_fused(platform: str) -> bool:
    """Run detection stage 1 (candidates, device lattice ordering, refine
    and anchor scores) as one jitted program instead of three chained
    ones."""
    return platform == "gpu"


def init_camera_batched(platform: str) -> bool:
    """Initialize all cameras of a uniform (C, F, N, 2) rig in one
    camera-batched program per stage instead of a per-camera loop."""
    return platform == "gpu"

