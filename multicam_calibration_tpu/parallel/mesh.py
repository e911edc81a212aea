"""Device-mesh construction helpers."""
from __future__ import annotations

import jax

__all__ = ["make_frame_mesh"]


def make_frame_mesh(n_devices=None, axis_name="frames"):
    """1-D mesh over the frame axis (the BA scaling axis).

    Uses all visible devices by default. The mesh follows the algorithm
    alone: the GPUs of one host are peers over NVLink, all to all, so the
    device order does not matter. Multi-host entry: call
    ``jax.distributed.initialize()`` first and this picks up the global
    device set.
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.sharding.Mesh(devices, (axis_name,))
