"""Matmul-precision control for float32 numerical correctness.

On an NVIDIA GPU, XLA may run float32 matmuls, einsums and convolutions in
TF32 on the tensor cores, which keeps a 10-bit mantissa (~1e-3 relative).
Calibration geometry multiplies ~10^3-magnitude coordinates (mm
translations, pixel focal lengths), and the detector samples images with
one-hot selection matmuls; at TF32 precision the rounding is mm-scale
noise on the sub-pixel residuals BA minimizes. Every jitted entry point on
the compute path therefore traces under
``jax.default_matmul_precision('highest')`` (true float32 products — these
are small matmuls, so the lost tensor-core rate costs little).
"""
from __future__ import annotations

import functools

import jax

__all__ = ["with_highest_precision"]


def with_highest_precision(fn):
    """Decorator: trace ``fn`` with full-float32 (not TF32) matmuls."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
