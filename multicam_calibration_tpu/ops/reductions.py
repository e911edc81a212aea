"""Masked robust reductions (median & friends) with static shapes for jit.

The reference leans on ``np.nanmedian``/``np.median`` for every robust
consensus step (pairwise-transform median calibration.py:143, consensus pose
nanmedian calibration.py:276, triangulation nanmedian geometry.py:427-433).
On the device, NaN-based dynamic filtering is replaced by explicit masks with static
shapes; these sort-based reductions reproduce numpy's nanmedian semantics
(average of the two middle elements for even counts) under jit/vmap.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["masked_median", "nanmedian", "masked_mean"]


def masked_median(values, mask, axis=-1):
    """Median of ``values`` where ``mask`` is True along ``axis``.

    Entries with mask=False are ignored; if no entry is valid the result is
    NaN. Matches ``np.nanmedian`` (even-count entries average the two middle
    values). Sort-based, so static-shaped and jit-safe.
    """
    values = jnp.moveaxis(values, axis, -1)
    mask = jnp.broadcast_to(jnp.moveaxis(mask, axis, -1), values.shape)
    big = jnp.asarray(jnp.inf, dtype=values.dtype)
    filled = jnp.where(mask, values, big)
    n = jnp.sum(mask, axis=-1)
    count = values.shape[-1]
    lo = jnp.clip((n - 1) // 2, 0, count - 1)
    hi = jnp.clip(n // 2, 0, count - 1)
    if count <= 32:
        # Small-axis fast path: stable rank selection. O(count^2) fused
        # elementwise comparisons beat XLA's generic variadic sort by ~4x
        # (pure elementwise work, no comparator loop).
        idx = jnp.arange(count)
        cmp = (filled[..., None, :] < filled[..., :, None]) | (
            (filled[..., None, :] == filled[..., :, None])
            & (idx[None, :] < idx[:, None])
        )
        rank = jnp.sum(cmp, axis=-1)  # a permutation of 0..count-1
        v_lo = jnp.sum(jnp.where(rank == lo[..., None], filled, 0.0), axis=-1)
        v_hi = jnp.sum(jnp.where(rank == hi[..., None], filled, 0.0), axis=-1)
    else:
        s = jnp.sort(filled, axis=-1)
        v_lo = jnp.take_along_axis(s, lo[..., None], axis=-1)[..., 0]
        v_hi = jnp.take_along_axis(s, hi[..., None], axis=-1)[..., 0]
    med = 0.5 * (v_lo + v_hi)
    return jnp.where(n > 0, med, jnp.nan)


def nanmedian(values, axis=-1):
    """``np.nanmedian`` equivalent driven by a NaN mask (jit-safe)."""
    mask = ~jnp.isnan(values)
    return masked_median(jnp.nan_to_num(values), mask, axis=axis)


def masked_mean(values, mask, axis=None):
    """Mean over masked entries; NaN where nothing is valid."""
    mask = jnp.broadcast_to(mask, values.shape)
    total = jnp.sum(jnp.where(mask, values, 0.0), axis=axis)
    count = jnp.sum(mask, axis=axis)
    return jnp.where(count > 0, total / jnp.maximum(count, 1), jnp.nan)
