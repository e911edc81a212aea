"""Flatibration: align world coordinates so the XY plane is the arena floor.

Capability parity with /root/reference/multicam_calibration/flatibration.py,
with the sklearn RANSACRegressor plane fit replaced by a fully-vectorized
JAX RANSAC (all hypotheses evaluated in one batched program — no Python
loop over trials) and the alignment built from the same plane->axes
correspondence construction (flatibration.py:63-114).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.transforms import (
    apply_rigid_transform,
    get_transformation_matrix,
    get_transformation_vector,
    rigid_transform_from_correspondences,
)

__all__ = [
    "get_floor_points",
    "ransac_plane_fit",
    "flatibrate",
    "flip_z_axis",
    "center_arena",
]


def get_floor_points(keypoints, z_points_down=False):
    """Lowest (or highest, if z points down) keypoint per frame.

    Parity: flatibration.py:40-60.
    """
    if isinstance(keypoints, list):
        keypoints = np.concatenate(keypoints)
    keypoints = np.asarray(keypoints)
    if z_points_down:
        ix = np.argmax(keypoints[:, :, 2], axis=1)
    else:
        ix = np.argmin(keypoints[:, :, 2], axis=1)
    return keypoints[np.arange(keypoints.shape[0]), ix]


def ransac_plane_fit(points, residual_threshold=10.0, n_hypotheses=256, seed=0):
    """Fit z = a x + b y + t by vectorized RANSAC + inlier least-squares refit.

    Replaces sklearn.linear_model.RANSACRegressor (flatibration.py:85-88):
    ``n_hypotheses`` minimal 3-point samples are solved and scored in one
    batched program; the best consensus set is refit by (masked) LSQ.
    Returns (a, b, t, inlier_mask).
    """
    pts = jnp.asarray(points)
    n = pts.shape[0]
    key = jax.random.PRNGKey(seed)
    idx = jax.random.randint(key, (n_hypotheses, 3), 0, n)

    tri = pts[idx]  # (H, 3, 3)
    A = jnp.concatenate(
        [tri[..., :2], jnp.ones((*tri.shape[:2], 1), pts.dtype)], axis=-1
    )  # (H, 3, 3): rows [x, y, 1]
    z = tri[..., 2]
    # Solve each 3x3 for (a, b, t); degenerate (collinear) samples produce
    # inf/NaN and score zero inliers.
    from ..ops.homography import inv3x3

    coef = jnp.einsum("hij,hj->hi", inv3x3(A), z)  # (H, 3)
    pred = pts[:, 0][None] * coef[:, 0:1] + pts[:, 1][None] * coef[:, 1:2] + coef[:, 2:3]
    resid = jnp.abs(pts[:, 2][None] - pred)  # (H, n)
    inliers = (resid < residual_threshold) & jnp.isfinite(resid)
    counts = jnp.sum(inliers, axis=1)
    best = jnp.argmax(counts)
    mask = inliers[best]

    # Weighted LSQ refit on the consensus set.
    w = mask.astype(pts.dtype)
    X = jnp.concatenate([pts[:, :2], jnp.ones((n, 1), pts.dtype)], axis=-1)
    XtX = (X * w[:, None]).T @ X
    Xtz = (X * w[:, None]).T @ pts[:, 2]
    a, b, t = inv3x3(XtX) @ Xtz  # SPD 3x3; closed-form adjugate inverse
    return a, b, t, mask


def flatibrate(floor_points, residual_threshold=10.0, n_hypotheses=256, seed=0):
    """Rigid transform mapping the floor plane to the XY plane.

    Parity with flatibration.py:63-114: RANSAC plane z = ax + by + t, then a
    Kabsch fit on the canonical 4-point correspondence (origin + the three
    plane-adapted axes).
    """
    if isinstance(floor_points, list):
        floor_points = np.concatenate(floor_points)
    pts = jnp.asarray(np.asarray(floor_points, dtype=float))
    a, b, t, _ = ransac_plane_fit(
        pts, residual_threshold=residual_threshold,
        n_hypotheses=n_hypotheses, seed=seed,
    )
    x_axis = jnp.stack([jnp.ones_like(a), jnp.zeros_like(a), a])
    y_axis = jnp.stack([jnp.zeros_like(b), jnp.ones_like(b), b])
    z_axis = jnp.stack([-a, -b, jnp.ones_like(a)])
    origin = jnp.stack([jnp.zeros_like(t), jnp.zeros_like(t), t])
    source = jnp.stack(
        [origin, origin + x_axis, origin + y_axis, origin + z_axis]
    )
    target = jnp.stack(
        [
            jnp.zeros(3, pts.dtype),
            jnp.array([1.0, 0.0, 0.0], pts.dtype) * jnp.linalg.norm(x_axis),
            jnp.array([0.0, 1.0, 0.0], pts.dtype) * jnp.linalg.norm(y_axis),
            jnp.array([0.0, 0.0, 1.0], pts.dtype) * jnp.linalg.norm(z_axis),
        ]
    )
    transform, _ = rigid_transform_from_correspondences(source, target)
    return np.asarray(transform)


def flip_z_axis(transform):
    """Compose with a 180-degree rotation about X (flatibration.py:117-136)."""
    import jax.numpy as jnp

    T = get_transformation_matrix(jnp.asarray(transform))
    T_flipped = jnp.diag(jnp.array([1.0, -1.0, -1.0, 1.0])) @ T
    return np.asarray(get_transformation_vector(T_flipped))


def center_arena(transform, floor_points, center_method="midrange", range_pctl=1):
    """Compose with the XY translation that centers the arena at the origin.

    Parity: flatibration.py:139-191 (midrange/mean/median centers).
    """
    if isinstance(floor_points, list):
        floor_points = np.concatenate(floor_points)
    import jax.numpy as jnp

    pts = np.asarray(
        apply_rigid_transform(
            jnp.asarray(transform), jnp.asarray(np.asarray(floor_points, float))
        )
    )[:, :2]
    if center_method == "midrange":
        center = np.percentile(pts, [range_pctl, 100 - range_pctl], axis=0).mean(0)
    elif center_method == "mean":
        center = np.mean(pts, axis=0)
    elif center_method == "median":
        center = np.median(pts, axis=0)
    else:
        raise ValueError("center_method should be 'midrange', 'mean', or 'median'")
    translation = jnp.asarray(
        np.array([0, 0, 0, -center[0], -center[1], 0], dtype=float)
    )
    T = get_transformation_matrix(translation) @ get_transformation_matrix(
        jnp.asarray(transform)
    )
    return np.asarray(get_transformation_vector(T))
