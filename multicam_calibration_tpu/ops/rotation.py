"""SO(3) rotation ops: axis-angle <-> rotation matrix, batched and jit-safe.

JAX re-design of the reference's Rodrigues helpers
(/root/reference/multicam_calibration/geometry.py:8-65). Everything here is a
pure function over jnp arrays, differentiable, vmap-able, and safe at the
theta=0 singularity (uses Taylor-stable sinc forms instead of dividing by
theta), so the bundle-adjustment Jacobians are exact even for identity poses.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "skew",
    "rodrigues",
    "rodrigues_inv",
    "so3_exp",
    "so3_log",
    "so3_left_jacobian",
]

# Below this angle, use Taylor expansions of sin(t)/t and (1-cos(t))/t^2.
_SMALL_ANGLE = 1e-8


def skew(r):
    """Skew-symmetric (cross-product) matrix of vectors ``r`` of shape (...,3)."""
    zeros = jnp.zeros_like(r[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -r[..., 2], r[..., 1]], axis=-1),
            jnp.stack([r[..., 2], zeros, -r[..., 0]], axis=-1),
            jnp.stack([-r[..., 1], r[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(r):
    """Axis-angle vectors (...,3) -> rotation matrices (...,3,3).

    R = I + sinc(t) * K + ((1-cos t)/t^2) * K^2 with K = skew(r); the two
    coefficients are evaluated with series fallbacks near t=0 so the function
    (and its JVP, used by the analytic BA Jacobians) is smooth everywhere.
    """
    theta2 = jnp.sum(r * r, axis=-1)[..., None, None]
    small = theta2 < _SMALL_ANGLE
    # "Double-where" trick: clamp the argument of sqrt in the small-angle case
    # so the non-selected branch can't produce NaN cotangents under autodiff.
    safe_theta2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe_theta2)
    # sin(t)/t and (1 - cos(t))/t^2, series-expanded near zero.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_theta2)
    K = skew(r)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), K.shape)
    return eye + a * K + b * (K @ K)


def so3_log(R):
    """Rotation matrices (...,3,3) -> axis-angle vectors (...,3).

    Uniformly stable quaternion-based log: unlike the reference's
    arccos/trace formula (geometry.py:38-65), which silently returns the
    ZERO rotation at theta = pi (e.g. for flip_z_axis's diag(1,-1,-1)),
    this is accurate on all of SO(3) including theta -> 0 and theta -> pi.
    Branch-free (max-component quaternion extraction) so it vmaps/jits.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    # Four candidate unnormalized quaternions, each numerically best when
    # its leading component dominates (Shepperd's method).
    t_w = 1.0 + m00 + m11 + m22  # = 4 w^2
    t_x = 1.0 + m00 - m11 - m22  # = 4 x^2
    t_y = 1.0 - m00 + m11 - m22
    t_z = 1.0 - m00 - m11 + m22
    cand = jnp.stack(
        [
            jnp.stack([t_w, m21 - m12, m02 - m20, m10 - m01], axis=-1),
            jnp.stack([m21 - m12, t_x, m01 + m10, m02 + m20], axis=-1),
            jnp.stack([m02 - m20, m01 + m10, t_y, m12 + m21], axis=-1),
            jnp.stack([m10 - m01, m02 + m20, m12 + m21, t_z], axis=-1),
        ],
        axis=-2,
    )  # (..., 4 candidates, 4 components)
    ts = jnp.stack([t_w, t_x, t_y, t_z], axis=-1)
    best = jnp.argmax(ts, axis=-1)
    q = jnp.take_along_axis(cand, best[..., None, None], axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: w >= 0 (theta in [0, pi]).
    q = q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = q[..., 0]
    qv = q[..., 1:]
    n = jnp.linalg.norm(qv, axis=-1)
    # r = 2 atan2(n, w)/n * qv ; as n -> 0 the scale -> 2/w.
    small = n < 1e-8
    safe_n = jnp.where(small, 1.0, n)
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-30), 2.0 * jnp.arctan2(n, w) / safe_n)
    return qv * scale[..., None]


def so3_left_jacobian(r):
    """Left Jacobian of SO(3) for axis-angle vectors (...,3) -> (...,3,3).

    J_l(r) = I + ((1-cos t)/t^2) K + ((t-sin t)/t^3) K^2 with K = skew(r),
    satisfying exp((r+d)^) ~= exp((J_l(r) d)^) exp(r^), which gives the
    closed-form derivative of a rotated point, d(R p)/dr = -skew(R p) J_l(r)
    — the identity the analytic bundle-adjustment Jacobians are built on.
    Series-expanded near t=0 like ``so3_exp`` so it is exact and smooth at
    the identity.
    """
    theta2 = jnp.sum(r * r, axis=-1)[..., None, None]
    small = theta2 < _SMALL_ANGLE
    safe_theta2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe_theta2)
    b = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_theta2
    )
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (safe_theta2 * theta),
    )
    K = skew(r)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), K.shape)
    return eye + b * K + c * (K @ K)


# Reference-compatible aliases (multicam_calibration.geometry.rodrigues /
# rodrigues_inv, geometry.py:8,38).
rodrigues = so3_exp
rodrigues_inv = so3_log
