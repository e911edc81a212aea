"""Calibration uncertainty: standard errors from the Schur complement.

Beyond-reference capability (the reference offers only a median-error
heuristic, docs/source/troubleshooting.rst): at the bundle-adjustment
optimum the Gauss-Newton approximation of the parameter covariance is

    Cov(theta) ~= sigma^2 (J^T W J)^{-1}

with W the IRLS weights of the robust loss. The block structure
``lm_core.build_normal_blocks`` already produces IS J^T W J: U (camera
blocks), V (pose blocks), W (cross blocks). Eliminating the poses gives the
reduced camera system S = U - sum_f W_f V_f^{-1} W_f^T — the same Schur
complement the LM solver forms every iteration — whose inverse is the
camera-parameter covariance (marginalized over board poses, which is the
statistically correct marginal, not a conditional).

Gauge: a multi-camera rig's absolute pose is unobservable (the covariance
is exactly singular along those 6 directions), so the root camera's
extrinsics are frozen — uncertainties are *relative to the root-camera
frame*, which is also how the calibration itself is parameterized
(reference calibration.py:200-236 chains from the root).

All solves are SPD Cholesky (the normal matrices need no pivoting).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.precision import with_highest_precision
from .lm_core import (
    LMOptions,
    _blockdiag_embed,
    _diag_embed,
    _robust_weights,
    _spd_inverse,
    build_normal_blocks,
    compute_residuals,
)

__all__ = ["calibration_uncertainty"]


def _free_mask(n_cameras, root, dtype):
    cam_free = np.ones((n_cameras, 12), np.float64)
    cam_free[root, 6:] = 0.0  # gauge: root camera defines the world frame
    return jnp.asarray(cam_free, dtype)


@jax.jit
@with_highest_precision
def _uncertainty_impl(cam, poses, obs, mask, objpoints, cam_free):
    opts = LMOptions(loss="soft_l1", f_scale=1.0)
    blocks = build_normal_blocks(
        cam, poses, obs, mask, objpoints, opts, cam_free=cam_free
    )
    C = cam.shape[0]
    dtype = cam.dtype
    eps = jnp.asarray(1e-12, dtype)

    # Undamped pose-block inverses; identity-pad empty frames (their W is
    # zero so they contribute nothing to S, and their own sd comes out NaN
    # via the observation count below).
    diag_V = jnp.diagonal(blocks.V, axis1=-2, axis2=-1)
    V_pad = blocks.V + _diag_embed(eps + (diag_V <= 0).astype(dtype))
    V_inv = _spd_inverse(V_pad)  # (F, 6, 6)

    # Reduced camera system S = U - W V^-1 W^T, with identity padding on
    # frozen (gauge) columns so the Cholesky stays PD; their variance is
    # masked to zero afterwards.
    WVinv = jnp.einsum("cfij,fjk->cfik", blocks.W, V_inv)
    S_cross = jnp.einsum("afik,bfjk->aibj", WVinv, blocks.W)
    S = _blockdiag_embed(blocks.U, C) - S_cross.reshape(12 * C, 12 * C)
    free = cam_free.reshape(-1) > 0
    S = jnp.where(free[:, None] & free[None, :], S, 0.0)
    S = S + jnp.diag(jnp.where(free, eps, 1.0))
    S_inv = _spd_inverse(S)  # (12C, 12C) camera-parameter covariance / s^2
    cam_var = jnp.where(free, jnp.diagonal(S_inv), 0.0).reshape(C, 12)

    # Pose covariance diagonal: V^-1 + V^-1 W^T S^-1 W V^-1 per frame.
    Sinv_blocks = S_inv.reshape(C, 12, C, 12)
    X = jnp.transpose(WVinv, (1, 0, 2, 3))  # (F, C, 12, 6)
    cross = jnp.einsum("faio,aibj,fbjp->fop", X, Sinv_blocks, X)
    pose_cov = V_inv + cross
    pose_var = jnp.diagonal(pose_cov, axis1=-2, axis2=-1)  # (F, 6)

    # Noise scale: weighted residual variance at the optimum.
    r = compute_residuals(cam, poses, obs, mask, objpoints)
    r2 = jnp.where(mask[..., None], r**2, 0.0)
    w = jnp.where(mask[..., None], _robust_weights(r2, opts) ** 2, 0.0)
    wss = jnp.sum(w * r2)
    n_res = 2.0 * jnp.sum(mask)
    frame_obs = jnp.sum(mask, axis=(0, 2))  # (F,)
    return cam_var, pose_var, wss, n_res, frame_obs


def calibration_uncertainty(
    all_calib_uvs,
    all_extrinsics,
    all_intrinsics,
    calib_objpoints,
    calib_poses,
    root=0,
):
    """Standard errors of every calibration parameter at the BA optimum.

    Parameters mirror :func:`bundle_adjust`'s outputs: pass the *adjusted*
    extrinsics/intrinsics/poses together with the observations they were
    fit to (``all_calib_uvs`` restricted to the frames actually used).

    Returns a dict:

    - ``camera_sd`` (C, 12): standard error per camera parameter in the
      serialized layout [fx, fy, cx, cy, k1, k2, rvec(3), tvec(3)]. The
      root camera's extrinsic entries are exactly 0 (gauge definition).
    - ``pose_sd`` (F, 6): per-frame board-pose standard errors (NaN for
      frames with no observations).
    - ``sigma_px``: estimated per-component observation noise (px).
    - ``dof``: residual degrees of freedom used for ``sigma_px``.

    The covariance is the pose-marginalized Gauss-Newton approximation at
    the current parameters; it is meaningful only at (or near) a converged
    optimum.
    """
    from .bundle_adjustment import _params_to_arrays

    obs_np = np.asarray(all_calib_uvs, np.float64)
    mask = jnp.asarray(~np.isnan(obs_np).any(-1))
    obs = jnp.asarray(np.nan_to_num(obs_np))
    cam = jnp.asarray(_params_to_arrays(all_extrinsics, all_intrinsics))
    poses = jnp.asarray(np.nan_to_num(np.asarray(calib_poses, np.float64)))
    objpoints = jnp.asarray(np.asarray(calib_objpoints, np.float64))
    cam_free = _free_mask(cam.shape[0], root, cam.dtype)

    cam_var, pose_var, wss, n_res, frame_obs = _uncertainty_impl(
        cam, poses, obs, mask, objpoints, cam_free
    )
    cam_var = np.asarray(cam_var)
    pose_var = np.asarray(pose_var)
    frame_obs = np.asarray(frame_obs)

    n_free = 12 * cam.shape[0] - 6 + 6 * int((frame_obs > 0).sum())
    dof = max(float(n_res) - n_free, 1.0)
    sigma2 = float(wss) / dof
    camera_sd = np.sqrt(np.clip(cam_var, 0.0, None) * sigma2)
    pose_sd = np.sqrt(np.clip(pose_var, 0.0, None) * sigma2)
    pose_sd[frame_obs == 0] = np.nan
    return {
        "camera_sd": camera_sd,
        "pose_sd": pose_sd,
        "sigma_px": float(np.sqrt(sigma2)),
        "dof": dof,
    }
