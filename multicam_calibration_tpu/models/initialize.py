"""Calibration initialization: intrinsics, per-frame poses, extrinsics chain.

JAX replacement for the reference's OpenCV-backed init stage
(/root/reference/multicam_calibration/calibration.py):

- ``get_intrinsics`` — replaces cv2.calibrateCamera (calibration.py:68-70):
  Zhang closed-form init (homographies -> image of the absolute conic -> K)
  followed by a per-camera LM refine of (fx, fy, cx, cy, k1, k2) + board
  poses using the same Schur LM engine as full bundle adjustment (C=1,
  extrinsics frozen at identity).
- ``estimate_pose`` — replaces the per-frame cv2.solvePnP loop
  (calibration.py:108-110): batched planar-homography pose extraction with a
  vmapped Gauss-Newton polish; all frames solved in one device program.
- ``get_camera_spanning_tree`` / ``estimate_all_extrinsics`` /
  ``consensus_calib_poses`` — same graph/median semantics as
  calibration.py:116-277 with the medians as masked JAX reductions and the
  (tiny) tree search in plain Python (no networkx dependency).
- ``calibrate`` — stage driver with the reference's exact signature/returns
  (calibration.py:280-373).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.homography import fit_homography
from ..ops.precision import with_highest_precision
from ..ops.projection import distortion_valid_r2, undistort_points
from ..ops.reductions import masked_median
from ..ops.rotation import so3_log
from ..ops.transforms import (
    get_transformation_matrix,
    get_transformation_vector,
    se3_inverse,
)
from .lm_core import LMOptions, lm_solve, project_board_points

__all__ = [
    "estimate_board_homographies",
    "intrinsics_from_homographies",
    "poses_from_homographies",
    "get_intrinsics",
    "get_intrinsics_batch",
    "estimate_pose",
    "estimate_pose_batch",
    "estimate_pairwise_camera_transform",
    "get_camera_spanning_tree",
    "estimate_all_extrinsics",
    "consensus_calib_poses",
    "calibrate",
]


def estimate_board_homographies(calib_uvs, objpoints, mask=None):
    """Batched board-plane -> image homographies, one per frame.

    ``calib_uvs``: (F, N, 2) (NaN ok); ``objpoints``: (N, 3) with z=0.
    Returns (Hs (F, 3, 3), valid (F,)).
    """
    if mask is None:
        mask = jnp.all(jnp.isfinite(calib_uvs), axis=(-1, -2))
    xy = objpoints[:, :2]
    uvs = jnp.nan_to_num(calib_uvs)
    Hs = jax.vmap(lambda uv: fit_homography(xy, uv))(uvs)
    return Hs, mask


def intrinsics_from_homographies(Hs, valid, zero_skew=True):
    """Zhang's closed-form camera matrix from >= 3 board homographies.

    Each homography contributes two linear constraints on the image of the
    absolute conic B = K^-T K^-1; K is recovered from B in closed form.
    Invalid frames are weight-0 rows (static shapes). This is the
    cv2.calibrateCamera *initialization* stage re-derived (the LM refinement
    lives in :func:`get_intrinsics`).
    """

    def v_ij(H, i, j):
        return jnp.stack(
            [
                H[0, i] * H[0, j],
                H[0, i] * H[1, j] + H[1, i] * H[0, j],
                H[1, i] * H[1, j],
                H[2, i] * H[0, j] + H[0, i] * H[2, j],
                H[2, i] * H[1, j] + H[1, i] * H[2, j],
                H[2, i] * H[2, j],
            ]
        )

    def rows(H):
        return jnp.stack([v_ij(H, 0, 1), v_ij(H, 0, 0) - v_ij(H, 1, 1)])

    A = jax.vmap(rows)(Hs)  # (F, 2, 6)
    w = valid.astype(Hs.dtype)[:, None, None]
    A = (A * w).reshape(-1, 6)
    if zero_skew:
        # Strong prior row: B12 = 0 (zero skew), scaled to the data rows.
        scale = jnp.sqrt(jnp.mean(jnp.sum(A**2, axis=-1)) + 1e-30)
        skew_row = jnp.array([0.0, 1.0, 0.0, 0.0, 0.0, 0.0], Hs.dtype) * scale
        A = jnp.concatenate([A, skew_row[None]], axis=0)
    ATA = A.T @ A
    _, vecs = jnp.linalg.eigh(ATA)
    b = vecs[:, 0]
    b = b * jnp.sign(b[0] + 1e-30)  # B11 > 0 for a valid conic
    B11, B12, B22, B13, B23, B33 = b[0], b[1], b[2], b[3], b[4], b[5]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12**2)
    lam = B33 - (B13**2 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = jnp.sqrt(jnp.abs(lam / B11))
    beta = jnp.sqrt(jnp.abs(lam * B11 / (B11 * B22 - B12**2)))
    gamma = -B12 * alpha**2 * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha**2 / lam
    K = jnp.array(
        [[alpha, gamma, u0], [0.0, beta, v0], [0.0, 0.0, 1.0]], dtype=Hs.dtype
    )
    return K


def intrinsics_from_homographies_fixed_pp(Hs, valid, image_size):
    """Focal-only closed-form init with the principal point pinned at the
    image center (cv2.initCameraMatrix2D's assumption).

    Zhang's full 5-dof IAC estimate degenerates when the sampled board
    views lack rotational diversity (near-fronto-parallel sets): the
    recovered focal can land in the half-focal/compensating-distortion
    basin that the LM refinement cannot escape. Pinning (cx, cy) and zero
    skew leaves two unknowns X=1/fx^2, Y=1/fy^2, each homography giving two
    linear constraints from the rotation-column orthogonality of
    H' = T(-center) @ H; the 2x2 normal system is far better conditioned
    under weak view diversity. Used as the alternative LM start in
    :func:`get_intrinsics` when it disagrees with the IAC estimate.
    """
    w, h = image_size
    cx = jnp.asarray(w, Hs.dtype) / 2.0
    cy = jnp.asarray(h, Hs.dtype) / 2.0
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], Hs.dtype
    ).at[0, 2].set(-cx).at[1, 2].set(-cy)
    Hc = jnp.einsum("ij,fjk->fik", T, Hs)

    def rows(H):
        a1, a2 = H[0, 0], H[0, 1]
        b1, b2 = H[1, 0], H[1, 1]
        c1, c2 = H[2, 0], H[2, 1]
        # h1^T B h2 = 0 ; h1^T B h1 - h2^T B h2 = 0, B = diag(X, Y, 1)
        A = jnp.array(
            [[a1 * a2, b1 * b2], [a1 * a1 - a2 * a2, b1 * b1 - b2 * b2]],
            H.dtype,
        )
        r = jnp.array([-c1 * c2, -(c1 * c1 - c2 * c2)], H.dtype)
        return A, r

    A, r = jax.vmap(rows)(Hc)
    wgt = valid.astype(Hs.dtype)[:, None, None]
    A = (A * wgt).reshape(-1, 2)
    r = (r * wgt[..., 0]).reshape(-1)
    # 2x2 Cramer solve (closed form; no LU for a 2x2 system).
    ATA = A.T @ A + 1e-12 * jnp.eye(2, dtype=Hs.dtype)
    Ab = A.T @ r
    det = ATA[0, 0] * ATA[1, 1] - ATA[0, 1] * ATA[1, 0]
    XY = (
        jnp.array(
            [
                ATA[1, 1] * Ab[0] - ATA[0, 1] * Ab[1],
                ATA[0, 0] * Ab[1] - ATA[1, 0] * Ab[0],
            ],
            Hs.dtype,
        )
        / det
    )
    fx = 1.0 / jnp.sqrt(jnp.clip(XY[0], 1e-12))
    fy = 1.0 / jnp.sqrt(jnp.clip(XY[1], 1e-12))
    return jnp.array(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=Hs.dtype
    )


def _intrinsics_field_valid(cam6, image_size):
    """True when a refined (fx,fy,cx,cy,k1,k2) solution is physically
    usable over its own image field.

    A planar self-calibration refine can reach a LOWER sample cost with an
    absurd compensating pair (huge focal + huge k1): the radial model then
    stops being invertible well inside the image (its distorted radius
    turns over), i.e. the "solution" cannot even represent the pixels it
    was fit to as a one-to-one camera. Gate basin selection on the radial
    model staying monotonic out to the farthest image corner
    (:func:`distortion_valid_r2`).
    """
    vals = [float(v) for v in np.asarray(cam6).reshape(-1)[:6]]
    fx, fy, cx, cy, k1, k2 = vals
    if not np.all(np.isfinite(vals)) or fx <= 0 or fy <= 0:
        return False
    w, h = float(image_size[0]), float(image_size[1])
    r2_corner = max(
        (x / fx) ** 2 for x in (cx, w - cx)
    ) + max((y / fy) ** 2 for y in (cy, h - cy))
    return distortion_valid_r2([k1, k2]) > r2_corner


def poses_from_homographies(Hs, K):
    """Planar pose extraction: H = K [r1 r2 t] (up to scale) -> (F, 6).

    Orthonormalizes [r1 r2 r1xr2] by SVD and flips the scale sign so the
    board sits in front of the camera (t_z > 0).
    """

    from jax.scipy.linalg import solve_triangular

    def one(H):
        # K is upper triangular: a triangular solve, not a general LU.
        M = solve_triangular(K, H, lower=False)
        lam = 1.0 / jnp.maximum(jnp.linalg.norm(M[:, 0]), 1e-30)
        # Board must be in front of the camera: t_z > 0 fixes the sign.
        lam = lam * jnp.sign(M[2, 2] + 1e-30)
        r1 = M[:, 0] * lam
        r2 = M[:, 1] * lam
        t = M[:, 2] * lam
        r3 = jnp.cross(r1, r2)
        R_approx = jnp.stack([r1, r2, r3], axis=1)
        U, _, Vt = jnp.linalg.svd(R_approx)
        D = jnp.diag(
            jnp.array([1.0, 1.0, jnp.linalg.det(U @ Vt)], dtype=H.dtype)
        )
        R = U @ D @ Vt
        return jnp.concatenate([so3_log(R), t])

    return jax.vmap(one)(Hs)


def _refine_poses_gn(poses, cam12, calib_uvs, mask, objpoints, n_iters=10):
    """Batched per-frame 6-dof Gauss-Newton polish (replaces solvePnP's LM).

    All frames refine concurrently under vmap; each step is a 6x6 solve.
    """

    def residual(pose6, uvs, m):
        pred = project_board_points(cam12, pose6, objpoints)
        return ((jnp.nan_to_num(uvs) - pred) * m[..., None]).reshape(-1)

    def step(pose6, uvs, m):
        # J is d(residual)/d(pose) = -d(pred)/d(pose); the GN increment is
        # -(J^T J)^{-1} J^T r (sign matters: +g would ASCEND the cost).
        r = residual(pose6, uvs, m)
        J = jax.jacfwd(residual)(pose6, uvs, m)
        H = J.T @ J + 1e-8 * jnp.eye(6, dtype=pose6.dtype)
        g = J.T @ r
        # H is SPD: Cholesky solve.
        from jax.scipy.linalg import solve_triangular as _st

        L = jnp.linalg.cholesky(H)
        y = _st(L, g[:, None], lower=True)
        return pose6 - _st(L, y, lower=True, trans=1)[:, 0]

    def refine_one(pose6, uvs, m):
        def body(_, p):
            return step(p, uvs, m)

        return jax.lax.fori_loop(0, n_iters, body, pose6)

    return jax.vmap(refine_one)(poses, calib_uvs, mask)


def _twin_planar_pose(pose6):
    """The second solution of the planar-pose ambiguity (batched, (F, 6)).

    Planar PnP has two local minima at shallow viewing angles
    (Schweighofer & Pinz): the board normal n reflects across the line of
    sight v. Construct the twin by rotating the pose so n -> 2(v.n)v - n.
    Polishing BOTH candidates and keeping the lower-residual one removes the
    tilt-flip outliers that otherwise poison extrinsics chaining and BA
    (cv2.solvePnP's iterative solver — the reference's delegate — has the
    same failure mode and no such guard).
    """
    from ..ops.rotation import so3_exp, so3_log

    R = so3_exp(pose6[..., :3])
    t = pose6[..., 3:]
    n = R[..., :, 2]  # board normal in camera frame
    v = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    dot = jnp.sum(v * n, axis=-1, keepdims=True)
    n2 = 2.0 * dot * v - n
    # Rotation taking n -> n2 (about axis n x n2).
    axis = jnp.cross(n, n2)
    sin = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    cos = jnp.clip(jnp.sum(n * n2, axis=-1, keepdims=True), -1.0, 1.0)
    angle = jnp.arctan2(sin, cos)
    axis_unit = axis / jnp.maximum(sin, 1e-12)
    r_align = jnp.where(sin > 1e-8, axis_unit * angle, jnp.zeros_like(axis))
    R_twin = so3_exp(r_align) @ R
    return jnp.concatenate([so3_log(R_twin), t], axis=-1)


@jax.jit
@with_highest_precision
def _estimate_pose_impl(calib_uvs, K, dist, objpoints):
    mask = jnp.all(jnp.isfinite(calib_uvs), axis=(-1, -2))  # (F,)
    und = undistort_points(calib_uvs, K, dist)
    Hs, _ = estimate_board_homographies(und, objpoints, mask)
    poses0 = poses_from_homographies(Hs, K)
    poses0 = jnp.where(mask[:, None], poses0, 0.0)
    cam12 = jnp.concatenate(
        [
            jnp.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
            dist[:2],
            jnp.zeros(6, dtype=calib_uvs.dtype),
        ]
    )
    point_mask = jnp.broadcast_to(mask[:, None], calib_uvs.shape[:2])
    # Polish both branches of the planar-pose ambiguity; keep the better.
    poses_a = _refine_poses_gn(poses0, cam12, calib_uvs, point_mask, objpoints)
    poses_b = _refine_poses_gn(
        _twin_planar_pose(poses_a), cam12, calib_uvs, point_mask, objpoints
    )

    def sq_err(poses):
        pred = jax.vmap(project_board_points, in_axes=(None, 0, None))(
            cam12, poses, objpoints
        )
        r = jnp.where(
            point_mask[..., None], jnp.nan_to_num(calib_uvs) - pred, 0.0
        )
        return jnp.sum(r**2, axis=(-1, -2))

    better_b = sq_err(poses_b) < sq_err(poses_a)
    poses = jnp.where(better_b[:, None], poses_b, poses_a)
    return jnp.where(mask[:, None], poses, jnp.nan)


def estimate_pose(calib_uvs, calib_objpoints, camera_matrix, dist_coeffs):
    """Board pose per frame for one camera; (F, 6) with NaN rows when unseen.

    API parity with reference ``estimate_pose`` (calibration.py:74-113); a
    frame participates only if all N corners are detected (same rule).
    Implementation: undistort -> planar homography pose -> GN polish against
    the full distorted model, batched over frames on device (one jitted
    program for all frames; compile cached across cameras).
    """
    calib_uvs = jnp.asarray(calib_uvs)
    K = jnp.asarray(camera_matrix, dtype=calib_uvs.dtype)
    dist = jnp.asarray(dist_coeffs, dtype=calib_uvs.dtype).reshape(-1)
    objpoints = jnp.asarray(calib_objpoints, dtype=calib_uvs.dtype)
    return _estimate_pose_impl(calib_uvs, K, dist, objpoints)


def get_intrinsics(
    calib_uvs,
    calib_objpoints,
    image_size,
    n_samples=100,
    fix_k3=True,
    zero_tangent_dist=True,
    seed=0,
    lm_options=None,
):
    """Per-camera intrinsics: Zhang init + Schur-LM refine.

    API parity with reference ``get_intrinsics`` (calibration.py:11-71):
    random sample of ``n_samples`` fully-detected frames, returns
    (camera_matrix (3,3), dist_coefs (5,)). The k3/tangential flags are
    accepted for parity; like the reference defaults they stay zero (the
    optimized model is k1,k2-radial — bundle_adjustment.py:187).
    """
    del fix_k3, zero_tangent_dist  # parity args; model is k1,k2-only
    calib_uvs = np.asarray(calib_uvs)
    valid = ~np.isnan(calib_uvs).any((1, 2))
    valid_ixs = np.nonzero(valid)[0]
    if len(valid_ixs) < 3:
        raise ValueError(
            f"get_intrinsics needs >= 3 fully-detected frames, got "
            f"{len(valid_ixs)} (Zhang's method requires 3+ board views)"
        )
    take = min(n_samples, len(valid_ixs))
    rng = np.random.default_rng(seed)
    sample = rng.choice(valid_ixs, take, replace=False)
    # Pad the sample to a fixed size so every camera shares one compiled
    # program (padded frames are all-masked and get zero updates).
    if take < n_samples:
        sample = np.concatenate([sample, np.full(n_samples - take, sample[0])])
    uvs = jnp.asarray(np.nan_to_num(calib_uvs[sample]))
    objpoints = jnp.asarray(calib_objpoints, dtype=uvs.dtype)
    mask_f = jnp.arange(n_samples) < take

    Hs, _ = estimate_board_homographies(uvs, objpoints, mask_f)
    K0 = intrinsics_from_homographies(Hs, mask_f)

    # Refine (fx, fy, cx, cy, k1, k2) + poses jointly with the BA engine:
    # a single-camera bundle adjustment with the camera extrinsics frozen at
    # identity (gauge: board poses absorb all motion).
    cam_free = jnp.concatenate([jnp.ones(6), jnp.zeros(6)])[None]
    obs = uvs[None]
    point_mask = jnp.broadcast_to(mask_f[None, :, None], obs.shape[:3])
    opts = lm_options or LMOptions(max_iters=60, ftol=1e-6, loss="linear")

    def refine(K_init):
        cam0 = jnp.concatenate(
            [
                jnp.stack(
                    [K_init[0, 0], K_init[1, 1], K_init[0, 2], K_init[1, 2]]
                ),
                jnp.zeros(8, dtype=uvs.dtype),
            ]
        )[None]
        poses0 = poses_from_homographies(Hs, K_init)
        cam_ref, _, info = lm_solve(
            cam0, poses0, obs, point_mask, objpoints, opts, cam_free=cam_free
        )
        return cam_ref, float(info["final_cost"])

    cam_ref, cost = refine(K0)

    # Basin guard: Zhang's 5-dof IAC estimate degenerates under weak view
    # diversity and can start the LM in the half-focal/compensating-
    # distortion basin it cannot leave. When the fixed-principal-point
    # focal estimate materially disagrees with the IAC one, refine from it
    # too and keep the lower-cost solution (one extra solve of an
    # already-compiled program, and only for cameras whose inits disagree).
    K0_pp = intrinsics_from_homographies_fixed_pp(Hs, mask_f, image_size)
    f_ratio = jnp.maximum(K0[0, 0] / K0_pp[0, 0], K0_pp[0, 0] / K0[0, 0])
    pp_off = jnp.hypot(
        K0[0, 2] - K0_pp[0, 2], K0[1, 2] - K0_pp[1, 2]
    ) / float(np.hypot(*image_size))
    if bool(jnp.isfinite(K0_pp[0, 0])) and (
        not bool(jnp.isfinite(K0[0, 0]))
        or float(f_ratio) > 1.15
        or float(pp_off) > 0.08
    ):
        cam_alt, cost_alt = refine(K0_pp)
        # Prefer by (field-valid, cost): a lower-cost solution whose radial
        # model is not invertible over its own image field is a degenerate
        # compensating-distortion fit, not a better basin.
        pri_ok = np.isfinite(cost) and _intrinsics_field_valid(
            cam_ref[0], image_size
        )
        alt_ok = np.isfinite(cost_alt) and _intrinsics_field_valid(
            cam_alt[0], image_size
        )
        # Switch only to a VALID alt (lower cost, or primary invalid).
        # When both basins are degenerate, keep the Zhang primary — the
        # downstream spanning-tree/consensus/BA stages are what recover
        # from a bad single-camera init, and the primary is the
        # reference-parity default.
        if alt_ok and (not pri_ok or cost_alt < cost):
            cam_ref, cost = cam_alt, cost_alt

    fx, fy, cx, cy, k1, k2 = (float(cam_ref[0, i]) for i in range(6))
    camera_matrix = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    dist_coefs = np.array([k1, k2, 0.0, 0.0, 0.0])
    return camera_matrix, dist_coefs


@jax.jit
@with_highest_precision
def _batched_zhang_init(uvs_s, mask_f, objpoints, image_sizes):
    """Homographies + both closed-form K estimates for ALL cameras at once."""
    Hs, _ = jax.vmap(estimate_board_homographies, in_axes=(0, None, 0))(
        uvs_s, objpoints, mask_f
    )
    K0 = jax.vmap(intrinsics_from_homographies)(Hs, mask_f)
    K0_pp = jax.vmap(intrinsics_from_homographies_fixed_pp)(
        Hs, mask_f, image_sizes
    )
    return Hs, K0, K0_pp


@functools.partial(jax.jit, static_argnames=("opts",))
@with_highest_precision
def _batched_intrinsics_refine(K_inits, Hs, uvs_s, mask_f, objpoints, opts):
    """vmap the single-camera Schur-LM intrinsics refine over cameras.

    One lockstep ``lax.while_loop`` for the whole rig (iterations = the
    slowest camera's count) instead of C sequential solves — also C
    dispatches -> 1.
    """

    def one(K_init, Hs_c, uvs_c, mask_c):
        cam0 = jnp.concatenate(
            [
                jnp.stack(
                    [K_init[0, 0], K_init[1, 1], K_init[0, 2], K_init[1, 2]]
                ),
                jnp.zeros(8, dtype=uvs_c.dtype),
            ]
        )[None]
        poses0 = poses_from_homographies(Hs_c, K_init)
        obs = uvs_c[None]
        point_mask = jnp.broadcast_to(mask_c[None, :, None], obs.shape[:3])
        cam_free = jnp.concatenate(
            [jnp.ones(6, obs.dtype), jnp.zeros(6, obs.dtype)]
        )[None]
        cam_ref, _, info = lm_solve(
            cam0, poses0, obs, point_mask, objpoints, opts, cam_free=cam_free
        )
        return cam_ref[0], info["final_cost"]

    return jax.vmap(one)(K_inits, Hs, uvs_s, mask_f)


def get_intrinsics_batch(
    all_calib_uvs,
    calib_objpoints,
    img_sizes,
    n_samples=100,
    seed=0,
    lm_options=None,
):
    """All cameras' intrinsics in two batched device programs.

    Same per-camera semantics as :func:`get_intrinsics` (same sampling rng,
    same Zhang init, same LM refine, same basin guard) but vmapped over the
    camera axis: one Zhang-init program and one (occasionally two) batched
    LM solves for the whole rig. Returns a list of
    (camera_matrix (3,3), dist_coefs (5,)) pairs.
    """
    all_calib_uvs = np.asarray(all_calib_uvs)
    n_cameras = all_calib_uvs.shape[0]
    samples, takes = [], []
    for c in range(n_cameras):
        valid_ixs = np.nonzero(~np.isnan(all_calib_uvs[c]).any((1, 2)))[0]
        if len(valid_ixs) < 3:
            raise ValueError(
                f"get_intrinsics needs >= 3 fully-detected frames, got "
                f"{len(valid_ixs)} for camera {c} (Zhang's method requires "
                f"3+ board views)"
            )
        take = min(n_samples, len(valid_ixs))
        rng = np.random.default_rng(seed)
        s = rng.choice(valid_ixs, take, replace=False)
        if take < n_samples:
            s = np.concatenate([s, np.full(n_samples - take, s[0])])
        samples.append(s)
        takes.append(take)
    uvs_s = jnp.asarray(
        np.nan_to_num(
            np.stack([all_calib_uvs[c, samples[c]] for c in range(n_cameras)])
        )
    )
    mask_f = jnp.arange(n_samples)[None, :] < jnp.asarray(takes)[:, None]
    objpoints = jnp.asarray(calib_objpoints, dtype=uvs_s.dtype)
    sizes_np = np.asarray(img_sizes, dtype=float)
    opts = lm_options or LMOptions(max_iters=60, ftol=1e-6, loss="linear")

    Hs, K0, K0_pp = _batched_zhang_init(
        uvs_s, mask_f, objpoints, jnp.asarray(sizes_np, dtype=uvs_s.dtype)
    )
    cam_ref, cost = _batched_intrinsics_refine(
        K0, Hs, uvs_s, mask_f, objpoints, opts
    )
    cam_ref, cost = np.array(cam_ref), np.array(cost)  # writable host copies

    # Basin guard, per camera (same thresholds as get_intrinsics).
    K0n, K0pn = np.asarray(K0), np.asarray(K0_pp)
    f0, fp = K0n[:, 0, 0], K0pn[:, 0, 0]
    with np.errstate(all="ignore"):
        f_ratio = np.maximum(f0 / fp, fp / f0)
        pp_off = np.hypot(
            K0n[:, 0, 2] - K0pn[:, 0, 2], K0n[:, 1, 2] - K0pn[:, 1, 2]
        ) / np.hypot(sizes_np[:, 0], sizes_np[:, 1])
    flagged = np.isfinite(fp) & (
        ~np.isfinite(f0) | (f_ratio > 1.15) | (pp_off > 0.08)
    )
    if flagged.any():
        cam_alt, cost_alt = _batched_intrinsics_refine(
            K0_pp, Hs, uvs_s, mask_f, objpoints, opts
        )
        cam_alt, cost_alt = np.asarray(cam_alt), np.asarray(cost_alt)
        # Same (field-valid, cost) preference as get_intrinsics.
        pri_ok = np.array(
            [
                np.isfinite(cost[c])
                and _intrinsics_field_valid(cam_ref[c], sizes_np[c])
                for c in range(n_cameras)
            ]
        )
        alt_ok = np.array(
            [
                np.isfinite(cost_alt[c])
                and _intrinsics_field_valid(cam_alt[c], sizes_np[c])
                for c in range(n_cameras)
            ]
        )
        with np.errstate(all="ignore"):
            sel = flagged & alt_ok & (~pri_ok | (cost_alt < cost))
        cam_ref[sel] = cam_alt[sel]

    out = []
    for c in range(n_cameras):
        fx, fy, cx, cy, k1, k2 = cam_ref[c, :6]
        out.append(
            (
                np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]),
                np.array([k1, k2, 0.0, 0.0, 0.0]),
            )
        )
    return out


def estimate_pose_batch(
    all_calib_uvs, calib_objpoints, all_camera_matrices, all_dist_coeffs
):
    """Board poses for ALL cameras in one device program; (C, F, 6).

    vmap of the single-camera pipeline (:func:`estimate_pose`) over the
    camera axis — identical per-camera results, one dispatch.
    """
    uvs = jnp.asarray(all_calib_uvs)
    Ks = jnp.asarray(np.stack(all_camera_matrices), dtype=uvs.dtype)
    dists = jnp.asarray(np.stack(all_dist_coeffs), dtype=uvs.dtype)
    objpoints = jnp.asarray(calib_objpoints, dtype=uvs.dtype)
    return jax.vmap(_estimate_pose_impl, in_axes=(0, 0, 0, None))(
        uvs, Ks, dists, objpoints
    )


def estimate_pairwise_camera_transform(camera1_poses, camera2_poses):
    """Median relative transform cam1 -> cam2 over co-observed frames.

    Parity with calibration.py:116-143: per-frame T2 @ T1^-1, element-wise
    median of the 6-vectors (masked median; static shapes).
    """
    p1 = jnp.asarray(camera1_poses)
    p2 = jnp.asarray(camera2_poses)
    common = jnp.all(jnp.isfinite(p1), -1) & jnp.all(jnp.isfinite(p2), -1)
    T1 = get_transformation_matrix(jnp.nan_to_num(p1))
    T2 = get_transformation_matrix(jnp.nan_to_num(p2))
    T_rel = T2 @ se3_inverse(T1)
    t_rel = get_transformation_vector(T_rel)  # (F, 6)
    return masked_median(t_rel, common[:, None], axis=0)


def get_camera_spanning_tree(all_calib_poses, root=0):
    """Maximum spanning tree over shared-detection counts (host-side).

    Parity with calibration.py:146-197 (which delegates to networkx): edges
    are weighted by co-detection counts, the max spanning tree is found by
    Prim's algorithm, and edges are returned (parent, child) in BFS order
    from ``root``. The graph has n_cameras nodes — trivially host-sized.
    """
    poses = np.asarray(all_calib_poses)
    detected = ~np.isnan(poses).any(-1)  # (C, F)
    n = detected.shape[0]
    weights = (detected[:, None] & detected[None, :]).sum(-1)
    in_tree = {root}
    edges = []
    adj = {i: [] for i in range(n)}
    while len(in_tree) < n:
        best = None
        for i in sorted(in_tree):
            for j in range(n):
                if j in in_tree:
                    continue
                if best is None or weights[i, j] > best[2]:
                    best = (i, j, weights[i, j])
        i, j, _ = best
        in_tree.add(j)
        adj[i].append(j)
        edges.append((i, j))
    # BFS order from root, parent-first (matches the reference's sort by
    # root distance with nearer node first in each tuple).
    order = []
    queue = [root]
    while queue:
        u = queue.pop(0)
        for v in adj[u]:
            order.append((u, v))
            queue.append(v)
    return order


def estimate_all_extrinsics(all_calib_poses, root=0):
    """Chain pairwise medians along the spanning tree; root = identity.

    Parity with calibration.py:200-236. Returns ((C, 6) extrinsics, tree).
    """
    poses = np.asarray(all_calib_poses)
    n = poses.shape[0]
    tree = get_camera_spanning_tree(poses, root=root)
    T = [None] * n
    T[root] = np.eye(4)
    for c1, c2 in tree:
        t_rel = estimate_pairwise_camera_transform(poses[c1], poses[c2])
        T[c2] = np.asarray(get_transformation_matrix(t_rel)) @ T[c1]
    all_extrinsics = np.stack(
        [np.asarray(get_transformation_vector(jnp.asarray(t))) for t in T]
    )
    return all_extrinsics, tree


def consensus_calib_poses(all_calib_poses, all_extrinsics):
    """Median world-frame board pose across cameras, per frame.

    Parity with calibration.py:239-277: T_board2world = T_world2cam^-1 @
    T_board2cam per camera, element-wise nanmedian of 6-vectors across
    cameras (masked median here).
    """
    poses = jnp.asarray(all_calib_poses)  # (C, F, 6)
    ext = jnp.asarray(all_extrinsics)  # (C, 6)
    detected = jnp.all(jnp.isfinite(poses), -1)  # (C, F)
    T_b2c = get_transformation_matrix(jnp.nan_to_num(poses))
    T_w2c_inv = se3_inverse(get_transformation_matrix(ext))[:, None]
    t_b2w = get_transformation_vector(T_w2c_inv @ T_b2c)  # (C, F, 6)
    return masked_median(t_b2w, detected[..., None], axis=0)


@jax.jit
@with_highest_precision
def _median_reproj_err_jit(calib_uvs, poses, cam12, objpoints):
    pred = jax.vmap(project_board_points, in_axes=(None, 0, None))(
        cam12, poses, objpoints
    )
    err = jnp.linalg.norm(calib_uvs - pred, axis=-1)
    ok = jnp.all(jnp.isfinite(poses), axis=-1)[:, None] & jnp.all(
        jnp.isfinite(calib_uvs), axis=-1
    )
    return masked_median(err.reshape(-1), ok.reshape(-1), axis=0)


def _median_reproj_err(calib_uvs, poses, K, dist, objpoints):
    """Median per-observation reprojection error (px) for one camera,
    over the frames its PnP produced a pose for (NaN uvs/poses masked)."""
    uvs = jnp.asarray(np.asarray(calib_uvs, dtype=float))
    dist = np.asarray(dist, dtype=float).reshape(-1)
    cam12 = jnp.asarray(
        np.concatenate(
            [[K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dist[:2], np.zeros(6)]
        ),
        dtype=uvs.dtype,
    )
    return float(
        _median_reproj_err_jit(
            uvs,
            jnp.asarray(np.asarray(poses, dtype=float)),
            cam12,
            jnp.asarray(objpoints, dtype=uvs.dtype),
        )
    )


def _compose_cam_poses(extrinsic6, consensus_poses):
    """Board->camera pose per frame: T(ext_c) @ T(consensus_f), (F, 6).

    Frames without a consensus pose come out NaN (masked downstream).
    """
    cp = jnp.asarray(np.asarray(consensus_poses, dtype=float))
    ok = jnp.all(jnp.isfinite(cp), axis=-1)
    T = get_transformation_matrix(
        jnp.asarray(np.asarray(extrinsic6, dtype=float))
    ) @ get_transformation_matrix(jnp.nan_to_num(cp))
    out = get_transformation_vector(T)
    return jnp.where(ok[:, None], out, jnp.nan)


def _rig_consistent_err(calib_uvs, extrinsic6, K, dist, consensus_poses,
                        objpoints):
    """Median reprojection error (px) of one camera against the RIG's
    consensus board poses — the metric that exposes compensating
    single-camera fits (which look perfect under their own free per-frame
    poses: the pose absorbs the focal error via the depth-scale
    ambiguity, but cannot absorb it once the pose is pinned by peers)."""
    poses = _compose_cam_poses(extrinsic6, consensus_poses)
    return _median_reproj_err(calib_uvs, poses, K, dist, objpoints)


def _repair_bad_intrinsics(
    all_calib_uvs,
    img_sizes,
    calib_objpoints,
    all_intrinsics,
    all_calib_poses,
    all_extrinsics,
    consensus_poses,
    n_samples,
    verbose,
):
    """Peer-relative init repair (in-place on intrinsics/poses lists).

    Zhang + LM on one frame sample occasionally lands a single camera in a
    compensating-distortion basin that is FIELD-VALID (invertible radial,
    so the basin guard keeps it) and self-consistent under its own PnP
    poses — yet wildly wrong against the rig (measured on a 64-cam rig:
    one camera at 16 px median error vs 1 px peers under the consensus
    poses, which then poisons 70% of frames via select_ba_frames'
    worst-camera rule). Flag cameras whose RIG-CONSISTENT median error is
    an outlier against the rig median, refit them from fresh frame
    samples, and keep a candidate only if it measurably improves that
    camera under the same consensus poses. Returns True if anything
    changed (caller re-runs the extrinsics tree + consensus).
    Needs >= 4 cameras for a meaningful peer baseline.
    """
    n_cameras = len(all_intrinsics)
    if n_cameras < 4:
        return False
    errs = np.array(
        [
            _rig_consistent_err(
                all_calib_uvs[c], all_extrinsics[c], all_intrinsics[c][0],
                all_intrinsics[c][1], consensus_poses, calib_objpoints,
            )
            for c in range(n_cameras)
        ]
    )
    peer = float(np.nanmedian(errs))
    thresh = max(3.0 * peer, 2.0)
    bad = ~np.isfinite(errs) | (errs > thresh)
    changed = False
    for c in np.nonzero(bad)[0]:
        best_err = errs[c]
        for seed, ns in ((9973, n_samples), (31337, 2 * n_samples)):
            try:
                cand = get_intrinsics(
                    all_calib_uvs[c], calib_objpoints, img_sizes[c],
                    n_samples=ns, seed=seed,
                )
            except ValueError:
                break  # too few fully-detected frames to resample
            poses_c = np.asarray(
                estimate_pose(all_calib_uvs[c], calib_objpoints, *cand)
            )
            # Re-anchor the camera to the rig: its extrinsic from the
            # median relative transform vs the consensus (world) poses.
            ext_c = np.asarray(
                estimate_pairwise_camera_transform(consensus_poses, poses_c)
            )
            e = _rig_consistent_err(
                all_calib_uvs[c], ext_c, cand[0], cand[1], consensus_poses,
                calib_objpoints,
            )
            if np.isfinite(e) and e < best_err:
                all_intrinsics[c] = cand
                all_calib_poses[c] = poses_c
                best_err = e
                changed = True
            if best_err <= thresh:
                break
        if verbose:
            print(
                f"  repaired camera {c}: rig-consistent median error "
                f"{errs[c]:.2f} -> {best_err:.2f} px (rig median {peer:.2f})"
            )
    return changed


def calibrate(
    all_calib_uvs,
    img_sizes,
    calib_objpoints,
    root=0,
    verbose=True,
    n_samples_for_intrinsics=100,
):
    """Full initialization pipeline; reference-parity signature and returns
    (calibration.py:280-373): (all_extrinsics, all_intrinsics,
    consensus poses, spanning_tree).
    """
    from ..utils.metrics import metrics

    n_cameras = len(all_calib_uvs)
    # Uniform (C, F, N, 2) detections may take the camera-batched device
    # paths (one program for the rig per stage); the batched LM runs
    # lockstep (every camera pays the slowest camera's iteration count), so
    # which is faster depends on the backend (backend.init_camera_batched).
    # Ragged per-camera inputs always take the sequential loop.
    from .. import backend

    try:
        uvs_arr = np.asarray(all_calib_uvs, dtype=float)
        batched = uvs_arr.ndim == 4 and backend.init_camera_batched(
            backend.platform()
        )
    except ValueError:  # pragma: no cover - ragged input
        batched = False
    if verbose:
        print("Estimating camera intrinsics")
    with metrics.timer("calibrate.intrinsics", n_cameras=n_cameras):
        if batched:
            all_intrinsics = get_intrinsics_batch(
                uvs_arr,
                calib_objpoints,
                img_sizes,
                n_samples=n_samples_for_intrinsics,
            )
        else:
            all_intrinsics = [
                get_intrinsics(
                    all_calib_uvs[c],
                    calib_objpoints,
                    img_sizes[c],
                    n_samples=n_samples_for_intrinsics,
                )
                for c in range(n_cameras)
            ]
    if verbose:
        print("Initializing calibration object poses")
    with metrics.timer("calibrate.poses"):
        if batched:
            # np.array (copy), NOT np.asarray: asarray of a JAX array is a
            # READ-ONLY view, and _repair_bad_intrinsics mutates rows in
            # place (crashed on rigs with a repairable camera).
            all_calib_poses = np.array(
                estimate_pose_batch(
                    uvs_arr,
                    calib_objpoints,
                    [k for k, _ in all_intrinsics],
                    [d for _, d in all_intrinsics],
                )
            )
        else:
            all_calib_poses = np.stack(
                [
                    np.asarray(
                        estimate_pose(
                            all_calib_uvs[c], calib_objpoints, *all_intrinsics[c]
                        )
                    )
                    for c in range(n_cameras)
                ]
            )
    if verbose:
        print("Estimating camera extrinsics")
    with metrics.timer("calibrate.extrinsics"):
        all_extrinsics, spanning_tree = estimate_all_extrinsics(
            all_calib_poses, root=root
        )
    if verbose:
        print("Merging calibration object poses")
    with metrics.timer("calibrate.consensus"):
        calib_poses = np.asarray(
            consensus_calib_poses(all_calib_poses, all_extrinsics)
        )
    # Rig-consistency check + single-camera init repair (needs the
    # consensus poses — a compensating fit is invisible under its own
    # free poses). On repair, re-anchor the tree and consensus once.
    with metrics.timer("calibrate.repair"):
        all_intrinsics = list(all_intrinsics)
        if _repair_bad_intrinsics(
            all_calib_uvs, img_sizes, calib_objpoints, all_intrinsics,
            all_calib_poses, all_extrinsics, calib_poses,
            n_samples_for_intrinsics, verbose,
        ):
            all_extrinsics, spanning_tree = estimate_all_extrinsics(
                all_calib_poses, root=root
            )
            calib_poses = np.asarray(
                consensus_calib_poses(all_calib_poses, all_extrinsics)
            )
    return all_extrinsics, all_intrinsics, calib_poses, spanning_tree
