"""Bundle adjustment: reference-parity API over the Schur LM engine.

Drop-in capability match for /root/reference/multicam_calibration/
bundle_adjustment.py — same parameter layout, same outlier/frame-selection
semantics, same return structure — with the scipy TRF solver replaced by the
jitted Schur-complement LM in :mod:`.lm_core` (and optional frame sharding
over a device mesh via :mod:`..parallel`).
"""
from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

from ..ops.projection import project_points
from ..ops.transforms import (
    euclidean_to_homogenous,
    get_transformation_matrix,
)
from .lm_core import LMOptions, lm_solve

__all__ = [
    "embed_calib_objpoints",
    "predict_calib_uvs",
    "residuals",
    "bundle_adjustment_sparsity",
    "serialize_params",
    "deserialize_params",
    "bundle_adjust",
]


def embed_calib_objpoints(calib_objpoints, calib_poses):
    """Board canonical points -> world coords per frame: (F, N, 3).

    Parity: bundle_adjustment.py:10-30.
    """
    T = get_transformation_matrix(jnp.asarray(calib_poses))[:, None]
    pts = euclidean_to_homogenous(jnp.asarray(calib_objpoints))[None, :, :, None]
    return (T @ pts)[..., :3, 0]


def predict_calib_uvs(all_extrinsics, all_intrinsics, calib_objpoints, calib_poses):
    """Forward model for every camera: (C, F, N, 2).

    Parity: bundle_adjustment.py:33-63.
    """
    pts = embed_calib_objpoints(calib_objpoints, calib_poses)
    preds = [
        project_points(
            pts, jnp.asarray(all_extrinsics[i]),
            jnp.asarray(all_intrinsics[i][0]), jnp.asarray(all_intrinsics[i][1]),
        )
        for i in range(len(all_extrinsics))
    ]
    return jnp.stack(preds)


def residuals(params, all_calib_uvs, calib_objpoints):
    """Flat masked residual vector (obs - pred)[~isnan(obs)].

    Parity: bundle_adjustment.py:66-98 (useful for cross-checking our cost
    against scipy on the same parameter vector).
    """
    all_calib_uvs = np.asarray(all_calib_uvs)
    ext, intr, poses = deserialize_params(params, all_calib_uvs.shape[0])
    pred = np.asarray(predict_calib_uvs(ext, intr, calib_objpoints, poses))
    return (all_calib_uvs - pred)[~np.isnan(all_calib_uvs)]


def bundle_adjustment_sparsity(all_calib_uvs):
    """Jacobian sparsity pattern (scipy.sparse), for interop/debugging.

    Parity: bundle_adjustment.py:101-125. The Schur solver never materializes
    this matrix — it exists so reference-style workflows (e.g. handing the
    problem to scipy for cross-validation) keep working.
    """
    from scipy.sparse import lil_matrix

    n_cameras, n_frames, N, _ = all_calib_uvs.shape
    n_params = n_cameras * 12 + n_frames * 6
    mask = ~np.isnan(all_calib_uvs)
    cam_ixs = np.broadcast_to(
        np.arange(n_cameras)[:, None, None, None], all_calib_uvs.shape
    )[mask]
    frame_ixs = np.broadcast_to(
        np.arange(n_frames)[None, :, None, None], all_calib_uvs.shape
    )[mask]
    A = lil_matrix((int(mask.sum()), n_params), dtype=int)
    i = np.arange(int(mask.sum()))
    for s in range(12):
        A[i, cam_ixs * 12 + s] = 1
    for s in range(6):
        A[i, n_cameras * 12 + frame_ixs * 6 + s] = 1
    return A


def serialize_params(all_extrinsics, all_intrinsics, calib_poses):
    """Flatten to the reference layout: per camera
    [fx, fy, cx, cy, k1, k2, rx, ry, rz, tx, ty, tz], then F x 6 poses
    (bundle_adjustment.py:128-157)."""
    x0 = []
    for transform, (camera_matrix, dist_coefs) in zip(all_extrinsics, all_intrinsics):
        K = np.asarray(camera_matrix)
        x0.append(
            np.concatenate(
                [
                    [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                    np.asarray(dist_coefs).reshape(-1)[:2],
                    np.asarray(transform).reshape(-1),
                ]
            )
        )
    x0.append(np.asarray(calib_poses).reshape(-1))
    return np.concatenate(x0)


def deserialize_params(x, n_cameras):
    """Inverse of :func:`serialize_params` (bundle_adjustment.py:160-192);
    dist coefs are zero-padded to 5 (k1, k2 only are optimized)."""
    x = np.asarray(x)
    all_extrinsics, all_intrinsics = [], []
    for i in range(n_cameras):
        fx, fy, cx, cy = x[i * 12 : i * 12 + 4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        dist = np.pad(x[i * 12 + 4 : i * 12 + 6], (0, 3))
        all_extrinsics.append(x[i * 12 + 6 : i * 12 + 12])
        all_intrinsics.append((K, dist))
    calib_poses = x[n_cameras * 12 :].reshape(-1, 6)
    return np.array(all_extrinsics), all_intrinsics, calib_poses


def _params_to_arrays(all_extrinsics, all_intrinsics):
    """(C, 12) cam-param matrix in the reference layout."""
    rows = []
    for ext, (K, dist) in zip(all_extrinsics, all_intrinsics):
        K = np.asarray(K)
        rows.append(
            np.concatenate(
                [
                    [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                    np.asarray(dist).reshape(-1)[:2],
                    np.asarray(ext).reshape(-1),
                ]
            )
        )
    return np.stack(rows)


def _arrays_to_params(cam):
    cam = np.asarray(cam)
    all_extrinsics = cam[:, 6:12]
    all_intrinsics = []
    for row in cam:
        K = np.array([[row[0], 0, row[2]], [0, row[1], row[3]], [0, 0, 1.0]])
        all_intrinsics.append((K, np.array([row[4], row[5], 0.0, 0.0, 0.0])))
    return all_extrinsics, all_intrinsics


def select_ba_frames(
    all_calib_uvs,
    all_extrinsics,
    all_intrinsics,
    calib_objpoints,
    calib_poses,
    n_frames=10000,
    outlier_threshold=None,
    seed=0,
    verbose=True,
):
    """Frame selection for BA: >=2-camera frames minus outliers, subsampled.

    Exactly the reference's rules (bundle_adjustment.py:266-296): frames
    fully detected by >= 2 cameras; drop frames whose worst per-camera mean
    reprojection error exceeds ``outlier_threshold`` (default 5 x median
    error at the initial parameters); random-subsample to ``n_frames``.
    Shared by bundle_adjust and the benchmark harness so both solvers see
    identical problems.
    """
    import warnings

    all_calib_uvs = np.asarray(all_calib_uvs)
    full = ~np.isnan(all_calib_uvs).any((-1, -2))
    use_frames = np.nonzero(full.sum(0) > 1)[0]
    pred = np.asarray(
        predict_calib_uvs(
            all_extrinsics, all_intrinsics, calib_objpoints,
            np.asarray(calib_poses)[use_frames],
        )
    )
    err = np.linalg.norm(all_calib_uvs[:, use_frames] - pred, axis=-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        worst_mean_err = np.nanmax(np.nanmean(err, axis=-1), axis=0)
        if outlier_threshold is None:
            outlier_threshold = 5 * np.nanmedian(err)
    exclude = np.nan_to_num(worst_mean_err) > outlier_threshold
    use_frames = use_frames[~exclude]
    if verbose:
        print(
            f"Excluding {int(exclude.sum())} out of {len(use_frames)} frames "
            f"based on an outlier threshold of {outlier_threshold}"
        )
    if n_frames is not None and n_frames < len(use_frames):
        rng = np.random.default_rng(seed)
        use_frames = np.sort(rng.choice(use_frames, n_frames, replace=False))
    return use_frames


import jax as _jax
from .lm_core import compute_cost as _compute_cost
from .lm_core import compute_residuals as _compute_residuals

from ..ops.precision import with_highest_precision as _highest

_jit_residuals = _jax.jit(_highest(_compute_residuals))
_jit_cost = _jax.jit(
    _highest(_compute_cost), static_argnames=("opts", "axis_name")
)


def _emit_lm_history(info, verbose):
    """Per-iteration optimizer telemetry (scipy verbose=2 parity).

    The reference surfaces cost/step/optimality per TRF iteration on stdout
    (bundle_adjustment.py:302 verbose=2); here the trace is recorded inside
    the XLA program (lm_core.LMState.hist), logged as JSONL metrics events,
    and printed as a table when ``verbose``.
    """
    from ..utils.metrics import metrics
    from .lm_core import HIST_FIELDS

    hist = info.get("history")
    if hist is None:
        return
    hist = np.asarray(hist)
    n = min(int(info["n_iters"]), hist.shape[0])
    for i in range(n):
        metrics.log(
            "ba_lm_iter",
            it=i,
            **{k: float(v) for k, v in zip(HIST_FIELDS, hist[i])},
        )
    if verbose and n:
        print(
            f"{'iter':>5} {'cost':>14} {'grad_norm':>11} {'step_norm':>11} "
            f"{'lambda':>9} {'tries':>5}"
        )
        for i in range(n):
            c, g, s, lam, t, _ = hist[i]
            print(
                f"{i:>5} {c:>14.6e} {g:>11.3e} {s:>11.3e} {lam:>9.2e} "
                f"{int(t):>5}"
            )


def _ba_fingerprint(all_calib_uvs, seed, n_frames, outlier_threshold):
    """Content hash identifying a BA problem for checkpoint validation.

    Covers the detection data plus every option that shapes the frame
    selection, so a checkpoint written for one problem cannot silently
    resume a same-shaped different one.
    """
    import hashlib

    h = hashlib.sha1()
    arr = np.ascontiguousarray(np.asarray(all_calib_uvs, dtype=np.float64))
    h.update(arr.tobytes())
    h.update(repr((seed, n_frames, outlier_threshold)).encode())
    return h.hexdigest()


def _repair_bad_poses(cam, poses, obs, mask, objpoints, opts, threshold=5.0):
    """Re-solve frame poses the robust LM left in a bad basin.

    soft-L1 bounds a haywire frame's *cost* contribution, so the optimizer
    can converge with one pose producing ~1000 px errors that an unrobust
    RMSE exposes. Post-pass: flag frames whose mean reprojection error
    exceeds ``threshold`` x median, re-initialize their poses from per-camera
    planar PnP + consensus at the *refined* cameras, then polish ONLY those
    poses (cameras and healthy poses frozen — same compiled LM program).

    Returns (poses, n_repaired).
    """
    from .initialize import consensus_calib_poses, estimate_pose
    from .lm_core import lm_solve

    import jax.numpy as jnp_

    r = np.asarray(_jit_residuals(cam, poses, obs, mask, objpoints))
    err = np.linalg.norm(r, axis=-1)  # (C, F, N)
    mask_np = np.asarray(mask)
    with np.errstate(invalid="ignore"):
        frame_err = np.where(mask_np, err, np.nan)
        per_frame = np.nanmean(frame_err, axis=(0, 2))  # (F,)
    med = np.nanmedian(per_frame)
    bad = np.nan_to_num(per_frame, nan=0.0) > threshold * med
    if not bad.any():
        return poses, 0

    # Fresh PnP init for the bad frames at the refined camera parameters.
    ext, intr = _arrays_to_params(np.asarray(cam, np.float64))
    obs_np = np.asarray(obs, np.float64)
    obs_nan = np.where(mask_np[..., None], obs_np, np.nan)
    bad_ix = np.nonzero(bad)[0]
    all_poses = np.stack(
        [
            np.asarray(
                estimate_pose(obs_nan[c][bad_ix], np.asarray(objpoints), *intr[c])
            )
            for c in range(len(ext))
        ]
    )
    reinit = np.asarray(consensus_calib_poses(all_poses, ext))
    poses_np = np.asarray(poses).copy()
    ok = ~np.isnan(reinit).any(-1)
    poses_np[bad_ix[ok]] = reinit[ok]

    pose_free = np.zeros((poses_np.shape[0], 6), np.float32)
    pose_free[bad_ix] = 1.0
    cam_free = np.zeros((np.asarray(cam).shape[0], 12), np.float32)
    dtype = jnp_.asarray(poses).dtype
    _, poses2, _ = lm_solve(
        jnp_.asarray(cam),
        jnp_.asarray(np.nan_to_num(poses_np), dtype),
        obs,
        mask,
        objpoints,
        opts,
        cam_free=jnp_.asarray(cam_free, dtype),
        pose_free=jnp_.asarray(pose_free, dtype),
    )
    # Per-frame acceptance: a repaired pose replaces the original only when
    # it actually reduces that frame's error (the repair can never regress).
    r2 = np.asarray(_jit_residuals(cam, poses2, obs, mask, objpoints))
    err2 = np.linalg.norm(r2, axis=-1)
    with np.errstate(invalid="ignore"):
        per_frame2 = np.nanmean(np.where(mask_np, err2, np.nan), axis=(0, 2))
    improved = bad & (np.nan_to_num(per_frame2, nan=np.inf) < per_frame)
    poses_out = np.asarray(poses).copy()
    poses_out[improved] = np.asarray(poses2)[improved]
    return jnp_.asarray(poses_out, dtype), int(improved.sum())


def bundle_adjust(
    all_calib_uvs,
    all_extrinsics,
    all_intrinsics,
    calib_objpoints,
    calib_poses,
    n_frames=10000,
    outlier_threshold=None,
    dtype=None,
    lm_options=None,
    mesh=None,
    seed=0,
    verbose=True,
    checkpoint_path=None,
    checkpoint_every=None,
    repair_poses=True,
    **opt_kwargs,
):
    """Joint refinement of camera params + board poses (reference parity API).

    Semantics match bundle_adjustment.py:195-327: frames observed by >= 2
    cameras; frames whose worst per-camera mean reprojection error exceeds
    ``outlier_threshold`` (default 5 x median error) excluded; random
    subsample to ``n_frames``; then LM with soft-L1 loss and ftol=1e-4.

    Extensions: ``dtype`` selects compute precision (default f64 data
    with f32 Jacobians when x64 is on), ``mesh`` an optional
    ``jax.sharding.Mesh`` with a 'frames' axis for multi-device BA (see
    parallel.sharded_bundle_adjust).

    Checkpoint/resume (the reference has stage-level caching only,
    SURVEY.md §5): with ``checkpoint_path`` set, optimizer state (params,
    damping, iteration count, frame selection) is saved as .npz every
    ``checkpoint_every`` iterations (default 10) and a killed run resumes
    from the file — the frame selection is restored from the checkpoint so
    the problem is bit-identical.

    Returns (adjusted_extrinsics, adjusted_intrinsics, adjusted_calib_poses,
    use_frames, result_info).
    """
    from ..utils.metrics import metrics

    all_calib_uvs = np.asarray(all_calib_uvs)
    n_cameras = all_calib_uvs.shape[0]

    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"  # np.savez appends it; keep load in sync
    ckpt = None
    fingerprint = None
    if checkpoint_path is not None:
        fingerprint = _ba_fingerprint(
            all_calib_uvs, seed, n_frames, outlier_threshold
        )
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        ckpt = dict(np.load(checkpoint_path))
        if ckpt["n_cameras"] != n_cameras or ckpt["n_total_frames"] != (
            all_calib_uvs.shape[1]
        ):
            raise ValueError(
                f"checkpoint {checkpoint_path} was written for a different "
                "problem (camera/frame counts differ)"
            )
        # Same-shaped but different data/selection must not silently resume
        # a stale state: verify the content fingerprint when present.
        if "fingerprint" in ckpt and str(
            np.asarray(ckpt["fingerprint"])
        ) != fingerprint:
            raise ValueError(
                f"checkpoint {checkpoint_path} was written for a different "
                "problem (detection data or frame-selection options differ); "
                "delete it or pass a different checkpoint_path"
            )
        if verbose:
            print(
                f"Resuming BA from {checkpoint_path} "
                f"(iteration {int(ckpt['it_done'])})"
            )

    if ckpt is not None:
        use_frames = ckpt["use_frames"]
    else:
        with metrics.timer("ba.select_frames"):
            use_frames = select_ba_frames(
                all_calib_uvs, all_extrinsics, all_intrinsics, calib_objpoints,
                calib_poses, n_frames=n_frames,
                outlier_threshold=outlier_threshold, seed=seed, verbose=verbose,
            )

    obs_np = all_calib_uvs[:, use_frames]
    mask_np = ~np.isnan(obs_np).any(-1)  # (C, F, N) per-point mask
    if ckpt is not None:
        cam0 = ckpt["cam"]
        poses0 = ckpt["poses"]
    else:
        cam0 = _params_to_arrays(all_extrinsics, all_intrinsics)
        poses0 = np.asarray(calib_poses)[use_frames]

    # Numerics defaults (see lm_core.LMOptions): the LM needs f64
    # residuals/gradients to reach the reference's cost basin reliably —
    # pure f32 stalls at compile-dependent shelves of the soft-L1 valley.
    # With x64 available we run f64 data + f32 Jacobians (measured identical
    # optimum to pure f64).
    default_jac_dtype = None
    if dtype is None:
        if _jax.config.jax_enable_x64:
            dtype = jnp.float64
            default_jac_dtype = "float32"
        else:
            dtype = jnp.zeros(0).dtype  # backend default (f32)
            import warnings

            warnings.warn(
                "bundle_adjust is running in float32 (jax x64 disabled): "
                "f32 LM can stall a few percent above the optimum; "
                "enable x64 (jax.config.update('jax_enable_x64', True)) "
                "before backend init for reference-grade accuracy",
                stacklevel=2,
            )
    obs = jnp.asarray(np.nan_to_num(obs_np), dtype=dtype)
    mask = jnp.asarray(mask_np)
    cam0_j = jnp.asarray(cam0, dtype=dtype)
    poses0_j = jnp.asarray(np.nan_to_num(poses0), dtype=dtype)
    objpoints_j = jnp.asarray(calib_objpoints, dtype=dtype)

    if isinstance(lm_options, dict):
        # Convenience: a dict of LMOptions overrides layered on the
        # auto-selected numerics recipe (an LMOptions instance replaces the
        # recipe wholesale).
        opt_kwargs = {**opt_kwargs, **lm_options}
        lm_options = None
    opts = lm_options or LMOptions(
        ftol=opt_kwargs.get("ftol", 1e-4),
        loss=opt_kwargs.get("loss", "soft_l1"),
        f_scale=opt_kwargs.get("f_scale", 1.0),
        max_iters=opt_kwargs.get("max_iters", 100),
        jac_dtype=opt_kwargs.get("jac_dtype", default_jac_dtype),
        block_dtype=opt_kwargs.get("block_dtype"),
        cost_dtype=opt_kwargs.get("cost_dtype"),
        solve_dtype=opt_kwargs.get("solve_dtype"),
        grad_dtype=opt_kwargs.get("grad_dtype"),
        gtol_rel=opt_kwargs.get("gtol_rel", 0.0),
        lambda_escalation=opt_kwargs.get("lambda_escalation", 1.0),
        frame_chunk=opt_kwargs.get("frame_chunk", None),
    )

    def _solve(cam_in, poses_in, chunk_opts, init_lam=None, init_grad0=None):
        if mesh is not None:
            from ..parallel.sharded import sharded_lm_solve

            return sharded_lm_solve(
                cam_in, poses_in, obs, mask, objpoints_j, chunk_opts,
                mesh=mesh, init_lam=init_lam, init_grad0=init_grad0,
            )
        # lm_solve is itself jitted with a module-level cache (keyed on
        # shapes + opts), so repeated calls don't recompile.
        return lm_solve(
            cam_in, poses_in, obs, mask, objpoints_j, chunk_opts,
            init_lam=init_lam, init_grad0=init_grad0,
        )

    with metrics.timer(
        "ba.lm_solve", n_cameras=n_cameras, n_frames=len(use_frames),
        sharded=mesh is not None,
    ):
        if checkpoint_path is None:
            cam, poses, info = _solve(cam0_j, poses0_j, opts)
        else:
            import dataclasses

            every = int(checkpoint_every or 10)
            it_done = int(ckpt["it_done"]) if ckpt is not None else 0
            lam = float(ckpt["lam"]) if ckpt is not None else None
            # grad0 anchors the gtol_rel stop to the FIRST linearization of
            # the whole optimization — each resumed chunk must not re-base
            # it on its own (already-contracted) starting gradient.
            # ("grad0" membership guards resume from pre-grad0 checkpoints;
            # -1.0 is the "unset" sentinel both on disk and in lm_solve.)
            grad0 = (
                float(ckpt["grad0"])
                if ckpt is not None and "grad0" in ckpt
                else None
            )
            if grad0 is not None and grad0 < 0:
                grad0 = None
            cam, poses = cam0_j, poses0_j
            first_cost = (
                float(ckpt["initial_cost"]) if ckpt is not None else None
            )
            ran_any = False
            info = {}
            while it_done < opts.max_iters:
                ran_any = True
                # Clamp the chunk to the remaining budget (a resumed run may
                # be near the cap already).
                chunk_opts = dataclasses.replace(
                    opts, max_iters=min(every, opts.max_iters - it_done)
                )
                cam, poses, info = _solve(
                    cam, poses, chunk_opts, init_lam=lam, init_grad0=grad0
                )
                it_done += int(info["n_iters"])
                lam = float(info["lambda"])
                if "grad0" in info:
                    grad0 = float(info["grad0"])
                if first_cost is None:
                    first_cost = float(info["initial_cost"])
                # Atomic write: a kill mid-savez must not corrupt the file
                # the feature exists to protect.
                tmp_path = checkpoint_path + ".tmp.npz"
                np.savez(
                    tmp_path,
                    cam=np.asarray(cam),
                    poses=np.asarray(poses),
                    lam=lam,
                    it_done=it_done,
                    use_frames=np.asarray(use_frames),
                    initial_cost=first_cost,
                    grad0=-1.0 if grad0 is None else grad0,
                    n_cameras=n_cameras,
                    n_total_frames=all_calib_uvs.shape[1],
                    fingerprint=fingerprint,
                    converged=bool(info["converged"]),
                )
                os.replace(tmp_path, checkpoint_path)
                metrics.log(
                    "ba_checkpoint", path=checkpoint_path, it_done=it_done,
                    cost=float(info["final_cost"]),
                )
                if bool(info["converged"]):
                    break
            if not ran_any:  # resumed at/over the iteration cap
                cost_now = float(
                    _jit_cost(cam, poses, obs, mask, objpoints_j, opts)
                )
                info = {
                    "final_cost": cost_now,
                    "converged": False,
                    "lambda": lam if lam is not None else opts.init_lambda,
                }
                if first_cost is None:
                    first_cost = cost_now
            info = dict(info)
            info["n_iters"] = it_done
            info["initial_cost"] = first_cost

    # f64 polish after a mixed-precision descent: the f32 Schur solve can
    # stall a few percent above the optimum on small or ill-conditioned
    # problems (the gauge-free camera system's conditioning is what f32
    # cannot always handle; measured a 6.9% shelf on a 4-cam toy problem —
    # large problems converge to the noise floor without it). A short
    # warm-started f64 solve from the mixed solution costs a handful of
    # iterations and guarantees f64-grade final quality at mixed-recipe
    # descent speed.
    if (
        opts.solve_dtype is not None
        and cam0_j.dtype == jnp.float64
        and jnp.dtype(opts.solve_dtype) != jnp.float64
    ):
        import dataclasses as _dc

        polish_opts = _dc.replace(
            opts,
            block_dtype=None,
            cost_dtype=None,
            solve_dtype=None,
            grad_dtype=None,
            max_iters=10,
        )
        with metrics.timer("ba.f64_polish"):
            cam, poses, pinfo = _solve(
                cam, poses, polish_opts, init_lam=float(info["lambda"])
            )
        info = dict(info)
        info["polish_iters"] = int(pinfo["n_iters"])
        info["final_cost"] = pinfo["final_cost"]
        info["optimality"] = pinfo["optimality"]
        metrics.log(
            "ba_f64_polish", iters=int(pinfo["n_iters"]),
            cost=float(pinfo["final_cost"]),
        )

    _emit_lm_history(info, verbose)

    if repair_poses and mesh is not None:
        # The repair polish runs unsharded; on meshes it would materialize
        # the full W blocks on one device — exactly what sharding avoids.
        metrics.log("ba_pose_repair_skipped", reason="mesh")
        repair_poses = False
    if repair_poses:
        with metrics.timer("ba.pose_repair"):
            poses, n_repaired = _repair_bad_poses(
                cam, poses, obs, mask, objpoints_j, opts
            )
            if n_repaired:
                info = dict(info)
                info["final_cost"] = _jit_cost(
                    cam, poses, obs, mask, objpoints_j, opts
                )
                info["n_poses_repaired"] = n_repaired
                if verbose:
                    print(f"Re-solved {n_repaired} outlier frame poses")

    adjusted_extrinsics, adjusted_intrinsics = _arrays_to_params(cam)
    adjusted_calib_poses = np.asarray(poses)
    result = {k: np.asarray(v) for k, v in info.items()}
    metrics.log(
        "ba_result",
        initial_cost=float(result["initial_cost"]),
        final_cost=float(result["final_cost"]),
        n_iters=int(result["n_iters"]),
        n_cameras=n_cameras,
        n_frames=len(use_frames),
    )
    if verbose:
        print(
            f"BA: cost {float(result['initial_cost']):.4g} -> "
            f"{float(result['final_cost']):.4g} in {int(result['n_iters'])} iters"
        )
    return (
        adjusted_extrinsics,
        adjusted_intrinsics,
        adjusted_calib_poses,
        use_frames,
        result,
    )
