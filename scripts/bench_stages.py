"""Stage benchmarks: calibration INIT and TRIANGULATION vs the reference.

BA and detection have dedicated benches (bench.py, bench_detection.py);
this covers the remaining two hot call stacks of SURVEY.md SS3 on identical
inputs:

- init: ``calibrate`` (Zhang closed-form + batched PnP + spanning tree +
  consensus, ours) vs reference ``calibrate`` (cv2.calibrateCamera +
  per-frame cv2.solvePnP loops, calibration.py:280-373). Quality = RMSE of
  the consensus reprojection at each solver's own estimate.
- triangulate: robust pairwise-median triangulation (ours: one jitted
  batched-DLT program) vs reference ``triangulate`` (per-pair
  cv2.triangulatePoints + per-point nanmedian Python loop,
  geometry.py:361-433). Quality = max |ours - reference| on common points
  and RMSE to ground truth.

Prints one JSON row per stage, run on JAX's default device.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_CAMERAS = 6
N_FRAMES = 1000
SEED = 11
TRI_POINTS = 200_000  # e.g. 10k frames x 20 keypoints, flattened


def _reference_pkg(mod):
    import importlib
    import types

    name = f"refmcc.{mod}"
    if name in sys.modules:
        return sys.modules[name]
    for stub in ("vidio", "vidio.read", "pandas", "tqdm"):
        if stub in sys.modules:
            continue
        try:
            importlib.import_module(stub)
            continue
        except ImportError:
            pass
        m = types.ModuleType(stub)
        if stub == "vidio.read":
            m.OpenCVReader = object
        if stub == "tqdm":
            m.tqdm = lambda it, **kw: it  # passthrough progress bar
        sys.modules[stub] = m
    pkg = types.ModuleType("refmcc")
    pkg.__path__ = ["/root/reference/multicam_calibration"]
    sys.modules.setdefault("refmcc", pkg)
    return importlib.import_module(name)


def _consensus_rmse(all_uvs, ext, intr, objpoints, poses):
    import multicam_calibration_tpu as mct

    pred = np.asarray(
        mct.predict_calib_uvs(
            np.asarray(ext, float), intr, objpoints, np.asarray(poses, float)
        )
    )
    err = np.linalg.norm(all_uvs - pred, axis=-1)
    return float(np.sqrt(np.nanmean(err**2)))


def bench_init(rig):
    import multicam_calibration_tpu as mct

    ref_cal = _reference_pkg("calibration")

    t0 = time.time()
    r_ext, r_intr, r_poses, _ = ref_cal.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=100,
    )
    ref_wall = time.time() - t0
    ref_rmse = _consensus_rmse(
        rig.all_calib_uvs, r_ext, r_intr, rig.calib_objpoints, r_poses
    )

    # Warm-up (compile), then timed run — stage comparisons exclude compile
    # like bench.py does.
    mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints, verbose=False,
        n_samples_for_intrinsics=100,
    )
    t0 = time.time()
    ext, intr, poses, _ = mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints, verbose=False,
        n_samples_for_intrinsics=100,
    )
    wall = time.time() - t0
    rmse = _consensus_rmse(
        rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses
    )

    # The metric that matters for an INIT stage: does downstream BA reach
    # the same optimum from it? (The consensus RMSE of the raw init is
    # dominated by luck on ill-conditioned cameras — synthetic camera 3's
    # single-camera distortion is a flat valley both solvers land in at
    # different points; cross-camera BA resolves it.)
    def ba_rmse(e, i, p):
        a_ext, a_intr, a_poses, use_frames, _ = mct.bundle_adjust(
            rig.all_calib_uvs, e, i, rig.calib_objpoints, p, verbose=False
        )
        pred = np.asarray(
            mct.predict_calib_uvs(a_ext, a_intr, rig.calib_objpoints, a_poses)
        )
        err = np.linalg.norm(rig.all_calib_uvs[:, use_frames] - pred, axis=-1)
        return float(np.sqrt(np.nanmean(err**2)))

    ba_ours = ba_rmse(ext, intr, poses)
    ba_ref = ba_rmse(r_ext, r_intr, r_poses)
    return {
        "stage": "init_calibrate",
        "workload": f"{N_CAMERAS}cam x {N_FRAMES}frames x 35pts",
        "wall_s": round(wall, 3),
        "reference_wall_s": round(ref_wall, 3),
        "vs_reference": round(ref_wall / wall, 2),
        "consensus_rmse_px": round(rmse, 4),
        "reference_consensus_rmse_px": round(ref_rmse, 4),
        "ba_rmse_from_our_init_px": round(ba_ours, 4),
        "ba_rmse_from_reference_init_px": round(ba_ref, 4),
    }


def bench_triangulate(rig, rng):
    import multicam_calibration_tpu as mct

    ref_geom = _reference_pkg("geometry")

    # Ground-truth cloud inside the rig's working volume: the board
    # trajectory's own translation distribution IS the working volume
    # (the rig is mm-scale with camera 0 as the world frame).
    centers = rig.calib_poses[:, 3:]
    lo, hi = centers.min(0), centers.max(0)
    pts_gt = rng.uniform(lo, hi, (TRI_POINTS, 3))
    uvs = np.stack(
        [
            np.asarray(
                mct.project_points(
                    pts_gt, rig.all_extrinsics[i], *rig.all_intrinsics[i]
                )
            )
            for i in range(N_CAMERAS)
        ]
    )
    uvs += rng.standard_normal(uvs.shape) * 0.3
    # A real pipeline only ever feeds DETECTED keypoints — observations a
    # camera cannot see are NaN, never wild out-of-frame pixel coords
    # (whose undistortion extrapolates the radial model far beyond its
    # valid radius, on both implementations).
    for i, (w, h) in enumerate(rig.img_sizes):
        oob = (
            (uvs[i, :, 0] < 0) | (uvs[i, :, 0] >= w)
            | (uvs[i, :, 1] < 0) | (uvs[i, :, 1] >= h)
        )
        uvs[i, oob] = np.nan
    drop = rng.uniform(size=uvs.shape[:2]) < 0.3
    uvs[drop] = np.nan

    # Reference (numpy/cv2 loops).
    sub = slice(0, min(TRI_POINTS, 20_000))  # reference is O(minutes) at 200k
    t0 = time.time()
    ref_pts = ref_geom.triangulate(
        [u[sub] for u in uvs], list(rig.all_extrinsics), list(rig.all_intrinsics)
    )
    ref_wall = time.time() - t0
    ref_pps = (sub.stop - sub.start) / ref_wall

    # Ours, DEFAULT path (pair-median + robust-gated GN polish since r3 —
    # VERDICT r2 weak #7): jit over the full cloud; warm-up then timed.
    out = mct.triangulate(uvs, rig.all_extrinsics, rig.all_intrinsics)
    _ = np.asarray(out)
    t0 = time.time()
    out = mct.triangulate(uvs, rig.all_extrinsics, rig.all_intrinsics)
    out_np = np.asarray(out)
    wall = time.time() - t0
    pps = TRI_POINTS / wall
    tri_err = np.linalg.norm(out_np - pts_gt, axis=-1)

    # Explicit refine=False: the reference's exact median-over-pairs
    # semantics, for the numerical-agreement check.
    med_out = mct.triangulate(
        uvs, rig.all_extrinsics, rig.all_intrinsics, refine=False
    )
    _ = np.asarray(med_out)
    t0 = time.time()
    med_out = mct.triangulate(
        uvs, rig.all_extrinsics, rig.all_intrinsics, refine=False
    )
    med_np = np.asarray(med_out)
    wall_med = time.time() - t0
    med_sub = med_np[sub]
    common = np.isfinite(ref_pts).all(-1) & np.isfinite(med_sub).all(-1)
    agree = float(
        np.max(np.linalg.norm(ref_pts[common] - med_sub[common], axis=-1))
    )
    med_err = np.linalg.norm(med_np - pts_gt, axis=-1)

    ref_err_sub = np.linalg.norm(ref_pts - pts_gt[sub], axis=-1)
    return {
        "stage": "triangulate",
        "workload": f"{N_CAMERAS}cam x {TRI_POINTS}pts (30% dropout)",
        "points_per_s_M": round(pps / 1e6, 3),
        "reference_points_per_s_M": round(ref_pps / 1e6, 4),
        "vs_reference": round(pps / ref_pps, 1),
        "max_disagreement_median_path": round(agree, 4),
        "rmse_to_gt": round(float(np.sqrt(np.nanmean(tri_err**2))), 4),
        "reference_rmse_to_gt": round(
            float(np.sqrt(np.nanmean(ref_err_sub**2))), 4
        ),
        "median_path_rmse_to_gt": round(
            float(np.sqrt(np.nanmean(med_err**2))), 4
        ),
        "median_path_points_per_s_M": round(TRI_POINTS / wall_med / 1e6, 3),
        "wall_s": round(wall, 3),
        "reference_wall_s_at_20k": round(ref_wall, 3),
    }


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import multicam_calibration_tpu as mct

    rig = mct.make_synthetic_rig(
        n_cameras=N_CAMERAS, n_frames=N_FRAMES, noise_px=0.3, dropout=0.25,
        seed=SEED,
    )
    rng = np.random.default_rng(3)
    rows = [bench_init(rig), bench_triangulate(rig, rng)]
    for r in rows:
        print(json.dumps(r))
    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind}))


if __name__ == "__main__":
    main()
