"""Smoke run of the calibration pipeline on one NVIDIA GPU.

    python chip_smoke.py              # every phase, one GPU
    python chip_smoke.py --four-gpus  # the sharded BA + triangulation, 4 GPUs

Drives the main path once through the public entry points at the
reference tutorial rig's size (6 cameras, 5x7 board at 12.5 mm, BA over a
5,000-frame subsample): device detection on rendered 480x640 frames, init
(``calibrate``), ``bundle_adjust``, triangulation, floor alignment and JSON
export, the frozen reference BA problem (``BASELINE_PROBLEM.npz``) and
``RollingCalibrator`` at 64 cameras. Each phase prints one JSON line with
its times (first call, which compiles, and a second, steady call) and its
correctness numbers beside their limits. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and is printed only when every limit held. Exits non-zero, before any
phase, when JAX finds no GPU; any exception propagates.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BOARD = (5, 7)
SQUARE_MM = 12.5
NOISE_PX = 0.3
# BASELINE_MEASURED.json: the reference solver's cost on BASELINE_PROBLEM
# and the noise-floor RMSE of that problem.
REF_COST = 12338.04
REF_RMSE = 0.4199


def emit(**fields):
    print(json.dumps(fields, default=float), flush=True)


def check(value, op, limit):
    """One correctness number beside its limit; NaN never passes."""
    value = float(value)
    ok = value <= limit if op == "<=" else value >= limit
    return {"value": value, "limit": f"{op} {limit}",
            "ok": bool(ok and np.isfinite(value))}


def run_twice(fn):
    """(result, times): the first call compiles, the second is steady."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    steady = time.perf_counter() - t0
    return out, {"first_s": first, "steady_s": steady,
                 "compile_s": max(first - steady, 0.0)}


# ---------------------------------------------------------------------------
# Phase helpers (small enough to run on the CPU in tests)
# ---------------------------------------------------------------------------


def response_rel_error(gray, sigma):
    """max |kept response (f32) - conv reference (f64, highest matmul
    precision)| over max |reference|."""
    import jax
    import jax.numpy as jnp

    from multicam_calibration_tpu.detection.detector import (
        corner_response,
        corner_response_reference,
    )

    g = jnp.asarray(gray, jnp.float32)
    kept = jax.jit(corner_response, static_argnums=1)(g, sigma)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(corner_response_reference, static_argnums=1)(
            g.astype(jnp.float64), sigma
        )
    ref = np.asarray(ref)
    err = np.abs(np.asarray(kept, np.float64) - ref).max()
    return float(err / np.abs(ref).max())


def render_rig_frames(n_cams, n_frames, seed=0, size=(480, 640)):
    """uint8 frames (C, F, H, W) of the board in random views, and the
    rendered ground-truth corners (C, F, 35, 2)."""
    from multicam_calibration_tpu.detection.synthetic_images import (
        random_view_homography,
        render_board_view,
    )

    frames = np.empty((n_cams, n_frames) + tuple(size), np.uint8)
    gts = np.empty((n_cams, n_frames, BOARD[0] * BOARD[1], 2))
    for c in range(n_cams):
        for f in range(n_frames):
            k = seed + 100_000 * c + f
            H = random_view_homography(np.random.default_rng(k),
                                       out_size=size, board_shape=BOARD)
            view, gt = render_board_view(H, out_size=size, board_shape=BOARD,
                                         noise=1.5, seed=k)
            frames[c, f] = view.astype(np.uint8)
            gts[c, f] = gt
    return frames, gts


def detection_metrics(dets, gts):
    """(rate, median corner RMS px): a frame counts when its corners sit
    within 1 px RMS of the truth with the anchor corner first."""
    rms = []
    n_ok = 0
    for i, gt in enumerate(gts):
        det = dets.get(i)
        if det is None:
            continue
        uvs = np.asarray(det[0])
        d = np.linalg.norm(uvs[:, None] - gt[None], axis=-1)
        r = float(np.sqrt((d.min(0) ** 2).mean()))
        rms.append(r)
        n_ok += bool(r < 1.0 and np.linalg.norm(uvs[0] - gt[0]) < 2.0)
    return n_ok / len(gts), float(np.median(rms)) if rms else float("nan")


def rigid_align_error(pts, truth):
    """Per-point distance after the best rigid alignment of ``pts`` onto
    ``truth`` (the BA solution is defined up to a rigid gauge)."""
    pts = np.asarray(pts, np.float64)
    truth = np.asarray(truth, np.float64)
    ok = np.isfinite(pts).all(-1)
    p, t = pts[ok], truth[ok]
    pc, tc = p.mean(0), t.mean(0)
    U, _, Vt = np.linalg.svd((p - pc).T @ (t - tc))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ D @ Vt).T
    aligned = (pts - pc) @ R.T + tc
    return np.linalg.norm(aligned - truth, axis=-1)


def synthetic_keypoints(rig, n_frames, n_kp=8, seed=0):
    """Keypoints (n_frames, n_kp, 3) over a tilted floor near the rig's
    board volume: per frame one keypoint on the floor (the lowest in z),
    the rest 10-60 mm above it."""
    rng = np.random.default_rng(seed)
    center = rig.calib_poses[:, 3:].mean(0)
    xy = rng.uniform(-60, 60, (n_frames, n_kp, 2)) + center[:2]
    floor = center[2] + 0.05 * (xy[..., 0] - center[0]) + 0.03 * (
        xy[..., 1] - center[1])
    lift = rng.uniform(10, 60, (n_frames, n_kp))
    lift[:, 0] = 0.0
    z = floor + lift + rng.normal(0, 0.2, (n_frames, n_kp))
    return np.concatenate([xy, z[..., None]], -1)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_response(shapes=((8, 480, 640), (2, 1080, 1920)),
                   sigmas=(1.5, 9.0)):
    rng = np.random.default_rng(0)
    checks = {}
    t0 = time.perf_counter()
    for B, H, W in shapes:
        g = rng.uniform(0, 1, (B, H, W))
        for s in (sigmas if H == shapes[0][1] else sigmas[:1]):
            checks[f"rel_err_{H}x{W}_sigma{s}"] = check(
                response_rel_error(g, s), "<=", 1e-5)
    return checks, {"wall_s": time.perf_counter() - t0}


def phase_detection(n_cams=6, n_frames=256, seed=0):
    from multicam_calibration_tpu.detection.detector import (
        detect_chessboard_batches,
    )
    from multicam_calibration_tpu.detection.video import BATCH_SIZE as bs

    t0 = time.perf_counter()
    frames, gts = render_rig_frames(n_cams, n_frames, seed)
    render_s = time.perf_counter() - t0

    def detect_all():
        out = []
        for c in range(n_cams):
            batches = [list(frames[c, i:i + bs])
                       for i in range(0, n_frames, bs)]
            found = {}
            for k, d in enumerate(detect_chessboard_batches(
                    iter(batches), board_shape=BOARD)):
                found.update({k * bs + j: v for j, v in d.items()})
            out.append(found)
        return out

    dets, times = run_twice(detect_all)
    rates, errs = zip(*(detection_metrics(dets[c], gts[c])
                        for c in range(n_cams)))
    checks = {
        "detection_rate": check(np.mean(rates), ">=", 0.9),
        "median_corner_rms_px": check(np.median(errs), "<=", 0.6),
    }
    return checks, dict(times, render_s=render_s, batch_size=bs,
                        frames=n_cams * n_frames,
                        frames_per_s=n_cams * n_frames / times["steady_s"])


def phase_init(rig):
    import multicam_calibration_tpu as mct

    (ext, intr, poses, _), times = run_twice(lambda: mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False))
    pred = np.asarray(mct.predict_calib_uvs(
        np.asarray(ext), intr, rig.calib_objpoints, np.asarray(poses)))
    err = np.linalg.norm(rig.all_calib_uvs - pred, axis=-1)
    # Median: a few frames' consensus poses are flipped at init (the
    # two-sided board), which BA's outlier filter then drops.
    checks = {"init_median_reproj_px": check(np.nanmedian(err), "<=", 5.0)}
    return checks, times, (ext, intr, poses)


def phase_ba(rig, init, n_frames=5000):
    import multicam_calibration_tpu as mct

    ext, intr, poses = init
    (aext, aintr, aposes, use, res), times = run_twice(
        lambda: mct.bundle_adjust(
            rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses,
            n_frames=n_frames, verbose=False))
    pred = np.asarray(mct.predict_calib_uvs(
        np.asarray(aext), aintr, rig.calib_objpoints, np.asarray(aposes)))
    err = np.linalg.norm(rig.all_calib_uvs[:, use] - pred, axis=-1)
    rmse = float(np.sqrt(np.nanmean(err ** 2)))
    target = NOISE_PX * np.sqrt(2.0)
    checks = {"rmse_rel_dev_from_0.3sqrt2": check(
        abs(rmse / target - 1.0), "<=", 0.02)}
    info = dict(times, rmse_px=rmse, n_frames=int(len(use)),
                n_iters=int(res["n_iters"]),
                final_cost=float(res["final_cost"]))
    return checks, info, (aext, aintr)


def phase_downstream(rig, calib, out_dir, n_kp_frames=2000):
    import multicam_calibration_tpu as mct

    aext, aintr = calib
    kps = synthetic_keypoints(rig, n_kp_frames)
    flat = kps.reshape(-1, 3)
    rng = np.random.default_rng(1)
    uvs = [np.asarray(mct.project_points(flat, rig.all_extrinsics[c],
                                         *rig.all_intrinsics[c]))
           + rng.normal(0, NOISE_PX, (len(flat), 2))
           for c in range(len(rig.all_extrinsics))]
    pts, times = run_twice(lambda: mct.triangulate(
        uvs, list(np.asarray(aext)), list(aintr)))
    tri_err = rigid_align_error(np.asarray(pts), flat)
    floor = mct.get_floor_points(np.asarray(pts).reshape(kps.shape))
    T = mct.center_arena(mct.flatibrate(floor), floor)
    leveled = np.asarray(mct.apply_rigid_transform(
        np.asarray(T), np.asarray(floor)))
    path = os.path.join(out_dir, "calibration.json")
    names = [f"cam{c}" for c in range(len(aintr))]
    mct.save_calibration(np.asarray(aext), aintr, names, path, "json")
    lext, lintr, _ = mct.load_calibration(path, "json")
    io_err = max(np.abs(np.asarray(lext) - np.asarray(aext)).max(),
                 max(np.abs(np.asarray(a[0]) - np.asarray(b[0])).max()
                     for a, b in zip(lintr, aintr)))
    checks = {
        "triangulation_median_err_mm": check(np.median(tri_err), "<=", 0.5),
        "floor_median_abs_z_mm": check(np.median(np.abs(leveled[:, 2])),
                                       "<=", 1.0),
        "arena_midrange_offset_mm": check(np.abs(np.percentile(
            leveled[:, :2], [1, 99], axis=0).mean(0)).max(), "<=", 1e-6),
        "json_roundtrip_max_abs_err": check(io_err, "<=", 1e-6),
    }
    return checks, dict(times, n_points=len(flat))


def phase_baseline_problem():
    import jax.numpy as jnp

    import multicam_calibration_tpu as mct
    from multicam_calibration_tpu.models.bundle_adjustment import (
        _params_to_arrays,
    )
    from multicam_calibration_tpu.models.lm_core import LMOptions, lm_solve

    prob = np.load(os.path.join(ROOT, "BASELINE_PROBLEM.npz"))
    rig = mct.make_synthetic_rig(
        n_cameras=int(prob["n_cameras"]), n_frames=int(prob["n_frames"]),
        noise_px=NOISE_PX, dropout=0.25, seed=int(prob["seed"]))
    ext, intr, poses, _ = mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=50)
    use = prob["use_frames"]
    obs_np = rig.all_calib_uvs[:, use]
    mask_np = ~np.isnan(obs_np).any(-1)
    f64 = jnp.float64
    cam0 = jnp.asarray(_params_to_arrays(ext, intr), f64)
    poses0 = jnp.asarray(np.nan_to_num(np.asarray(poses)[use]), f64)
    obs = jnp.asarray(np.nan_to_num(obs_np), f64)
    mask = jnp.asarray(mask_np)
    objp = jnp.asarray(rig.calib_objpoints, f64)
    opts = LMOptions(jac_dtype="float32")
    (cam, p, info), times = run_twice(
        lambda: lm_solve(cam0, poses0, obs, mask, objp, opts))
    cam = np.asarray(cam)
    intr_out = [(np.array([[c[0], 0, c[2]], [0, c[1], c[3]], [0, 0, 1.0]]),
                 np.array([c[4], c[5], 0, 0, 0])) for c in cam]
    pred = np.asarray(mct.predict_calib_uvs(
        cam[:, 6:12], intr_out, rig.calib_objpoints, np.asarray(p)))
    err = np.linalg.norm(obs_np - pred, axis=-1)
    rmse = float(np.sqrt(np.nanmean(np.where(mask_np, err, np.nan) ** 2)))
    cost = float(info["final_cost"])
    checks = {
        "final_cost": check(cost, "<=", REF_COST),
        "rmse_rel_dev_from_ref": check(abs(rmse / REF_RMSE - 1), "<=", 0.02),
    }
    return checks, dict(times, n_iters=int(info["n_iters"]), rmse_px=rmse,
                        n_frames=int(len(use)))


def phase_streaming(n_cams=64, window=256, batch=8, n_timed=4):
    import multicam_calibration_tpu as mct
    from multicam_calibration_tpu.models.streaming import RollingCalibrator

    rig = mct.make_synthetic_rig(
        n_cameras=n_cams, n_frames=window + batch * (n_timed + 4),
        noise_px=NOISE_PX, dropout=0.25, seed=11)
    rc = RollingCalibrator(rig.all_extrinsics, rig.all_intrinsics,
                           rig.calib_objpoints, window=window)
    t0 = time.perf_counter()
    f = 0
    while rc.occupancy < window:
        rc.update(rig.all_calib_uvs[:, f:f + batch])
        f += batch
    fill_s = time.perf_counter() - t0
    walls = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        info = rc.update(rig.all_calib_uvs[:, f:f + batch])
        walls.append(time.perf_counter() - t0)
        f += batch
    # Noise floor of the window's soft-L1 cost at iid 0.3 px noise.
    n_obs = int(np.asarray(rc._msk_d).sum())
    floor_cost = 2 * n_obs * 0.5 * NOISE_PX ** 2 * (1 - 0.75 * NOISE_PX ** 2)
    checks = {"window_cost_over_noise_floor": check(
        info["cost"] / floor_cost, "<=", 1.05)}
    return checks, {"fill_s": fill_s, "update_s": walls,
                    "median_update_s": float(np.median(walls))}


def phase_four_gpus(devices, n_cams=64, n_frames=20000, frame_chunk=1024,
                    max_iters=8, n_points=2_000_000, trace_dir=None):
    """Frame-sharded BA on a 4-device 'frames' mesh vs single-device
    lm_solve (BASELINE config 5's size), and points-sharded triangulation
    of keypoints seen by the 6-camera tutorial rig vs triangulate."""
    import jax
    import jax.numpy as jnp

    import multicam_calibration_tpu as mct
    from multicam_calibration_tpu.models.bundle_adjustment import (
        _params_to_arrays,
    )
    from multicam_calibration_tpu.models.lm_core import LMOptions, lm_solve
    from multicam_calibration_tpu.parallel import (
        sharded_lm_solve,
        sharded_triangulate,
    )

    rig = mct.make_synthetic_rig(n_cameras=n_cams, n_frames=n_frames,
                                 noise_px=NOISE_PX, dropout=0.25, seed=5)
    rng = np.random.default_rng(5)
    cam = _params_to_arrays(rig.all_extrinsics, rig.all_intrinsics)
    cam = cam + rng.normal(0, 1, cam.shape) * np.r_[
        np.full(4, 0.5), np.full(2, 1e-4), np.full(3, 1e-4), np.full(3, 0.1)]
    f64 = jnp.float64
    cam = jnp.asarray(cam, f64)
    poses = jnp.asarray(rig.calib_poses, f64)
    obs = jnp.asarray(np.nan_to_num(rig.all_calib_uvs), f64)
    mask = jnp.asarray(~np.isnan(rig.all_calib_uvs).any(-1))
    objp = jnp.asarray(rig.calib_objpoints, f64)
    opts = LMOptions(jac_dtype="float32", frame_chunk=frame_chunk,
                     max_iters=max_iters)
    mesh = jax.sharding.Mesh(np.array(devices), ("frames",))
    (cam_m, _, info_m), t_mesh = run_twice(lambda: sharded_lm_solve(
        cam, poses, obs, mask, objp, opts, mesh=mesh))
    (cam_s, _, info_s), t_one = run_twice(lambda: lm_solve(
        cam, poses, obs, mask, objp, opts))
    n = min(int(info_m["n_iters"]), int(info_s["n_iters"]))
    hm = np.asarray(info_m["history"])[:n, 0]
    hs = np.asarray(info_s["history"])[:n, 0]
    traj = float(np.max(np.abs(hm - hs) / np.abs(hs)))
    per_device = {}
    if trace_dir is not None:
        per_device = device_busy_ms(trace_dir, lambda: sharded_lm_solve(
            cam, poses, obs, mask, objp, opts, mesh=mesh))

    rig6 = mct.make_synthetic_rig(n_cameras=6, n_frames=200,
                                  noise_px=NOISE_PX, seed=7)
    kps = synthetic_keypoints(rig6, n_points // 8).reshape(-1, 3)
    uvs = [np.asarray(mct.project_points(kps, rig6.all_extrinsics[c],
                                         *rig6.all_intrinsics[c]))
           + rng.normal(0, NOISE_PX, (len(kps), 2)) for c in range(6)]
    pmesh = jax.sharding.Mesh(np.array(devices), ("points",))
    ext, intr = list(rig6.all_extrinsics), list(rig6.all_intrinsics)
    tri_m, t_tri_m = run_twice(
        lambda: sharded_triangulate(uvs, ext, intr, mesh=pmesh))
    tri_s, t_tri_s = run_twice(lambda: mct.triangulate(uvs, ext, intr))
    tri_diff = float(np.nanmax(np.abs(np.asarray(tri_m) - np.asarray(tri_s))))
    checks = {
        # rtol 2e-6: the only cross-device arithmetic is one psum of the
        # reduced camera system per iteration (summation order).
        "cost_trajectory_max_rel_diff": check(traj, "<=", 2e-6),
        "final_cost_rel_diff": check(
            abs(float(info_m["final_cost"]) / float(info_s["final_cost"])
                - 1), "<=", 2e-6),
        "sharded_triangulate_max_abs_diff_mm": check(tri_diff, "<=", 1e-6),
    }
    if trace_dir is not None:
        # The frames are split evenly, so every GPU should be about as
        # busy as the busiest one.
        busy = list(per_device.values()) or [float("nan")]
        checks["device_busy_min_over_max"] = check(
            min(busy) / max(busy), ">=", 0.5)
    return checks, {
        "iters_compared": n, "sharded": t_mesh, "single": t_one,
        "sharded_triangulate": t_tri_m, "triangulate": t_tri_s,
        "device_busy_ms": per_device, "n_points": len(kps),
        "final_cost": float(info_m["final_cost"]),
        "initial_cost": float(info_m["initial_cost"]),
    }


def device_busy_ms(trace_dir, fn):
    """Device-event milliseconds per GPU plane while ``fn`` runs once."""
    import glob

    import jax
    from jax.profiler import ProfileData

    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn())
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    busy = {}
    for plane in ProfileData.from_file(path).planes:
        if plane.name.startswith("/device:GPU"):
            busy[plane.name] = sum(
                ev.duration_ns for line in plane.lines
                if line.name.startswith("Stream")
                for ev in line.events) / 1e6
    return busy


# ---------------------------------------------------------------------------


def card_line():
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-gpus", action="store_true",
                        help="run only the 4-GPU sharded BA + triangulation")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU visible to JAX (platform "
                 f"{devices[0].platform!r})")
    n_needed = 4 if args.four_gpus else 1
    if len(devices) < n_needed:
        sys.exit(f"chip_smoke: need {n_needed} GPUs, JAX sees {len(devices)}")
    jax.config.update("jax_enable_x64", True)
    from multicam_calibration_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    cache = enable_compile_cache()
    card = card_line()
    print(card, flush=True)
    emit(phase="device", card=card, kind=devices[0].device_kind,
         count=len(devices), compile_cache=cache)

    failed = []

    def report(name, checks, info):
        emit(phase=name, checks=checks, **info)
        failed.extend(f"{name}.{k}" for k, c in checks.items() if not c["ok"])

    t_all = time.perf_counter()
    if args.four_gpus:
        out = os.path.join(ROOT, "chiprun_out", "trace_four_gpus")
        report("four_gpus", *phase_four_gpus(devices[:4], trace_dir=out))
    else:
        import multicam_calibration_tpu as mct

        report("response", *phase_response())
        report("detection", *phase_detection())
        # 12,000 frames leave ~5,400 seen by >= 2 cameras, from which BA
        # draws its 5,000-frame subsample.
        rig = mct.make_synthetic_rig(n_cameras=6, n_frames=12000,
                                     noise_px=NOISE_PX, dropout=0.25, seed=7)
        checks, info, init = phase_init(rig)
        report("init", checks, info)
        checks, info, calib = phase_ba(rig, init)
        report("bundle_adjust", checks, info)
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            report("downstream", *phase_downstream(rig, calib, tmp))
        report("baseline_problem", *phase_baseline_problem())
        report("streaming", *phase_streaming())
    emit(phase="total", wall_s=time.perf_counter() - t_all, failed=failed)
    if failed:
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
