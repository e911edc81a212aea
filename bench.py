"""Benchmark: Schur-LM bundle adjustment vs the measured reference baseline.

Runs the flagship workload (6-camera rig, N=35-point board) on the GPU and
prints ONE JSON line:

    {"metric": "ba_lm_iterations_per_s", "value": ..., "unit": "iter/s",
     "vs_baseline": ...}

vs_baseline is the end-to-end BA wall-clock speedup over the reference's
scipy-TRF solver for the same synthetic workload
(scripts/measure_reference_baseline.py -> BASELINE_MEASURED.json); the
reference publishes no numbers of its own (BASELINE.md). Exits non-zero
when JAX finds no GPU.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_CAMERAS = 6
N_FRAMES = 1000
SEED = 11


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("bench: no GPU visible to JAX")

    # f64 data + f32 Jacobians: the damped BA system needs f64 step
    # accuracy to reach the reference's cost basin reliably — f32
    # trajectories stall at compile-dependent shelves of the soft-L1 valley
    # (see lm_core.LMOptions and test_calibration.py::test_f32_solver_quality).
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import multicam_calibration_tpu as mct
    from multicam_calibration_tpu.models.bundle_adjustment import _params_to_arrays
    from multicam_calibration_tpu.models.lm_core import LMOptions, lm_solve
    from multicam_calibration_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dtype = jnp.float64

    rig = mct.make_synthetic_rig(
        n_cameras=N_CAMERAS, n_frames=N_FRAMES, noise_px=0.3, dropout=0.25,
        seed=SEED,
    )
    # Identical init path to the baseline measurement (scripts/...): both
    # solvers start from the same x0 and run to the same ftol.
    ext, intr, poses, _ = mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=50,
    )
    # The EXACT frame set the measured reference run solved
    # (BASELINE_PROBLEM.npz, written by scripts/measure_reference_baseline.py
    # from the reference's own in-solver selection) so the cost comparison is
    # on the identical problem; fall back to our equivalent selection rules
    # if the problem file is absent.
    problem_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BASELINE_PROBLEM.npz"
    )
    use_frames = None
    identical_problem = False
    if os.path.exists(problem_path):
        prob = np.load(problem_path)
        if (
            int(prob["n_cameras"]) == N_CAMERAS
            and int(prob["n_frames"]) == N_FRAMES
            and int(prob["seed"]) == SEED
        ):
            use_frames = prob["use_frames"]
            identical_problem = True
    if use_frames is None:
        from multicam_calibration_tpu.models.bundle_adjustment import (
            select_ba_frames,
        )

        use_frames = select_ba_frames(
            rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses,
            n_frames=None, verbose=False,
        )
    obs_np = rig.all_calib_uvs[:, use_frames]
    mask_np = ~np.isnan(obs_np).any(-1)
    cam0 = jnp.asarray(_params_to_arrays(ext, intr), dtype=dtype)
    poses0 = jnp.asarray(
        np.nan_to_num(np.asarray(poses)[use_frames]), dtype=dtype
    )
    obs = jnp.asarray(np.nan_to_num(obs_np), dtype=dtype)
    mask = jnp.asarray(mask_np)
    objp = jnp.asarray(rig.calib_objpoints, dtype=dtype)

    # Reference-equivalent options (soft_l1, ftol=1e-4).
    opts = LMOptions(jac_dtype="float32")

    # Warm-up (compile), then timed runs. Each run perturbs the starting
    # point slightly so no repeated identical computation can be reused.
    jax.block_until_ready(lm_solve(cam0, poses0, obs, mask, objp, opts))
    walls, iters = [], []
    for k in range(3):
        cam_k = cam0 + jnp.asarray(1e-5, dtype) * (k + 1)
        t0 = time.perf_counter()
        cam, poses_adj, info = jax.block_until_ready(
            lm_solve(cam_k, poses0, obs, mask, objp, opts)
        )
        walls.append(time.perf_counter() - t0)
        iters.append(int(info["n_iters"]))
    wall = float(np.median(walls))
    n_iters = iters[int(np.argsort(walls)[len(walls) // 2])]
    iters_per_s = n_iters / wall

    # Quality gate: reprojection RMSE at the solution.
    pred_ext = np.asarray(cam[:, 6:12], dtype=np.float64)
    intr_out = [
        (
            np.array(
                [[c[0], 0, c[2]], [0, c[1], c[3]], [0, 0, 1.0]]
            ),
            np.array([c[4], c[5], 0, 0, 0]),
        )
        for c in np.asarray(cam, dtype=np.float64)
    ]
    pred = np.asarray(
        mct.predict_calib_uvs(
            pred_ext, intr_out, rig.calib_objpoints,
            np.asarray(poses_adj, dtype=np.float64),
        )
    )
    err = np.linalg.norm(obs_np - pred, axis=-1)
    rmse = float(np.sqrt(np.nanmean(np.where(mask_np, err, np.nan) ** 2)))
    from multicam_calibration_tpu.models.bundle_adjustment import _jit_cost

    final_cost = float(_jit_cost(cam, poses_adj, obs, mask, objp, opts))

    # Speed-of-light accounting: analytic FLOP model for the measured run
    # (utils/flops.py), achieved FLOP/s, and the roofline fraction = (time
    # the device's published peaks allow for the same FLOPs) / measured wall.
    from multicam_calibration_tpu.utils.flops import lm_flops_detail

    nfev = int(info["nfev"])
    # Only the Jacobian runs in f32 under `opts`; the rest is f64.
    flops_detail = lm_flops_detail(
        N_CAMERAS, len(use_frames), 35, n_iters, nfev, wall,
        jax.devices()[0].device_kind, n_obs=int(mask_np.sum()),
        jacobian=opts.jacobian, mixed_f32=False,
    )

    vs_baseline = 0.0
    quality_ok = None
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json")
    if os.path.exists(base_path):
        cases = json.load(open(base_path))["cases"]
        match = [
            c for c in cases
            if c["n_cameras"] == N_CAMERAS and c["n_frames_requested"] == N_FRAMES
        ]
        if match:
            # End-to-end wall-clock speedup at matched-or-better convergence
            # quality. On the identical problem (same frames, same x0 — the
            # BASELINE_PROBLEM path) the gate is strict: our converged cost
            # must be <= the reference solver's. Our LM runs the gradient to
            # ~0 where scipy stops on ftol in the soft-L1 valley, so "beat"
            # here is real, not tolerance slack. Without the problem file the
            # frame sets can differ by threshold flips and costs are not
            # directly comparable — fall back to the 5% proportional gate.
            ref = match[-1]
            if identical_problem:
                quality_ok = bool(final_cost <= ref["cost"])
            else:
                quality_ok = bool(final_cost <= ref["cost"] * 1.05)
            vs_baseline = ref["wall_s"] / wall if quality_ok else 0.0

    dev = jax.devices()[0]
    result = {
        "metric": "ba_lm_iterations_per_s",
        "value": round(iters_per_s, 3),
        "unit": "iter/s",
        "vs_baseline": round(vs_baseline, 3),
        "detail": {
            "workload": f"{N_CAMERAS}cam x {N_FRAMES}frames x 35pts",
            # wall_s: end-to-end solve wall to the converged optimum
            # (vs_baseline = reference wall / wall_s).
            "wall_s": round(wall, 4),
            "n_iters": n_iters,
            "final_cost": round(final_cost, 2),
            "final_rmse_px": round(rmse, 4),
            "quality_vs_ref_ok": quality_ok,
            "identical_problem_to_ref": identical_problem,
            "n_frames_used": int(len(use_frames)),
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "flops": flops_detail,
        },
    }
    line = json.dumps(result)
    print(line)


if __name__ == "__main__":
    main()
