"""Measure the reference implementation's BA performance (the baseline).

The reference publishes no numbers (BASELINE.md), so the baseline is
measured: run the reference's scipy-TRF bundle_adjust on our synthetic
workloads and record wall-clock, iteration counts, and final RMSE into
BASELINE_MEASURED.json. The reference package is imported from
/root/reference via a package shim (its detection module needs vidio, which
is absent — we only load geometry/calibration/bundle_adjustment).

Usage: python scripts/measure_reference_baseline.py [n_frames ...]
"""
import importlib
import json
import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import multicam_calibration_tpu as mct

# --- import reference modules without its package __init__ (needs vidio) ---
_pkg = types.ModuleType("refmcc")
_pkg.__path__ = ["/root/reference/multicam_calibration"]
sys.modules["refmcc"] = _pkg
ref_ba = importlib.import_module("refmcc.bundle_adjustment")


def run_case(n_cameras, n_frames, noise_px=0.3, dropout=0.25, seed=11):
    rig = mct.make_synthetic_rig(
        n_cameras=n_cameras, n_frames=n_frames, noise_px=noise_px,
        dropout=dropout, seed=seed,
    )
    # Shared init from our pipeline (both solvers start from the same x0).
    ext, intr, poses, _ = mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=50,
    )
    poses = np.nan_to_num(np.asarray(poses))

    t0 = time.time()
    out = ref_ba.bundle_adjust(
        rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses,
        n_frames=None, verbose=2,  # reference defaults: 5 x median outlier rule
    )
    wall = time.time() - t0
    result = out[4]
    adj_ext, adj_intr, adj_poses, use_frames = out[0], out[1], out[2], out[3]
    # Freeze the exact problem the reference solved (frame subset) so
    # bench.py can run the SAME problem and compare costs directly
    # (round-1 verdict: a 922-vs-909 frame-selection drift made the costs
    # incomparable at the 1.4% level).
    np.savez(
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "BASELINE_PROBLEM.npz",
        ),
        use_frames=np.asarray(use_frames),
        n_cameras=n_cameras,
        n_frames=n_frames,
        seed=seed,
        ref_cost=float(result.cost),
        ref_optimality=float(result.optimality),
    )
    pred = np.asarray(
        mct.predict_calib_uvs(adj_ext, adj_intr, rig.calib_objpoints, adj_poses)
    )
    err = np.linalg.norm(rig.all_calib_uvs[:, use_frames] - pred, axis=-1)
    rmse = float(np.sqrt(np.nanmean(err**2)))
    return {
        "n_cameras": n_cameras,
        "n_frames_requested": n_frames,
        "n_frames_used": int(len(use_frames)),
        "wall_s": wall,
        "njev": int(result.njev),
        "nfev": int(result.nfev),
        "cost": float(result.cost),
        "rmse_px": rmse,
        "iters_per_s": float(result.njev) / wall,
        "solver": "scipy least_squares TRF (reference bundle_adjustment.py)",
    }


if __name__ == "__main__":
    frame_counts = [int(a) for a in sys.argv[1:]] or [1000]
    out_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "BASELINE_MEASURED.json")
    results = []
    if os.path.exists(out_path):
        results = json.load(open(out_path)).get("cases", [])
    for nf in frame_counts:
        print(f"=== reference BA, 6 cams, {nf} frames ===", flush=True)
        r = run_case(6, nf)
        print(json.dumps(r, indent=2), flush=True)
        results.append(r)
        with open(out_path, "w") as f:
            json.dump(
                {
                    "description": "Measured reference (scipy TRF) BA performance on synthetic rigs; machine = this container's CPU",
                    "cases": results,
                },
                f,
                indent=2,
            )
    print("wrote", out_path)
