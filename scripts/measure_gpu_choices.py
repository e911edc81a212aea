"""Time the GPU candidates behind each backend choice and the response kernel.

Run on a machine with one NVIDIA GPU:

    python scripts/measure_gpu_choices.py [section ...]

Sections (all by default): ``env``, ``response``, ``detect``, ``ba``,
``init``, ``stages``. Each prints JSON lines; times are medians of
``block_until_ready``-timed repeats after a warm-up call. Exits non-zero
when JAX finds no GPU.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multicam_calibration_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(**kw):
    print(json.dumps(kw, default=float), flush=True)


def timed(fn, *args, reps=10):
    """(compile+first-call seconds, median steady seconds) of ``fn(*args)``."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------


def section_env():
    import importlib.util

    smi = shutil.which("nvidia-smi")
    card = None
    if smi:
        card = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
    mods = {
        m: importlib.util.find_spec(m) is not None
        for m in ("cv2", "h5py", "yaml", "matplotlib", "pandas", "imageio",
                  "scipy", "optax", "chex", "einops", "hypothesis")
    }
    libs = subprocess.run(
        "ldconfig -p | grep -E 'libav(format|codec|util)|libswscale' | head",
        shell=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    d = jax.devices()[0]
    emit(section="env", card=card, modules=mods, ffmpeg_libs=libs,
         nvcc=os.path.exists("/usr/local/cuda/bin/nvcc"),
         cache_env=os.environ.get("JAX_COMPILATION_CACHE_DIR"),
         platform=d.platform, kind=d.device_kind, count=len(jax.devices()),
         jax=jax.__version__)


# ---------------------------------------------------------------------------
# response candidates
# ---------------------------------------------------------------------------


def response_conv(gray, sigma):
    """(i) the five 1-channel convolutions."""
    from multicam_calibration_tpu.detection.detector import (
        corner_response_reference,
    )

    return corner_response_reference(gray, sigma)


def response_shift(gray, sigma):
    """(ii) shifted-slice sums (the package's corner_response)."""
    from multicam_calibration_tpu.detection.detector import corner_response

    return corner_response(gray, sigma)


def peaks_reduce_window(resp, n):
    win = 2 * n + 1
    m = lax.reduce_window(resp, -jnp.inf, lax.max, (1, win, win), (1, 1, 1),
                          "SAME")
    return (resp >= m) & (resp > 0)


def peaks_shift(resp):
    from multicam_calibration_tpu.detection.detector import _local_max_mask

    return _local_max_mask(resp, 4)


def section_response():
    from multicam_calibration_tpu.detection.detector import (
        corner_response_reference,
    )

    rng = np.random.default_rng(0)
    # Correctness at a real width, against the f64 conv reference.
    g = jnp.asarray(rng.uniform(0, 1, (4, 480, 640)), jnp.float32)
    for sigma in (1.5, 9.0):
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jax.jit(
                corner_response_reference, static_argnums=1
            )(g.astype(jnp.float64), sigma))
        scale = float(np.abs(ref).max())
        for name, fn in (("conv", response_conv), ("shift", response_shift)):
            f = jax.jit(functools.partial(fn, sigma=sigma))
            out = np.asarray(f(g), np.float64)
            err = float(np.abs(out - ref).max() / scale)
            emit(section="response_check", variant=name, sigma=sigma,
                 rel_err=err, limit=1e-5)
    cases = [(64, 480, 640, 1.5), (256, 480, 640, 1.5), (64, 480, 640, 9.0),
             (256, 480, 640, 9.0), (16, 1080, 1920, 1.5)]
    for B, H, W, sigma in cases:
        g = jnp.asarray(rng.uniform(0, 1, (B, H, W)), jnp.float32)
        for name, fn in (("conv", response_conv), ("shift", response_shift)):
            f = jax.jit(functools.partial(fn, sigma=sigma))
            c, t = timed(f, g)
            row = dict(section="response_time", variant=name, B=B, H=H, W=W,
                       sigma=sigma, compile_s=c, ms=t * 1e3)
            if H == 480:
                fp = jax.jit(lambda x, fn=fn: peaks_reduce_window(
                    fn(x, sigma), 4))
                fs = jax.jit(lambda x, fn=fn: peaks_shift(fn(x, sigma)))
                row["ms_with_reduce_window_nms"] = timed(fp, g)[1] * 1e3
                row["ms_with_shift_nms"] = timed(fs, g)[1] * 1e3
            emit(**row)
        del g


# ---------------------------------------------------------------------------
# end-to-end detection: response, batch size, stage-1 fusion
# ---------------------------------------------------------------------------


def _render(n_cams, n_frames, seed=0):
    import chip_smoke

    return chip_smoke.render_rig_frames(n_cams, n_frames, seed)


def section_detect(n_frames=1024, rounds=4):
    """End-to-end detection frames/s (detect_chessboard_batches over
    rendered 480x640 frames) per (response, batch size, stage-1 fusion),
    the configurations interleaved round by round."""
    import chip_smoke
    import multicam_calibration_tpu.detection.detector as det
    from multicam_calibration_tpu import backend

    frames, gts = _render(1, n_frames, seed=3)
    frames, gts = frames[0], gts[0]
    responses = {"shift": det.corner_response,
                 "conv": det.corner_response_reference}
    orig_choice = backend.detection_stage1_fused
    configs = [("shift", 256, True), ("shift", 256, False),
               ("shift", 64, True), ("shift", 64, False),
               ("conv", 256, True)]
    times = {c: [] for c in configs}
    for r in range(rounds):
        for cfg in (configs if r % 2 == 0 else configs[::-1]):
            name, bs, fused = cfg
            jax.clear_caches()
            det.corner_response = responses[name]
            backend.detection_stage1_fused = lambda platform, f=fused: f
            batches = [list(frames[i:i + bs]) for i in range(0, n_frames, bs)]
            list(det.detect_chessboard_batches(iter(batches[:2]),
                                               board_shape=(5, 7)))
            t0 = time.perf_counter()
            out = list(det.detect_chessboard_batches(iter(batches),
                                                     board_shape=(5, 7)))
            times[cfg].append(time.perf_counter() - t0)
            found = {}
            for k, d in enumerate(out):
                found.update({k * bs + j: v for j, v in d.items()})
            rate, err = chip_smoke.detection_metrics(found, gts)
            emit(section="detect_run", round=r, variant=name, batch=bs,
                 fused=fused, s=times[cfg][-1], fps=n_frames / times[cfg][-1],
                 rate=rate, median_rms_px=err)
    det.corner_response = responses["shift"]
    backend.detection_stage1_fused = orig_choice
    jax.clear_caches()
    for (name, bs, fused), ts in times.items():
        emit(section="detect_e2e", variant=name, batch=bs, fused=fused,
             fps_runs=[n_frames / t for t in ts],
             fps_median=n_frames / float(np.median(ts)))


# ---------------------------------------------------------------------------
# BA numerics: pure f64 vs the mixed recipe
# ---------------------------------------------------------------------------


def _baseline_problem():
    import multicam_calibration_tpu as mct
    from multicam_calibration_tpu.models.bundle_adjustment import (
        _params_to_arrays,
    )

    prob = np.load(os.path.join(ROOT, "BASELINE_PROBLEM.npz"))
    rig = mct.make_synthetic_rig(
        n_cameras=int(prob["n_cameras"]), n_frames=int(prob["n_frames"]),
        noise_px=0.3, dropout=0.25, seed=int(prob["seed"]),
    )
    ext, intr, poses, _ = mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=50,
    )
    use = prob["use_frames"]
    obs_np = rig.all_calib_uvs[:, use]
    dt = jnp.float64
    return (
        jnp.asarray(_params_to_arrays(ext, intr), dt),
        jnp.asarray(np.nan_to_num(np.asarray(poses)[use]), dt),
        jnp.asarray(np.nan_to_num(obs_np), dt),
        jnp.asarray(~np.isnan(obs_np).any(-1)),
        jnp.asarray(rig.calib_objpoints, dt),
    )


def _big_problem(n_cameras, n_frames, seed=5):
    import multicam_calibration_tpu as mct
    from multicam_calibration_tpu.models.bundle_adjustment import (
        _params_to_arrays,
    )

    rig = mct.make_synthetic_rig(
        n_cameras=n_cameras, n_frames=n_frames, noise_px=0.3, dropout=0.25,
        seed=seed,
    )
    rng = np.random.default_rng(seed)
    cam = _params_to_arrays(rig.all_extrinsics, rig.all_intrinsics)
    cam = cam + rng.standard_normal(cam.shape) * np.r_[
        np.full(6, 1e-3), np.full(3, 1e-3), np.full(3, 1.0)] * 0.1
    dt = jnp.float64
    obs_np = rig.all_calib_uvs
    return (
        jnp.asarray(cam, dt),
        jnp.asarray(rig.calib_poses, dt),
        jnp.asarray(np.nan_to_num(obs_np), dt),
        jnp.asarray(~np.isnan(obs_np).any(-1)),
        jnp.asarray(rig.calib_objpoints, dt),
    )


def section_ba():
    from multicam_calibration_tpu.models.lm_core import LMOptions, lm_solve

    args = _baseline_problem()
    # The mixed recipe: f32 J^T J blocks, Schur solve, per-try cost and
    # per-observation gradient products over f64 residuals.
    mixed = LMOptions(
        jac_dtype="float32", block_dtype="float32", cost_dtype="float32",
        solve_dtype="float32", grad_dtype="float32", gtol_rel=1e-6,
        lambda_escalation=3.0,
    )
    pure = LMOptions(jac_dtype="float32")
    for rep, seq in enumerate((("pure_f64", "mixed"), ("mixed", "pure_f64"))):
        for name in seq:
            opts = pure if name == "pure_f64" else mixed
            f = lambda c, opts=opts: lm_solve(c, *args[1:], opts)
            c, t = timed(f, args[0], reps=5)
            _, _, info = f(args[0])
            emit(section="ba_numerics", rep=rep, recipe=name, compile_s=c,
                 s=t, final_cost=float(info["final_cost"]),
                 n_iters=int(info["n_iters"]), limit=12338.04)


# ---------------------------------------------------------------------------
# init: camera-batched vs per-camera loop
# ---------------------------------------------------------------------------


def section_init():
    import multicam_calibration_tpu as mct
    from multicam_calibration_tpu import backend

    orig = backend.init_camera_batched
    for n_cams, n_frames in ((6, 1000), (6, 5000)):
        rig = mct.make_synthetic_rig(n_cameras=n_cams, n_frames=n_frames,
                                     noise_px=0.3, dropout=0.25, seed=11)
        for batched in (True, False, True, False):
            backend.init_camera_batched = lambda p, b=batched: b
            t0 = time.perf_counter()
            mct.calibrate(rig.all_calib_uvs, rig.img_sizes,
                          rig.calib_objpoints, verbose=False,
                          n_samples_for_intrinsics=50)
            emit(section="init", cams=n_cams, frames=n_frames,
                 batched=batched, s=time.perf_counter() - t0)
    backend.init_camera_batched = orig


# ---------------------------------------------------------------------------
# LM stage times from a profiler trace
# ---------------------------------------------------------------------------


def _stage_times(trace_dir):
    """Device milliseconds per jitted module (the ``hlo_module`` stat of
    each kernel event on the GPU's stream lines), and per line."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    per_module, per_line = {}, {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            tot = 0
            for ev in line.events:
                tot += ev.duration_ns
                if not line.name.startswith("Stream"):
                    continue
                mod = dict(ev.stats).get("hlo_module", ev.name)
                per_module[mod] = per_module.get(mod, 0) + ev.duration_ns
            per_line[line.name] = tot / 1e6
    return {k: v / 1e6 for k, v in per_module.items()}, per_line


def section_stages():
    from multicam_calibration_tpu.models.lm_core import (
        LMOptions, build_normal_blocks, compute_cost, schur_solve,
    )
    from multicam_calibration_tpu.ops.precision import with_highest_precision
    from multicam_calibration_tpu.utils.flops import lm_flop_model

    for n_cams, n_frames, chunk in ((6, 1000, None), (64, 20000, 1024)):
        args = _big_problem(n_cams, n_frames)
        opts = LMOptions(jac_dtype="float32", frame_chunk=chunk)
        cam, poses, obs, mask, objp = args

        @jax.jit
        @with_highest_precision
        def stage_build(cam, poses, obs, mask, objp):
            return build_normal_blocks(cam, poses, obs, mask, objp, opts)

        @jax.jit
        @with_highest_precision
        def stage_schur(blocks):
            return schur_solve(blocks, jnp.asarray(1e-3, cam.dtype))

        @jax.jit
        def stage_cost(cam, poses, obs, mask, objp):
            return compute_cost(cam, poses, obs, mask, objp, opts)

        build, solve, cost = stage_build, stage_schur, stage_cost

        blocks = build(*args)
        tb = timed(build, *args, reps=5)[1]
        ts = timed(solve, blocks, reps=5)[1]
        tc = timed(cost, *args, reps=5)[1]
        trace_dir = os.path.join(ROOT, "chiprun_out", f"trace_{n_cams}")
        with jax.profiler.trace(trace_dir):
            for _ in range(3):
                jax.block_until_ready(build(*args))
                jax.block_until_ready(solve(blocks))
                jax.block_until_ready(cost(*args))
        per_module, per_line = _stage_times(trace_dir)
        C, F, N = n_cams, n_frames, objp.shape[0]
        # Bytes a build must move at least: obs (f64 x2) + mask + W out.
        build_bytes = C * F * N * (2 * 8 + 1) + C * F * 72 * 8 + F * 36 * 8
        cost_bytes = C * F * N * (2 * 8 + 1)
        schur_flops = C * C * F * 2 * 12 * 12 * 6 + 2 * (12 * C) ** 3 // 3
        fm = lm_flop_model(C, F, N, 1, 1)
        build_flops = fm["jac_flops"] + fm["primal_flops"] + fm["assembly_flops"]
        emit(section="lm_stages", cams=C, frames=F, frame_chunk=chunk,
             wall_ms=dict(build=tb * 1e3, schur=ts * 1e3, cost=tc * 1e3),
             trace_device_ms_per_call={k: v / 3 for k, v in per_module.items()},
             trace_line_ms=per_line,
             build_min_bytes=build_bytes, cost_min_bytes=cost_bytes,
             schur_min_flops=schur_flops,
             build_hbm_roofline_share=build_bytes / 3.35e12 / tb,
             cost_hbm_roofline_share=cost_bytes / 3.35e12 / tc,
             schur_f64_roofline_share=schur_flops / 67e12 / ts,
             build_model_flops=build_flops,
             build_flop_roofline_share=build_flops / 67e12 / tb)
        del args, blocks


SECTIONS = dict(env=section_env, response=section_response,
                detect=section_detect, ba=section_ba, init=section_init,
                stages=section_stages)


def main(argv):
    if jax.devices()[0].platform != "gpu":
        sys.exit("measure_gpu_choices: no GPU visible to JAX")
    enable_compile_cache()
    for name in argv or list(SECTIONS):
        t0 = time.perf_counter()
        SECTIONS[name]()
        emit(section=name, done_s=time.perf_counter() - t0)


if __name__ == "__main__":
    main(sys.argv[1:])
