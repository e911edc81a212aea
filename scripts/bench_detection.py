"""Detection throughput benchmark: frames/s through the batched device
pipeline (shift-add corner response + NMS/top-K + subpixel on device,
lattice ordering + anchor decisions on host), MEASURED against the
reference's cv2 detector (detection.py:300 findChessboardCorners +
cornerSubPix + anchor reorder) on the identical frames.

The reference parallelizes with a per-video worker pool (detection.py:80-112)
that scales linearly in cores; we measure its single-core rate and report the
pool-extrapolated rate at this machine's core count as the honest baseline.
Prints one JSON record.
"""
import importlib
import json
import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 32
ROUNDS = 4
BOARD = (5, 7)


def measure_reference(frames):
    """Single-core fps of the reference detector on ``frames``."""
    # The reference detection module imports vidio/pandas/tqdm at top level
    # for its video IO; stub the ones this image lacks — detect_chessboard
    # itself only needs cv2 + numpy.
    for name in ("vidio", "vidio.read", "pandas", "tqdm"):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            if name == "vidio.read":
                mod.OpenCVReader = object
            sys.modules[name] = mod
    _pkg = types.ModuleType("refmcc")
    _pkg.__path__ = ["/root/reference/multicam_calibration"]
    sys.modules.setdefault("refmcc", _pkg)
    ref_det = importlib.import_module("refmcc.detection")

    out = ref_det.detect_chessboard(frames[0], board_shape=BOARD)  # warm
    t0 = time.time()
    n_det = 0
    for frame in frames:
        out = ref_det.detect_chessboard(frame, board_shape=BOARD)
        n_det += out is not None
    wall = time.time() - t0
    return len(frames) / wall, n_det / len(frames)


def measure_decode_fps(frames, n_frames=600, fps_meta=30.0):
    """Host-side decode rate (frames/s, one stream): write the bench
    frames as a realistic-bitrate mp4, then time batched reads over it.
    This is the producer half of a co-located deployment (decode thread
    feeding device batches).

    Returns (fps or None, impl string): the native C++ loader when
    available, else cv2 (labeled) — the projection keys must exist in the
    artifact either way (r4 shipped without them because the native
    measurement silently returned None)."""
    import tempfile

    from multicam_calibration_tpu.detection.native_video import (
        NativeVideoReader,
        NativeVideoWriter,
        available,
    )

    h, w = frames[0].shape[:2]
    path = tempfile.mktemp(suffix=".mp4", prefix="mcc_decbench_")

    def _write_native():
        wr = NativeVideoWriter(
            path, w, h, fps=fps_meta, gray=True,
            bit_rate=int(w * h * fps_meta * 0.12),
        )
        for i in range(n_frames):
            f = frames[i % len(frames)]
            wr.write(f if f.ndim == 2 else f[..., 0])
        wr.close()

    def _write_cv2():
        import cv2

        wr = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps_meta, (w, h), False
        )
        if not wr.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for i in range(n_frames):
            f = frames[i % len(frames)]
            wr.write(f if f.ndim == 2 else f[..., 0])
        wr.release()

    def _read_native():
        rd = NativeVideoReader(path, gray=True)
        rd.read_batch(32)  # warm the decode thread/ring
        t0 = time.time()
        got = 32
        while True:
            b = rd.read_batch(64)
            got += len(b)
            if len(b) < 64:
                break
        return (got - 32) / (time.time() - t0)

    def _read_cv2():
        import cv2

        cap = cv2.VideoCapture(path)
        for _ in range(32):  # warm
            cap.read()
        t0 = time.time()
        got = 0
        while True:
            ret, _f = cap.read()
            if not ret:
                break
            got += 1
        cap.release()
        return got / (time.time() - t0)

    try:
        if available():
            try:
                _write_native()
                return _read_native(), "native"
            except Exception as e:  # noqa: BLE001 - fall through to cv2
                print(f"decode bench: native path failed ({e}); trying cv2",
                      flush=True)
        else:
            print("decode bench: libmccvideo unavailable; trying cv2",
                  flush=True)
        try:
            _write_cv2()
            if available():
                return _read_native(), "native-read/cv2-write"
            return _read_cv2(), "cv2"
        except Exception as e:  # noqa: BLE001 - report, don't crash bench
            print(f"decode bench: cv2 fallback failed too ({e})", flush=True)
            return None, "unavailable"
    finally:
        if os.path.exists(path):
            os.unlink(path)


def main():
    import multicam_calibration_tpu as mct
    from multicam_calibration_tpu.detection.synthetic_images import (
        random_view_homography,
        render_board_view,
    )
    import jax

    frames = []
    for k in range(BATCH):
        rng = np.random.default_rng(k)
        H = random_view_homography(rng, board_shape=BOARD)
        view, _ = render_board_view(
            H, out_size=(480, 640), board_shape=BOARD, noise=1.5, seed=k
        )
        frames.append(np.asarray(view).astype(np.uint8))

    from multicam_calibration_tpu.detection.detector import (
        detect_chessboard_batches,
    )

    def measure(batch, rounds, coarse_downscale=1):
        """Pipelined throughput (the production process_video shape):
        device stage k+1 dispatched before host ordering of batch k.
        Every round's frames differ (fresh sensor noise) so no relay/cache
        layer can short-circuit a repeated upload or computation."""
        rng = np.random.default_rng(7)
        batches = [
            [
                np.clip(
                    f.astype(np.int16)
                    + rng.integers(-2, 3, f.shape, dtype=np.int16),
                    0,
                    255,
                ).astype(np.uint8)
                for f in frames * (batch // BATCH)
            ]
            for _ in range(rounds)
        ]
        # warm-up compiles the device stages for this batch shape
        next(
            detect_chessboard_batches(
                iter(batches[:1]), board_shape=BOARD,
                coarse_downscale=coarse_downscale,
            )
        )
        t0 = time.time()
        n_det = 0
        for found in detect_chessboard_batches(
            iter(batches), board_shape=BOARD,
            coarse_downscale=coarse_downscale,
        ):
            n_det += len(found)
        wall = time.time() - t0
        return batch * rounds / wall, n_det / (batch * rounds)

    # Full-res path at two batch sizes, plus the low-bandwidth path
    # (coarse stages at 1/f res, full-res accuracy from per-corner
    # patches): on a narrow host->device link the latter is the shape a
    # production deployment would run, uploading ~1/f^2 of the bytes.
    results = {}
    for batch, f in ((32, 1), (128, 1), (128, 2), (128, 3)):
        key = f"{batch}" if f == 1 else f"{batch}/ds{f}"
        fps_b, rate_b = measure(batch, ROUNDS, coarse_downscale=f)
        results[key] = (fps_b, rate_b)
        print(
            f"batch {key}: {fps_b:.1f} fps, rate {rate_b:.3f}", flush=True
        )
    # Headline: fastest config that holds full detection rate.
    ok = {k: v for k, v in results.items() if v[1] >= 1.0} or results
    best_batch = max(ok, key=lambda b: ok[b][0])
    fps, rate = results[best_batch]

    # Device-resident rate: frames already in device memory (batched
    # stage 1 + host ordering + batched anchor stage; no bulk image
    # upload) — the pipeline's intrinsic rate without the host->device
    # copy.
    import jax.numpy as jnp

    from multicam_calibration_tpu.detection.detector import (
        _batch_finish,
        _gray_from_u8,
        _stage1_fast,
    )

    # Batch-size scan.
    import jax as _jax

    def measure_device_resident(dbatch):
        stack = np.stack(frames * (dbatch // BATCH))
        gray = _gray_from_u8(jnp.asarray(stack))
        np.asarray(gray[0, 0, 0])  # staged

        # Distinct per-round noise added ON DEVICE (the point is to
        # exclude the bulk host->device upload, not to let a cache skip
        # the compute).
        keys = _jax.random.split(_jax.random.PRNGKey(3), ROUNDS)
        noisy = [
            gray + 2.0 * _jax.random.normal(k, gray.shape, gray.dtype)
            for k in keys
        ]

        # One-step lookahead like the production pipeline: next round's
        # stage 1 dispatched before this round's host ordering.
        def dr_stage1(g):
            # Fast-path stage 1 (candidates + device lattice ordering +
            # refine + anchor scores): certified frames need no further
            # device work.
            return (g,) + tuple(
                _stage1_fast(g, 160, 4, BOARD[0], BOARD[1], 40, 5)
            )

        def dr_finish(s1):
            return _batch_finish(s1, dbatch, BOARD, True, 0.2, 40, 5)

        dr_finish(dr_stage1(noisy[0]))  # warm
        t0 = time.time()
        n_det_d = 0
        prev = dr_stage1(noisy[0])
        for g in noisy[1:]:
            cur = dr_stage1(g)
            n_det_d += len(dr_finish(prev))
            prev = cur
        n_det_d += len(dr_finish(prev))
        wall_d = time.time() - t0
        return dbatch * ROUNDS / wall_d, n_det_d / (dbatch * ROUNDS)

    dev_results = {}
    for dbatch in (128, 256, 512):
        fps_b, rate_b = measure_device_resident(dbatch)
        dev_results[dbatch] = (fps_b, rate_b)
        print(
            f"device-resident batch {dbatch}: {fps_b:.1f} fps, "
            f"rate {rate_b:.3f}",
            flush=True,
        )
    dev_ok = {
        b: v for b, v in dev_results.items() if v[1] >= 1.0
    } or dev_results
    dbatch = max(dev_ok, key=lambda b: dev_ok[b][0])
    fps_dev, rate_dev = dev_results[dbatch]

    ref_fps_core, ref_rate = measure_reference(frames)
    n_cores = os.cpu_count() or 1
    ref_fps_pool = ref_fps_core * n_cores

    # Projection: the pipeline is producer/consumer — decode thread(s)
    # feed device batches, stages overlap, so end-to-end fps = min(decode
    # rate, device-resident detection rate). Decode rate measured on THIS
    # host's native C++ loader, per stream; a 6-camera rig runs 6
    # independent decode threads.
    decode_fps, decode_impl = measure_decode_fps(frames)
    if decode_fps is not None:
        proj_1cam = min(decode_fps, fps_dev)
        proj_6cam = min(6 * decode_fps, fps_dev)
        print(
            f"decode {decode_fps:.1f} fps/stream; projected co-located "
            f"end-to-end {proj_1cam:.1f} fps (1 stream) / "
            f"{proj_6cam:.1f} fps (6-cam rig)",
            flush=True,
        )

    # Hard regime: lens distortion + lighting gradient + vignette + clutter
    # (the conditions real calibration videos actually have). Both detectors
    # run on identical frames; rate matters as much as fps here.
    K_hard = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    hard_frames = []
    for k in range(BATCH):
        rng = np.random.default_rng(500 + k)
        H = random_view_homography(rng, board_shape=BOARD)
        view, _ = render_board_view(
            H, out_size=(480, 640), board_shape=BOARD, noise=2.0, seed=k,
            camera_matrix=K_hard, dist_coefs=np.array([-0.28, 0.12]),
            lighting_gradient=0.8, vignette=0.4, clutter=6,
        )
        hard_frames.append(np.asarray(view).astype(np.uint8))
    found = mct.detect_chessboard_batch(hard_frames, board_shape=BOARD)
    t0 = time.time()
    n_hard = 0
    for _ in range(ROUNDS):
        n_hard += len(
            mct.detect_chessboard_batch(hard_frames, board_shape=BOARD)
        )
    hard_fps = BATCH * ROUNDS / (time.time() - t0)
    hard_rate = n_hard / (BATCH * ROUNDS)
    ref_hard_fps, ref_hard_rate = measure_reference(hard_frames)
    print(
        f"hard frames: ours {hard_fps:.1f} fps rate {hard_rate:.3f} | "
        f"reference {ref_hard_fps:.1f} fps/core rate {ref_hard_rate:.3f}",
        flush=True,
    )
    rec = {
        "frames_per_s": round(fps, 2),
        "batch": best_batch,
        "rounds": ROUNDS,
        "detection_rate": round(rate, 3),
        "per_batch_fps": {str(b): round(results[b][0], 2) for b in results},
        "per_batch_rate": {
            str(b): round(results[b][1], 3) for b in results
        },
        "device_resident_fps": round(fps_dev, 2),
        "device_resident_rate": round(rate_dev, 3),
        "device_resident_batch": int(dbatch),
        "device_resident_per_batch": {
            str(b): [round(v[0], 2), round(v[1], 3)]
            for b, v in dev_results.items()
        },
        "image": "480x640 synthetic board views",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "reference_fps_per_core": round(ref_fps_core, 2),
        "reference_fps_pool_extrapolated": round(ref_fps_pool, 2),
        "reference_detection_rate": round(ref_rate, 3),
        "n_cores": n_cores,
        # Host-fed vs the core pool, and the memory-apples-to-apples
        # number: both detectors with frames already in their working
        # memory (cv2 reads host RAM; ours reads device memory).
        "vs_reference_pool": round(fps / ref_fps_pool, 2),
        "vs_reference_core_device_resident": round(fps_dev / ref_fps_core, 2),
        # The reference tutorial's actual deployment is a 6-worker pool
        # (reference detection.py:80-112, tutorial cell 2) — compare
        # against that regardless of this container's core count.
        "reference_fps_6worker": round(6 * ref_fps_core, 2),
        "vs_reference_6worker_device_resident": round(
            fps_dev / (6 * ref_fps_core), 2
        ),
        # Co-located projection: decode (host C++ loader, per stream)
        # overlapped with device-resident detection.
        **(
            {
                "decode_fps_per_stream": round(decode_fps, 2),
                "decode_impl": decode_impl,
                "projected_colocated_fps_1cam": round(
                    min(decode_fps, fps_dev), 2
                ),
                "projected_colocated_fps_6cam_rig": round(
                    min(6 * decode_fps, fps_dev), 2
                ),
                "projected_colocated_vs_reference_pool": round(
                    min(6 * decode_fps, fps_dev) / ref_fps_pool, 2
                ),
            }
            if decode_fps is not None
            else {}
        ),
        "hard_frames": {
            "fps": round(hard_fps, 2),
            "detection_rate": round(hard_rate, 3),
            "reference_fps_per_core": round(ref_hard_fps, 2),
            "reference_detection_rate": round(ref_hard_rate, 3),
        },
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
