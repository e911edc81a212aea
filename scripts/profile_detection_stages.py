"""Stage-level timing of detect_chessboard_batch (r2 detection work).

Splits one batch into: device stage 1 (gray + fused response/NMS + subpix),
host lattice ordering (order_grid_points per frame), device stage 2
(batched anchor scores) + host flips. Identifies whether the pipeline is
transfer-, device-, or host-bound before optimizing.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 32
BOARD = (5, 7)


def main():
    import jax
    import jax.numpy as jnp

    from multicam_calibration_tpu.detection.detector import (
        _batched_anchor_scores,
        _find_candidates,
        _gray_from_u8,
        _refine_and_score,
        order_grid_points,
    )
    from multicam_calibration_tpu.detection.synthetic_images import (
        random_view_homography,
        render_board_view,
    )

    frames = []
    for k in range(BATCH):
        rng = np.random.default_rng(k)
        H = random_view_homography(rng, board_shape=BOARD)
        view, _ = render_board_view(
            H, out_size=(480, 640), board_shape=BOARD, noise=1.5, seed=k
        )
        frames.append(np.asarray(view).astype(np.uint8))
    stack = np.stack(frames)

    def timed(label, fn, reps=5):
        fn()  # warm
        walls = []
        for _ in range(reps):
            t0 = time.time()
            fn()
            walls.append(time.time() - t0)
        w = float(np.median(walls))
        print(f"{label:34s} {w*1e3:8.1f} ms  ({BATCH/w:7.1f} fps)", flush=True)
        return w

    # Transfer: host -> device of the frame stack alone.
    dev = jax.devices()[0]

    def xfer():
        a = jax.device_put(stack, dev)
        a.block_until_ready()
        np.asarray(a[0, 0, 0])

    t_x = timed("h2d transfer (9.8 MB)", xfer)

    gray = _gray_from_u8(jnp.asarray(stack))
    np.asarray(gray[0, 0, 0])

    def stage1():
        g = _gray_from_u8(jnp.asarray(stack))
        xy, score = _find_candidates(g, 160, 4)
        return np.asarray(xy), np.asarray(score)

    t1 = timed("device: gray+response+NMS+topK", stage1)
    refined, score = stage1()

    def host_order():
        out = []
        for i in range(BATCH):
            out.append(order_grid_points(refined[i], score[i], BOARD))
        return out

    t2 = timed("host: order_grid_points x32", host_order)
    grids_l = host_order()

    cols, rows = BOARD[1], BOARD[0]
    grids = np.stack([np.asarray(g).reshape(cols, rows, 2) for g in grids_l])

    def stage2():
        gr, s = _refine_and_score(gray, jnp.asarray(grids, gray.dtype), 40, 5)
        return np.asarray(gr), np.asarray(s)

    t3 = timed("device: fused refine+anchor scores", stage2)
    total = t1 + t2 + t3
    print(
        f"sum {total*1e3:.1f} ms -> {BATCH/total:.1f} fps "
        f"(device1 {t1/total:.0%}, host {t2/total:.0%}, device2 {t3/total:.0%})"
    )

    # Fast path (r2): device lattice ordering folds ordering + refinement
    # + anchor scoring into stage 1 — certified frames need no host work.
    from multicam_calibration_tpu.detection.detector import (
        _batch_finish,
        _stage1_fast,
    )

    def fast_stage1():
        s1 = _stage1_fast(gray, 160, 4, BOARD[0], BOARD[1], 40, 5)
        return tuple(np.asarray(a) for a in s1)

    t4 = timed("device: FAST stage1 (ord+ref+score)", fast_stage1)
    s1_dev = (gray,) + tuple(_stage1_fast(gray, 160, 4, BOARD[0], BOARD[1], 40, 5))
    n_ok = int(np.asarray(s1_dev[5]).sum())

    def fast_finish():
        return _batch_finish(s1_dev, BATCH, BOARD, True, 0.2, 40, 5)

    t5 = timed("host: batch_finish on fast stage1", fast_finish)
    print(
        f"FAST pipeline {(t4 + t5)*1e3:.1f} ms -> {BATCH/(t4 + t5):.1f} fps "
        f"({n_ok}/{BATCH} device-certified)"
    )


if __name__ == "__main__":
    main()
