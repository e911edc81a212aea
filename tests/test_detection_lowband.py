"""Low-bandwidth batch detection (coarse stages at 1/f resolution,
full-res accuracy from per-corner patches): parity with the full-res
batch path.

The path exists because streaming throughput over a narrow host->device
link is bytes-bound; ``coarse_downscale=f`` cuts uploaded bytes ~f^2-fold. These tests pin the
contract that accuracy does NOT degrade: the final subpixel refinement
always runs on full-resolution pixels.
"""
import numpy as np
import pytest

import multicam_calibration_tpu as mct
from multicam_calibration_tpu.detection.detector import (
    _decimate_u8,
    detect_chessboard_batch,
    detect_chessboard_batches,
)
from multicam_calibration_tpu.detection.synthetic_images import (
    random_view_homography,
    render_board_view,
)

BOARD = (5, 7)


def _views(n, seed0, **kw):
    frames, gts = [], []
    for k in range(n):
        rng = np.random.default_rng(seed0 + k)
        H = random_view_homography(rng, board_shape=BOARD)
        view, gt = render_board_view(
            H, out_size=(480, 640), board_shape=BOARD, noise=1.5,
            seed=seed0 + k, **kw,
        )
        frames.append(np.asarray(view).astype(np.uint8))
        gts.append(gt)
    return frames, gts


def _gt_err(det, gt):
    d = np.linalg.norm(np.asarray(det[0])[:, None] - gt[None], axis=-1)
    return float(d.min(0).mean())


class TestDecimate:
    def test_box_mean_gray(self):
        rng = np.random.default_rng(0)
        f = rng.integers(0, 256, (2, 8, 12), dtype=np.uint8)
        low = _decimate_u8(f, 2)
        assert low.shape == (2, 4, 6)
        blk = f[:, :8, :12].reshape(2, 4, 2, 6, 2).astype(np.uint16)
        want = (blk.sum(axis=(2, 4)) + 2) // 4
        np.testing.assert_array_equal(low, want.astype(np.uint8))

    def test_box_mean_rgb_and_crop(self):
        rng = np.random.default_rng(1)
        f = rng.integers(0, 256, (1, 9, 13, 3), dtype=np.uint8)
        low = _decimate_u8(f, 3)
        assert low.shape == (1, 3, 4, 3)
        blk = f[:, :9, :12].reshape(1, 3, 3, 4, 3, 3).astype(np.uint16)
        want = (blk.sum(axis=(2, 4)) + 4) // 9
        np.testing.assert_array_equal(low, want.astype(np.uint8))


class TestLowbandParity:
    @pytest.fixture(scope="class")
    def clean(self):
        frames, gts = _views(6, 3100)
        full = detect_chessboard_batch(frames, board_shape=BOARD)
        return frames, gts, full

    @pytest.mark.parametrize("f", [2, 3])
    def test_clean_matches_fullres(self, clean, f):
        frames, gts, full = clean
        low = detect_chessboard_batch(
            frames, board_shape=BOARD, coarse_downscale=f
        )
        assert set(low) == set(full) == set(range(len(frames)))
        for i in full:
            # Identical anchor orientation and sub-0.25 px corner agreement:
            # both paths' final refinement ran on the same full-res pixels.
            d = np.linalg.norm(
                np.asarray(low[i][0]) - np.asarray(full[i][0]), axis=-1
            )
            assert d.max() < 0.25, f"frame {i} f={f}: max dev {d.max():.3f}"

    def test_accuracy_vs_ground_truth(self, clean):
        frames, gts, full = clean
        low = detect_chessboard_batch(
            frames, board_shape=BOARD, coarse_downscale=2
        )
        for i in full:
            e_low = _gt_err(low[i], gts[i])
            e_full = _gt_err(full[i], gts[i])
            assert e_low <= e_full + 0.05, (i, e_low, e_full)

    def test_rgb_frames(self, clean):
        frames, gts, full = clean
        rgb = [np.stack([f] * 3, -1) for f in frames[:2]]
        low = detect_chessboard_batch(
            rgb, board_shape=BOARD, coarse_downscale=2
        )
        assert set(low) == {0, 1}
        for i in low:
            d = np.linalg.norm(
                np.asarray(low[i][0]) - np.asarray(full[i][0]), axis=-1
            )
            assert d.max() < 0.3

    def test_streaming_matches_batch(self, clean):
        frames, gts, full = clean
        batches = [frames[:3], [], frames[3:]]
        pip = list(
            detect_chessboard_batches(
                iter(batches), board_shape=BOARD, coarse_downscale=2
            )
        )
        assert len(pip) == 3 and not pip[1]
        seq = [
            detect_chessboard_batch(
                b, board_shape=BOARD, coarse_downscale=2
            ) if b else {}
            for b in batches
        ]
        for got, want in zip(pip, seq):
            assert set(got) == set(want)
            for i in got:
                np.testing.assert_allclose(got[i][0], want[i][0], atol=1e-6)


class TestLowbandEscalation:
    def test_boardless_and_hard_frames(self):
        """A pure-noise frame stays undetected (no false positive from the
        escalation), while hard frames the low-res pass loses are recovered
        by the full-res escalation."""
        K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
        frames, gts = _views(
            4, 3200, camera_matrix=K, dist_coefs=np.array([-0.28, 0.12]),
            lighting_gradient=0.8, vignette=0.4, clutter=6,
        )
        rng = np.random.default_rng(5)
        frames.append(rng.integers(0, 256, frames[0].shape, dtype=np.uint8))
        full = detect_chessboard_batch(frames, board_shape=BOARD)
        low = detect_chessboard_batch(
            frames, board_shape=BOARD, coarse_downscale=2
        )
        assert 4 not in low  # noise frame never detected
        # No rate regression vs the full-res path (frames the low-res pass
        # loses escalate to exactly that path), and no corrupted grids.
        assert (set(full) - {4}).issubset(set(low))
        for i in low:
            assert _gt_err(low[i], gts[i]) < 2.0
