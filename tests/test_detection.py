"""Detection tests: device detector vs ground truth + cv2 oracle, video layer."""
import os

import numpy as np
import pytest

import multicam_calibration_tpu as mct
from multicam_calibration_tpu.detection.synthetic_images import (
    random_view_homography,
    render_board_view,
)

BOARD = (5, 7)


def make_view(seed, noise=1.5, **kw):
    rng = np.random.default_rng(seed)
    H = random_view_homography(rng, board_shape=BOARD, **kw)
    return render_board_view(
        H, out_size=(480, 640), board_shape=BOARD, noise=noise, seed=seed
    )


class TestDetector:
    def test_detection_rate_and_accuracy(self):
        n_ok = 0
        rms_all = []
        for seed in range(8):
            view, gt = make_view(seed)
            det = mct.detect_chessboard(view.astype(np.uint8), board_shape=BOARD)
            if det is None:
                continue
            uvs, scores = det
            d = np.linalg.norm(uvs[:, None] - gt[None], axis=-1)
            rms = np.sqrt((d.min(0) ** 2).mean())
            rms_all.append(rms)
            # Anchor-resolved orientation: corner 0 is the gt corner nearest
            # the anchor circle (gt index 0 by construction).
            if rms < 1.0 and np.linalg.norm(uvs[0] - gt[0]) < 2.0:
                n_ok += 1
        # Docs expectation is > 50% detection (troubleshooting.rst); we
        # require far better on clean synthetic views.
        assert n_ok >= 7, f"only {n_ok}/8 views detected+oriented correctly"
        assert np.median(rms_all) < 0.6

    def test_anchor_gap_rejects_ambiguity(self):
        # Without an anchor on the board, the four match scores are close
        # and the 0.2-gap rule must reject the detection.
        from multicam_calibration_tpu.detection.synthetic_images import (
            render_board_image,
        )
        import cv2

        rng = np.random.default_rng(3)
        H = random_view_homography(rng, board_shape=BOARD)
        canonical, corners = render_board_image(BOARD, 40, anchor=False)
        view = cv2.warpPerspective(canonical, H, (640, 480), borderValue=180.0)
        view = cv2.GaussianBlur(view, (0, 0), 1.0)
        det = mct.detect_chessboard(view.astype(np.uint8), board_shape=BOARD)
        assert det is None

    def test_subpixel_vs_cv2(self):
        import cv2

        view, gt = make_view(2, noise=0.5)
        det = mct.detect_chessboard(view.astype(np.uint8), board_shape=BOARD)
        assert det is not None
        uvs = det[0]
        ret, corners = cv2.findChessboardCorners(
            view.astype(np.uint8), BOARD, cv2.CALIB_CB_ADAPTIVE_THRESH
        )
        if ret:
            corners = cv2.cornerSubPix(
                view.astype(np.uint8),
                corners,
                (5, 5),
                (-1, -1),
                (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3),
            ).reshape(-1, 2)
            d_cv = np.linalg.norm(corners[:, None] - gt[None], axis=-1).min(0)
            d_us = np.linalg.norm(uvs[:, None] - gt[None], axis=-1).min(0)
            # Within 2x of cv2's subpixel accuracy on the same image.
            assert np.sqrt((d_us**2).mean()) < max(
                2 * np.sqrt((d_cv**2).mean()), 0.5
            )

    def test_scale_factor_coarse_find(self):
        """scale_factor<1 finds at low res and re-refines at full res (no
        cv2 dependency — jax.image.resize)."""
        view, gt = make_view(1)
        det = mct.detect_chessboard(
            view.astype(np.uint8), board_shape=BOARD, scale_factor=0.5
        )
        assert det is not None
        np.testing.assert_allclose(np.asarray(det[0]), gt, atol=1.0)

    def test_no_board_returns_none(self):
        rng = np.random.default_rng(0)
        img = (rng.uniform(0, 255, size=(480, 640))).astype(np.uint8)
        assert mct.detect_chessboard(img, board_shape=BOARD) is None

    def test_reorder_grid_flips(self):
        view, gt = make_view(4)
        det = mct.detect_chessboard(view.astype(np.uint8), board_shape=BOARD)
        assert det is not None
        uvs, scores = det
        # Rotating the image 180 degrees must yield the same physical
        # ordering (anchor-resolved), mapped through the rotation.
        rot = view[::-1, ::-1].copy()
        det_r = mct.detect_chessboard(rot.astype(np.uint8), board_shape=BOARD)
        assert det_r is not None
        uvs_r, _ = det_r
        h, w = view.shape
        mapped = np.stack([w - 1 - uvs_r[:, 0], h - 1 - uvs_r[:, 1]], axis=-1)
        np.testing.assert_allclose(mapped, uvs, atol=1.0)


def _import_reference_detection():
    """Import the reference's detection module with a vidio stub (the module
    imports vidio at top level; detect_chessboard itself never uses it)."""
    import importlib
    import sys
    import types

    if "refmcc.detection" in sys.modules:
        return sys.modules["refmcc.detection"]
    vid = types.ModuleType("vidio")
    vidr = types.ModuleType("vidio.read")
    vidr.OpenCVReader = object
    vid.read = vidr
    sys.modules.setdefault("vidio", vid)
    sys.modules.setdefault("vidio.read", vidr)
    pkg = types.ModuleType("refmcc")
    pkg.__path__ = ["/root/reference/multicam_calibration"]
    sys.modules["refmcc"] = pkg
    return importlib.import_module("refmcc.detection")


K_TEST = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
DIST_TEST = np.array([-0.28, 0.12])
HARD_KW = dict(
    camera_matrix=K_TEST, dist_coefs=DIST_TEST, lighting_gradient=0.8,
    vignette=0.4, clutter=6,
)


class TestRealisticImagery:
    """VERDICT r1: validate the detector on lens-distorted pixels, lighting
    gradients, clutter and occlusion — and against the reference's OpenCV
    detector on the SAME frames."""

    def _views(self, n, **kw):
        out = []
        for k in range(n):
            rng = np.random.default_rng(100 + k)
            H = random_view_homography(rng, board_shape=BOARD)
            out.append(
                render_board_view(
                    H, out_size=(480, 640), board_shape=BOARD, noise=2.0,
                    seed=k, **kw,
                )
            )
        return out

    def test_distorted_pixels_detection_and_accuracy(self):
        """Lens-distorted views: full detection rate, subpixel accuracy on
        the DISTORTED ground-truth corners (what a real camera delivers)."""
        errs = []
        for view, gt in self._views(8, camera_matrix=K_TEST, dist_coefs=DIST_TEST):
            det = mct.detect_chessboard(view.astype(np.uint8), board_shape=BOARD)
            assert det is not None
            d = np.linalg.norm(det[0][:, None] - gt[None], axis=-1)
            errs.append(np.sqrt((d.min(0) ** 2).mean()))
        assert np.median(errs) < 0.6

    def test_hard_frames_beat_reference_rate(self):
        """Distortion + lighting gradient + vignette + clutter: detection
        rate must be >= the reference's cv2 detector on identical frames,
        and accepted detections must be real (err bounded)."""
        ref_det = _import_reference_detection()
        views = self._views(16, **HARD_KW)
        n_ref = n_us = 0
        errs = []
        for view, gt in views:
            v8 = view.astype(np.uint8)
            n_ref += (
                ref_det.detect_chessboard(
                    np.stack([v8] * 3, -1), board_shape=BOARD
                )
                is not None
            )
            det = mct.detect_chessboard(v8, board_shape=BOARD)
            if det is not None:
                n_us += 1
                d = np.linalg.norm(det[0][:, None] - gt[None], axis=-1)
                errs.append(d.min(0).mean())
        assert n_us >= n_ref, f"ours {n_us}/16 vs reference {n_ref}/16"
        assert n_us >= 10
        assert np.max(errs) < 5.0  # no wildly corrupted accepted grids

    def test_lighting_gradient_invariance(self):
        """The docstring claim behind discarding adaptive_threshold /
        normalize_image: the saddle response + detrended anchor correlation
        are invariant to strong lighting gradients."""
        for (view, gt), (hview, hgt) in zip(
            self._views(4), self._views(4, lighting_gradient=0.9, vignette=0.5)
        ):
            det = mct.detect_chessboard(
                hview.astype(np.uint8), board_shape=BOARD,
                adaptive_threshold=False, normalize_image=False,
            )
            assert det is not None
            d = np.linalg.norm(det[0][:, None] - hgt[None], axis=-1)
            assert np.sqrt((d.min(0) ** 2).mean()) < 1.0

    def test_occlusion_rejects_or_detects_cleanly(self):
        """A bar across the board either hides corners (-> None) or leaves
        enough for a correct detection — never a corrupted grid."""
        for view, gt in self._views(6, occlusion_px=25):
            det = mct.detect_chessboard(view.astype(np.uint8), board_shape=BOARD)
            if det is not None:
                d = np.linalg.norm(det[0][:, None] - gt[None], axis=-1)
                assert d.min(0).mean() < 5.0

    def test_occlusion_escalation_rescues_occluded_block(self):
        """Hard-set frame 8: clutter occludes a contiguous 5-corner block
        (no saddle exists there at any scale — unrescuable by candidate
        search or the coarse ladder). The relaxed-hole-budget retry must
        detect it accurately, with occluded cells settled back onto their
        homography predictions rather than wandered refinements."""
        rng = np.random.default_rng(108)
        H = random_view_homography(rng, board_shape=BOARD)
        view, gt = render_board_view(
            H, out_size=(480, 640), board_shape=BOARD, noise=2.0, seed=8,
            **HARD_KW,
        )
        det = mct.detect_chessboard(view.astype(np.uint8), board_shape=BOARD)
        assert det is not None, "escalation should rescue the occluded frame"
        d = np.linalg.norm(np.asarray(det[0])[:, None] - gt[None], axis=-1)
        assert d.min(0).mean() < 1.0
        assert d.min(0).max() < 2.5  # filled cells stay homography-close

    def test_two_bar_occlusion_repaired_by_homography_refit(self):
        """Two thin occluding bars: their edge pseudo-corners sit within the
        BFS admission tolerance of the killed cells, so the grown lattice
        absorbs them and every window fails the smoothness/homography gates
        even though candidate recall is near-perfect. The escalated-retry
        homography-refit repair must snap the window back onto the true
        corners (sweep frames 11505/11511/11520, where cv2 also fails)."""
        n_found, errs = 0, []
        for seed in (11505, 11511, 11520):
            rng = np.random.default_rng(seed)
            H = random_view_homography(rng, board_shape=BOARD)
            view, gt = render_board_view(
                H, out_size=(480, 640), board_shape=BOARD, noise=2.0,
                seed=seed, occlusion_px=10, occlusion_bars=2,
            )
            det = mct.detect_chessboard(
                view.astype(np.uint8), board_shape=BOARD
            )
            if det is not None:
                n_found += 1
                d = np.linalg.norm(
                    np.asarray(det[0])[:, None] - gt[None], axis=-1
                )
                errs.append(d.min(0).mean())
        assert n_found >= 2, f"repair rescued only {n_found}/3 two-bar frames"
        assert np.max(errs) < 1.0  # repaired grids are true grids

    def test_settle_constructed_keeps_converged_restores_wandered(self):
        from multicam_calibration_tpu.detection.detector import (
            _settle_constructed,
        )

        pred = np.zeros((4, 2))
        refined = np.array(
            [[0.4, 0.3], [2.5, 1.5], [2.8, 0.0], [0.2, -0.1]]
        )
        con = np.array([True, True, False, False])
        out = _settle_constructed(refined, pred, con, tol=1.5)
        np.testing.assert_allclose(out[0], refined[0])  # converged: kept
        np.testing.assert_allclose(out[1], pred[1])  # wandered: restored
        np.testing.assert_allclose(out[2:], refined[2:])  # measured: kept

    def test_subpix_winsize_forwarded(self):
        """subpix_winSize must actually change the refinement (ADVICE r1:
        it was accepted and dropped)."""
        view, gt = self._views(1)[0]
        a = mct.detect_chessboard(
            view.astype(np.uint8), board_shape=BOARD, subpix_winSize=(3, 3)
        )
        b = mct.detect_chessboard(
            view.astype(np.uint8), board_shape=BOARD, subpix_winSize=(9, 9)
        )
        assert a is not None and b is not None
        assert not np.array_equal(a[0], b[0])
        for det in (a, b):
            d = np.linalg.norm(det[0][:, None] - gt[None], axis=-1)
            assert np.sqrt((d.min(0) ** 2).mean()) < 1.0


class TestVideoLayer:
    def _frames(self, n, seed0=0):
        frames = []
        gts = []
        for k in range(n):
            view, gt = make_view(seed0 + k)
            frames.append(view.astype(np.uint8))
            gts.append(gt)
        return frames, gts

    def test_process_video_cache(self, tmp_path):
        frames, gts = self._frames(3)
        video_path = str(tmp_path / "camA.mp4")
        save = mct.process_video(
            video_path,
            mct.detect_chessboard,
            {"board_shape": BOARD},
            frames=frames,
        )
        import h5py

        with h5py.File(save, "r") as h5:
            assert h5["uvs"].shape[1:] == (35, 2)
            assert "qc_data" in h5
            assert tuple(h5["img_size"][:]) == (640, 480)

    def test_run_calibration_detection(self, tmp_path):
        frames_a, _ = self._frames(3, seed0=0)
        frames_b, _ = self._frames(3, seed0=10)
        paths = [str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")]
        uvs, img_sizes = mct.run_calibration_detection(
            paths,
            mct.detect_chessboard,
            {"board_shape": BOARD},
            all_frames=[frames_a, frames_b],
        )
        assert uvs.shape == (2, 3, 35, 2)
        assert img_sizes == [(640, 480), (640, 480)]
        # Caches are reused on rerun (no frames needed).
        uvs2, _ = mct.run_calibration_detection(
            paths, mct.detect_chessboard, {"board_shape": BOARD},
            all_frames=[frames_a, frames_b],
        )
        np.testing.assert_array_equal(
            np.isnan(uvs), np.isnan(uvs2)
        )

    def test_plot_chessboard_qc_data(self, tmp_path):
        import matplotlib

        matplotlib.use("Agg")
        frames, _ = self._frames(3)
        video_path = str(tmp_path / "camQ.mp4")
        mct.process_video(
            video_path, mct.detect_chessboard, {"board_shape": BOARD},
            frames=frames,
        )
        fig = mct.plot_chessboard_qc_data([video_path])
        assert fig is not None
        import matplotlib.pyplot as plt

        plt.close(fig)
        import pytest

        with pytest.raises(FileNotFoundError):
            mct.plot_chessboard_qc_data([str(tmp_path / "missing.mp4")])

    def test_summarize_detections(self):
        uvs = np.full((2, 5, 4, 2), np.nan)
        uvs[0, :3] = 0.0
        uvs[1, 2:] = 0.0
        table = mct.summarize_detections(uvs)
        assert table.values[0, 0] == 3
        assert table.values[1, 1] == 3
        assert table.values[0, 1] == 1


def test_batches_generator_matches_batch():
    """detect_chessboard_batches (double-buffered pipeline) yields
    element-identical results to detect_chessboard_batch, including empty
    batches mid-stream."""
    from multicam_calibration_tpu.detection.detector import (
        detect_chessboard_batch,
        detect_chessboard_batches,
    )

    batches = []
    for b in range(3):
        fr = []
        for k in range(6):
            rng = np.random.default_rng(100 * b + k)
            H = random_view_homography(rng, board_shape=BOARD)
            v, _ = render_board_view(
                H, out_size=(480, 640), board_shape=BOARD, noise=1.5, seed=k
            )
            fr.append(np.asarray(v).astype(np.uint8))
        batches.append(fr)

    seq = [detect_chessboard_batch(fr, board_shape=BOARD) for fr in batches]
    pip = list(detect_chessboard_batches(iter(batches), board_shape=BOARD))
    assert len(pip) == 3
    for s, p in zip(seq, pip):
        assert s.keys() == p.keys()
        for k in s:
            np.testing.assert_array_equal(s[k][0], p[k][0])
            np.testing.assert_array_equal(s[k][1], p[k][1])
    # Empty batch mid-stream yields {} in-order.
    pip2 = list(
        detect_chessboard_batches(
            iter([batches[0], [], batches[1]]), board_shape=BOARD
        )
    )
    assert len(pip2) == 3 and pip2[1] == {}
    assert pip2[0].keys() == seq[0].keys()
    assert pip2[2].keys() == seq[1].keys()


class TestWindowRobustness:
    """Unit tests for the hard-frame machinery: hole-tolerant windows,
    multi-window hypotheses, and the homography-outlier grid check."""

    def _clean_candidates(self, seed=0, n_clutter=40):
        """Integer candidate set = distorted GT corners + random clutter."""
        from multicam_calibration_tpu.detection.synthetic_images import (
            random_view_homography,
        )

        rng = np.random.default_rng(seed)
        H = random_view_homography(rng, board_shape=BOARD)
        # project canonical lattice through H like the renderer does
        cols, rows = BOARD[1], BOARD[0]
        import multicam_calibration_tpu as _m

        ys, xs = np.mgrid[0:cols, 0:rows]
        can = np.stack([xs, ys], -1).reshape(-1, 2).astype(float)
        from multicam_calibration_tpu.ops.homography import apply_homography

        uv = np.asarray(apply_homography(H, can * 40.0 + 100.0))
        clutter = rng.uniform(20, 600, (n_clutter, 2))
        # keep clutter off the board corners
        d = np.linalg.norm(clutter[:, None] - uv[None], axis=-1)
        clutter = clutter[d.min(1) > 12]
        pts = np.concatenate([uv, clutter])
        sc = np.concatenate(
            [rng.uniform(0.8, 1.0, len(uv)), rng.uniform(0.3, 0.6, len(clutter))]
        )
        return np.round(pts), sc, uv

    def test_hole_filling_recovers_missing_corners(self):
        from multicam_calibration_tpu.detection.detector import (
            order_grid_points,
        )

        pts, sc, uv = self._clean_candidates(seed=1)
        # delete two interior true corners from the candidate set
        keep = np.ones(len(pts), bool)
        keep[[10, 22]] = False
        got = order_grid_points(pts[keep], sc[keep], BOARD, refined=False)
        assert got is not None
        d = np.linalg.norm(got[:, None] - uv[None], axis=-1).min(1)
        # filled corners come from the window homography: within ~2 px of
        # the true (homography-consistent) lattice
        assert d.max() < 2.5, d.max()

    def test_n_windows_returns_distinct_hypotheses(self):
        from multicam_calibration_tpu.detection.detector import (
            order_grid_points,
        )

        pts, sc, uv = self._clean_candidates(seed=2)
        wins = order_grid_points(
            pts, sc, BOARD, refined=False, n_windows=3
        )
        assert isinstance(wins, list) and len(wins) >= 1
        for w in wins:
            assert w.shape == (BOARD[0] * BOARD[1], 2)
        if len(wins) > 1:  # distinct cell sets
            assert not np.allclose(wins[0], wins[1])
        # and n_windows=1 keeps the legacy single-array return type
        one = order_grid_points(pts, sc, BOARD, refined=False)
        np.testing.assert_array_equal(one, wins[0])

    def test_homography_outlier_rejects_substituted_corner(self):
        from multicam_calibration_tpu.detection.detector import (
            _grid_smoothness_ok,
        )

        pts, sc, uv = self._clean_candidates(seed=3)
        cols, rows = BOARD[1], BOARD[0]
        grid = uv.reshape(cols, rows, 2).copy()
        assert _grid_smoothness_ok(grid)
        bad = grid.copy()
        bad[3, 2] += (4.0, -3.0)  # one clutter-substituted corner
        assert not _grid_smoothness_ok(bad)

    def test_repair_grid_fixes_lone_outlier(self):
        """_repair_grid re-predicts a drifted cell from local homography
        fits: the repaired position lands near the true corner and the
        returned mask flags exactly that cell."""
        from multicam_calibration_tpu.detection.detector import (
            _grid_smoothness_ok,
            _repair_grid,
        )

        _, _, uv = self._clean_candidates(seed=4)
        cols, rows = BOARD[1], BOARD[0]
        grid = uv.reshape(cols, rows, 2).copy()
        bad = grid.copy()
        bad[2, 3] += (3.5, -2.0)  # a dim corner whose refinement wandered
        assert not _grid_smoothness_ok(bad)
        rep = _repair_grid(bad)
        assert rep is not None
        repaired, mask = rep
        assert mask.sum() == 1 and mask[2, 3]
        assert np.linalg.norm(repaired[2, 3] - grid[2, 3]) < 0.5
        assert _grid_smoothness_ok(repaired, mask)

    def test_repair_grid_refuses_broken_window(self):
        """More than max_outliers corrupted cells = not a repair candidate."""
        from multicam_calibration_tpu.detection.detector import _repair_grid

        _, _, uv = self._clean_candidates(seed=5)
        cols, rows = BOARD[1], BOARD[0]
        bad = uv.reshape(cols, rows, 2).copy()
        for k, (i, j) in enumerate([(0, 0), (1, 2), (3, 1), (4, 4), (6, 3)]):
            bad[i, j] += (3.0 + k, -2.5)
        assert _repair_grid(bad) is None

    def test_constructed_mask_loosens_validity_for_filled_cells(self):
        """A ~2 px-off cell vetoes a window when measured, but passes when
        marked constructed (hole fills carry distortion bias + the tight
        re-refine clamp by design)."""
        from multicam_calibration_tpu.detection.detector import (
            _grid_smoothness_ok,
        )

        _, _, uv = self._clean_candidates(seed=6)
        cols, rows = BOARD[1], BOARD[0]
        grid = uv.reshape(cols, rows, 2).copy()
        grid[3, 2] += (1.4, 1.2)
        con = np.zeros((cols, rows), bool)
        assert not _grid_smoothness_ok(grid, con)
        con[3, 2] = True
        assert _grid_smoothness_ok(grid, con)
        # but constructed cells are bounded, not exempt
        grid[3, 2] += (4.0, 4.0)
        assert not _grid_smoothness_ok(grid, con)

    def test_weak_pseudo_corners_counted_as_holes(self):
        """Cells far below the window's median saddle score (boundary
        pseudo-corners) count as holes: the returned window replaces them
        with homography predictions and flags them in the mask."""
        from multicam_calibration_tpu.detection.detector import (
            order_grid_points,
        )

        pts, sc, uv = self._clean_candidates(seed=7)
        sc = sc.copy()
        # Make two true-corner candidates look like pseudo-corners (weak
        # score) at a slightly corrupted position.
        pts = np.asarray(pts, float)
        for j in (8, 17):
            sc[j] = 0.1
            pts[j] += (2.5, -2.0)
        got = order_grid_points(
            pts, sc, BOARD, refined=False, n_windows=2, return_masks=True
        )
        assert got, "window should survive weak cells via hole tolerance"
        uvs, mask = got[0]
        assert mask.sum() >= 2
        d = np.linalg.norm(uvs[:, None] - uv[None], axis=-1).min(1)
        # weak cells were re-predicted from the homography, not taken at
        # their corrupted positions
        assert d.max() < 1.5, d.max()


class TestDeviceFastPath:
    """The fused stage-1 device lattice ordering (detector._order_grids_device):
    certified (ok=True) windows must be EXACTLY the window the host BFS
    would produce, and uncertifiable frames must defer (ok=False) rather
    than emit a wrong grid."""

    def _stack(self, n, hard=False, **kw):
        frames, gts = [], []
        for k in range(n):
            rng = np.random.default_rng(200 + k)
            H = random_view_homography(rng, board_shape=BOARD)
            v, gt = render_board_view(
                H, out_size=(480, 640), board_shape=BOARD, noise=2.0,
                seed=k, **(HARD_KW if hard else kw)
            )
            frames.append(np.asarray(v).astype(np.uint8))
            gts.append(gt)
        return np.stack(frames), gts

    def _order_both(self, stack):
        import jax
        import jax.numpy as jnp
        from multicam_calibration_tpu.detection.detector import (
            _find_candidates,
            _gray_from_u8,
            _order_grids_device,
        )

        gray = _gray_from_u8(jnp.asarray(stack))
        xy_d, sc_d = _find_candidates(gray, 160, 4)
        rows, cols = BOARD
        uvf, okf = jax.jit(
            lambda x, s: _order_grids_device(x, s, rows, cols)
        )(xy_d, sc_d)
        return np.asarray(xy_d), np.asarray(sc_d), np.asarray(uvf), np.asarray(okf)

    def _assert_certified_match_host(self, xy, sc, uvf, okf):
        from multicam_calibration_tpu.detection.detector import (
            order_grid_points,
        )

        n_checked = 0
        for i in range(len(okf)):
            if not okf[i]:
                continue
            host = order_grid_points(
                xy[i], sc[i], BOARD, refined=False, n_windows=1
            )
            assert host is not None, f"frame {i}: fast ok but host found none"
            fu = np.asarray(uvf[i].reshape(-1, 2), float)
            hu = np.asarray(host, float)
            o1 = np.lexsort((fu[:, 1], fu[:, 0]))
            o2 = np.lexsort((hu[:, 1], hu[:, 0]))
            assert np.allclose(fu[o1], hu[o2]), f"frame {i}: window mismatch"
            n_checked += 1
        return n_checked

    def test_clean_frames_all_certified_and_match_host(self):
        stack, _ = self._stack(8)
        xy, sc, uvf, okf = self._order_both(stack)
        assert okf.all(), f"clean frames must all take the fast path: {okf}"
        assert self._assert_certified_match_host(xy, sc, uvf, okf) == 8

    def test_distorted_frames_certified_and_match_host(self):
        stack, gts = self._stack(8, camera_matrix=K_TEST, dist_coefs=DIST_TEST)
        xy, sc, uvf, okf = self._order_both(stack)
        assert okf.sum() >= 6, f"distorted frames should mostly certify: {okf}"
        self._assert_certified_match_host(xy, sc, uvf, okf)
        # certified windows land on the distorted GT corners
        for i in np.nonzero(okf)[0]:
            d = np.linalg.norm(
                uvf[i].reshape(-1, 2)[:, None] - gts[i][None], axis=-1
            )
            assert d.min(1).max() < 4.0

    def test_hard_frames_certified_subset_matches_host(self):
        stack, _ = self._stack(12, hard=True)
        xy, sc, uvf, okf = self._order_both(stack)
        # hard frames may defer — but every certification must be right
        self._assert_certified_match_host(xy, sc, uvf, okf)

    def test_occluded_frames_defer(self):
        stack, _ = self._stack(6, occlusion_px=30)
        xy, sc, uvf, okf = self._order_both(stack)
        from multicam_calibration_tpu.detection.detector import (
            order_grid_points,
        )

        for i in np.nonzero(okf)[0]:
            # any certified occluded frame must still agree with the host
            host = order_grid_points(
                xy[i], sc[i], BOARD, refined=False, n_windows=1
            )
            assert host is not None

    def test_batch_results_match_per_frame_path(self):
        """detect_chessboard_batch (fast path live) agrees with the
        single-frame host path on clean frames."""
        stack, _ = self._stack(6)
        batch = mct.detect_chessboard_batch(list(stack), board_shape=BOARD)
        for i, frame in enumerate(stack):
            single = mct.detect_chessboard(frame, board_shape=BOARD)
            assert (i in batch) == (single is not None)
            if single is not None:
                np.testing.assert_allclose(
                    np.asarray(batch[i][0], float),
                    np.asarray(single[0], float),
                    atol=0.3,
                )


def test_normalized_anchor_rescue_under_vignette():
    """A vignetted frame whose grid is perfect but whose anchor margin is
    washed out by quadratic shading (the per-region linear detrend cannot
    remove it) must be rescued by re-scoring the anchors on a locally
    normalized image — and must NOT be detected with normalize_image=False
    (proving the flag gates real behavior, reference detection.py:369-373)."""
    rng = np.random.default_rng(106)  # frame 6 of the hard-frame bench set
    H = random_view_homography(rng, board_shape=BOARD)
    view, gt = render_board_view(
        H, out_size=(480, 640), board_shape=BOARD, noise=2.0, seed=6,
        **HARD_KW,
    )
    v8 = view.astype(np.uint8)
    assert mct.detect_chessboard(v8, board_shape=BOARD,
                                 normalize_image=False) is None
    det = mct.detect_chessboard(v8, board_shape=BOARD, normalize_image=True)
    assert det is not None, "normalized-anchor rescue should accept this frame"
    d = np.linalg.norm(np.asarray(det[0])[:, None] - gt[None], axis=-1)
    assert d.min(0).mean() < 1.0
    # batch path applies the same rescue
    batch = mct.detect_chessboard_batch([v8], board_shape=BOARD)
    assert 0 in batch
    np.testing.assert_allclose(
        np.asarray(batch[0][0], float), np.asarray(det[0], float), atol=0.5
    )


@pytest.mark.parametrize("board", [(7, 10), (4, 4), (3, 5)])
def test_device_fast_path_other_board_shapes(board):
    """Fast-path/host window agreement holds across board shapes: the
    reference default (7, 10), a square board (orientation ties), and a
    small (3, 5)."""
    import jax
    import jax.numpy as jnp
    from multicam_calibration_tpu.detection.detector import (
        _find_candidates,
        _gray_from_u8,
        _order_grids_device,
        order_grid_points,
    )

    rows, cols = board
    frames = []
    for k in range(4):
        rng = np.random.default_rng(k)
        H = random_view_homography(
            rng, board_shape=board,
            scale_range=(0.35, 0.55) if board == (7, 10) else (0.45, 0.8),
        )
        v, _ = render_board_view(
            H, out_size=(480, 640), board_shape=board, noise=1.5, seed=k
        )
        frames.append(np.asarray(v).astype(np.uint8))
    gray = _gray_from_u8(jnp.asarray(np.stack(frames)))
    xy_d, sc_d = _find_candidates(gray, 160, 4)
    xy = np.asarray(xy_d)
    sc = np.asarray(sc_d)
    uvf, okf = jax.jit(
        lambda x, s: _order_grids_device(x, s, rows, cols)
    )(xy_d, sc_d)
    uvf = np.asarray(uvf)
    okf = np.asarray(okf)
    assert okf.all()
    for i in range(len(frames)):
        host = order_grid_points(xy[i], sc[i], board, refined=False, n_windows=1)
        assert host is not None
        fu = np.asarray(uvf[i].reshape(-1, 2), float)
        hu = np.asarray(host, float)
        o1 = np.lexsort((fu[:, 1], fu[:, 0]))
        o2 = np.lexsort((hu[:, 1], hu[:, 0]))
        np.testing.assert_allclose(fu[o1], hu[o2])


def test_device_fast_path_rejects_random_clutter():
    """Pure clutter clouds (no board) must never be certified by the
    device fast path."""
    import jax
    import jax.numpy as jnp
    from multicam_calibration_tpu.detection.detector import (
        _order_grids_device,
    )

    rows, cols = BOARD
    rng = np.random.default_rng(0)
    B, K = 32, 160
    xy = rng.uniform(20, 600, (B, K, 2)).astype(np.float32)
    sc = np.sort(
        rng.uniform(0.1, 1.0, (B, K)).astype(np.float32), axis=1
    )[:, ::-1].copy()
    _, okf = jax.jit(
        lambda x, s: _order_grids_device(x, s, rows, cols)
    )(jnp.asarray(xy), jnp.asarray(sc))
    assert not np.asarray(okf).any()


def test_motion_blur_detection_matches_reference():
    """Coarse-scale retry ladder: detection rate under motion blur must
    match the reference's blur-robust cv2 quad detector on identical
    frames (sigma=1.5 saddles alone collapse by 12 px blur), and accepted
    detections must stay sub-pixel-accurate on the sharp ground truth."""
    ref_det = _import_reference_detection()
    for blur in (12, 16):
        n_us = n_ref = 0
        errs = []
        for k in range(8):
            rng = np.random.default_rng(300 + k)
            H = random_view_homography(rng, board_shape=BOARD)
            v, gt = render_board_view(
                H, out_size=(480, 640), board_shape=BOARD, noise=2.0,
                seed=k, motion_blur_px=blur,
            )
            v8 = v.astype(np.uint8)
            n_ref += (
                ref_det.detect_chessboard(
                    np.stack([v8] * 3, -1), board_shape=BOARD
                )
                is not None
            )
            det = mct.detect_chessboard(v8, board_shape=BOARD)
            if det is not None:
                n_us += 1
                d = np.linalg.norm(
                    np.asarray(det[0])[:, None] - gt[None], axis=-1
                )
                errs.append(d.min(0).mean())
        assert n_us >= n_ref, f"blur {blur}: ours {n_us}/8 vs ref {n_ref}/8"
        assert np.mean(errs) < 1.0, f"blur {blur}: mean err {np.mean(errs)}"


class TestFusedStage1:
    def test_fused_stage1_matches_unfused(self):
        """The single-dispatch stage-1 program (_stage1_fused — one jit
        wrapping candidates + device ordering + refine + anchor scores)
        must be numerically identical to the three-call path: fusion only
        moves the jit boundary, never the math."""
        import jax.numpy as jnp
        from multicam_calibration_tpu.detection.detector import (
            _gray_from_u8,
            _stage1_fused,
            _stage1_impl,
        )

        frames = []
        for k in range(4):
            rng = np.random.default_rng(300 + k)
            H = random_view_homography(rng, board_shape=BOARD)
            v, _ = render_board_view(
                H, out_size=(480, 640), board_shape=BOARD, noise=2.0, seed=k
            )
            frames.append(np.asarray(v).astype(np.uint8))
        gray = _gray_from_u8(jnp.asarray(np.stack(frames)))
        rows, cols = BOARD
        a = _stage1_impl(gray, 160, 4, rows, cols, 40, 5)
        b = _stage1_fused(gray, 160, 4, rows, cols, 40, 5)
        for x, y, name in zip(a, b, ("xy", "score", "grids", "sc4", "ok")):
            np.testing.assert_allclose(
                np.asarray(x, np.float64), np.asarray(y, np.float64),
                rtol=1e-6, atol=1e-6, err_msg=name,
            )
