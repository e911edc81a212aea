"""Init + bundle-adjustment tests on synthetic rigs with known ground truth."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import multicam_calibration_tpu as mct
from multicam_calibration_tpu.models import initialize as init
from multicam_calibration_tpu.models.lm_core import LMOptions, lm_solve, compute_cost
from multicam_calibration_tpu.synthetic import _t6_to_T, _T_to_t6


def relative_extrinsics(ext):
    """Gauge-free representation: each camera relative to camera 0."""
    T0_inv = np.linalg.inv(_t6_to_T(ext[0]))
    return np.stack([_T_to_t6(_t6_to_T(e) @ T0_inv) for e in ext])


@pytest.fixture(scope="module")
def rig():
    return mct.make_synthetic_rig(
        n_cameras=3, n_frames=60, noise_px=0.3, dropout=0.2, seed=1
    )


@pytest.fixture(scope="module")
def clean_rig():
    return mct.make_synthetic_rig(
        n_cameras=3, n_frames=60, noise_px=0.0, dropout=0.1, seed=2
    )


class TestIntrinsics:
    def test_zhang_plus_lm_recovers_intrinsics(self, clean_rig):
        c = 1
        K_true, dist_true = clean_rig.all_intrinsics[c]
        K, dist = init.get_intrinsics(
            clean_rig.all_calib_uvs[c],
            clean_rig.calib_objpoints,
            clean_rig.img_sizes[c],
            n_samples=40,
        )
        np.testing.assert_allclose(K[0, 0], K_true[0, 0], rtol=1e-4)
        np.testing.assert_allclose(K[1, 1], K_true[1, 1], rtol=1e-4)
        np.testing.assert_allclose(K[0, 2], K_true[0, 2], atol=1.0)
        np.testing.assert_allclose(K[1, 2], K_true[1, 2], atol=1.0)
        np.testing.assert_allclose(dist[0], dist_true[0], atol=1e-3)
        np.testing.assert_allclose(dist[1], dist_true[1], atol=1e-2)

    def test_noisy_intrinsics_reasonable(self, rig):
        c = 2
        K_true, _ = rig.all_intrinsics[c]
        K, dist = init.get_intrinsics(
            rig.all_calib_uvs[c], rig.calib_objpoints, rig.img_sizes[c], n_samples=40
        )
        # Single-camera calibration from 40 noisy frames: a few percent.
        assert abs(K[0, 0] - K_true[0, 0]) / K_true[0, 0] < 0.05

    def test_field_validity_gate(self):
        """The basin guard must never switch to a field-invalid alt: a
        compensating fit (huge focal + huge k1/k2) can reach a LOWER sample
        cost while its radial model stops being invertible inside the
        image."""
        sane = [900.0, 900.0, 320.0, 240.0, -0.12, 0.03]
        degenerate = [1651.5, 1651.5, 320.0, 240.0, 25.5, -669.2]
        assert init._intrinsics_field_valid(sane, (640, 480))
        assert not init._intrinsics_field_valid(degenerate, (640, 480))
        assert not init._intrinsics_field_valid([np.nan] * 6, (640, 480))
        assert not init._intrinsics_field_valid(
            [-900.0, 900.0, 320.0, 240.0, 0.0, 0.0], (640, 480)
        )

    def test_basin_guard_never_degrades_to_degenerate_fit(self):
        """Regression (r2): on the 4-cam seed-5 rig, the weak-diversity
        camera's alt refine reaches lower cost with k1=25/k2=-669 — an
        un-invertible model the guard used to accept, collapsing the
        pipeline (select_ba_frames kept 10/50 frames). The guard must keep
        a usable init: whatever basin it picks, distortion stays physical
        enough for downstream BA."""
        r = mct.make_synthetic_rig(
            n_cameras=4, n_frames=50, noise_px=0.4, dropout=0.2, seed=5
        )
        K, dist = init.get_intrinsics(
            r.all_calib_uvs[2], r.calib_objpoints, r.img_sizes[2],
            n_samples=20,
        )
        assert abs(dist[0]) < 2.0 and abs(dist[1]) < 20.0

    def test_batched_matches_sequential(self, rig):
        """get_intrinsics_batch == per-camera get_intrinsics (the
        camera-batched path must produce the same calibration the per-camera
        loop does)."""
        batched = init.get_intrinsics_batch(
            rig.all_calib_uvs, rig.calib_objpoints, rig.img_sizes, n_samples=40
        )
        for c in range(len(rig.all_calib_uvs)):
            K_s, d_s = init.get_intrinsics(
                rig.all_calib_uvs[c],
                rig.calib_objpoints,
                rig.img_sizes[c],
                n_samples=40,
            )
            K_b, d_b = batched[c]
            # The batched solve is lockstep (extra no-op iterations after a
            # camera converges) so agreement is to optimizer tolerance, not
            # bitwise.
            np.testing.assert_allclose(K_b, K_s, rtol=1e-3, atol=1e-2)
            np.testing.assert_allclose(d_b, d_s, rtol=1e-2, atol=1e-4)


class TestPose:
    def test_estimate_pose_matches_cv2(self, rig):
        import cv2

        c = 1
        K, dist = rig.all_intrinsics[c]
        uvs = rig.all_calib_uvs[c]
        poses = np.asarray(
            init.estimate_pose(uvs, rig.calib_objpoints, K, dist)
        )
        valid = ~np.isnan(uvs).any((1, 2))
        assert np.all(np.isnan(poses[~valid]))
        for f in np.nonzero(valid)[0][:10]:
            ok, rvec, tvec = cv2.solvePnP(
                rig.calib_objpoints, uvs[f], K, dist
            )
            assert ok
            oracle = np.concatenate([rvec.ravel(), tvec.ravel()])
            np.testing.assert_allclose(poses[f], oracle, atol=0.5)

    def test_batched_matches_sequential(self, rig):
        """estimate_pose_batch == per-camera estimate_pose exactly (pure
        vmap of the same fixed-iteration program — no lockstep slack)."""
        Ks = [k for k, _ in rig.all_intrinsics]
        Ds = [d for _, d in rig.all_intrinsics]
        batched = np.asarray(
            init.estimate_pose_batch(
                rig.all_calib_uvs, rig.calib_objpoints, Ks, Ds
            )
        )
        for c in range(len(rig.all_calib_uvs)):
            seq = np.asarray(
                init.estimate_pose(
                    rig.all_calib_uvs[c], rig.calib_objpoints, Ks[c], Ds[c]
                )
            )
            assert np.array_equal(np.isnan(batched[c]), np.isnan(seq))
            m = np.isfinite(seq)
            np.testing.assert_allclose(batched[c][m], seq[m], atol=1e-10)

    def test_pose_reprojects(self, clean_rig):
        c = 0
        K, dist = clean_rig.all_intrinsics[c]
        uvs = clean_rig.all_calib_uvs[c]
        poses = np.asarray(
            init.estimate_pose(uvs, clean_rig.calib_objpoints, K, dist)
        )
        valid = ~np.isnan(uvs).any((1, 2))
        f = np.nonzero(valid)[0][0]
        pred = np.asarray(
            mct.project_points(
                mct.apply_rigid_transform(
                    jnp.asarray(poses[f]), jnp.asarray(clean_rig.calib_objpoints)
                ),
                jnp.zeros(6),
                jnp.asarray(K),
                jnp.asarray(dist),
            )
        )
        np.testing.assert_allclose(pred, uvs[f], atol=1e-3)


class TestSpanningTree:
    def test_tree_structure(self):
        # Camera 1 shares frames with 0 and 2; 0-2 share nothing.
        poses = np.full((3, 10, 6), np.nan)
        poses[0, :6] = 0.0
        poses[1, 2:8] = 0.0
        poses[2, 5:] = 0.0
        tree = init.get_camera_spanning_tree(poses, root=0)
        assert tree == [(0, 1), (1, 2)]

    def test_extrinsics_chain(self, rig):
        all_poses = np.stack(
            [
                np.asarray(
                    init.estimate_pose(
                        rig.all_calib_uvs[c], rig.calib_objpoints, *rig.all_intrinsics[c]
                    )
                )
                for c in range(rig.n_cameras)
            ]
        )
        ext, tree = init.estimate_all_extrinsics(all_poses)
        np.testing.assert_allclose(ext[0], 0.0, atol=1e-12)
        rel_est = relative_extrinsics(ext)
        rel_true = relative_extrinsics(rig.all_extrinsics)
        np.testing.assert_allclose(rel_est[:, :3], rel_true[:, :3], atol=0.01)
        np.testing.assert_allclose(rel_est[:, 3:], rel_true[:, 3:], atol=5.0)


class TestCalibrate:
    def test_end_to_end_init(self, rig):
        ext, intr, poses, tree = mct.calibrate(
            rig.all_calib_uvs,
            rig.img_sizes,
            rig.calib_objpoints,
            verbose=False,
            n_samples_for_intrinsics=40,
        )
        rel_est = relative_extrinsics(ext)
        rel_true = relative_extrinsics(rig.all_extrinsics)
        # Init stage: rotations within ~0.05 rad, translations within ~5%.
        np.testing.assert_allclose(rel_est[:, :3], rel_true[:, :3], atol=0.05)
        assert (
            np.linalg.norm(rel_est[:, 3:] - rel_true[:, 3:], axis=-1).max()
            / np.linalg.norm(rel_true[1, 3:])
            < 0.05
        )
        # Consensus poses exist wherever any camera saw the board.
        seen = (~np.isnan(rig.all_calib_uvs).any((-1, -2))).any(0)
        assert np.all(~np.isnan(poses[seen]))

    def test_batched_init_repair_writes_poses(self, monkeypatch):
        """Regression (r4): the accelerator-batched calibrate path produced
        all_calib_poses as np.asarray(jax_array) — a READ-ONLY view — and
        _repair_bad_intrinsics' in-place row write crashed whenever a
        camera needed repair. Force the batched path on CPU with a
        corrupted camera and require calibrate to complete AND repair."""
        from multicam_calibration_tpu import backend
        from multicam_calibration_tpu.models import initialize as init_mod

        rig4 = mct.make_synthetic_rig(
            n_cameras=4, n_frames=60, noise_px=0.2, dropout=0.1, seed=5
        )
        real_batch = init_mod.get_intrinsics_batch

        def corrupted_batch(*a, **k):
            # Corrupt a LEAF camera (3): fx off 35% makes it rig-
            # inconsistent while the peer median stays clean (corrupting
            # the spanning-tree root instead contaminates the consensus
            # poses of every camera and the 3x-median trigger cannot fire
            # — a known limitation of the repair heuristic).
            intr = list(real_batch(*a, **k))
            K, d = intr[3]
            K = np.array(K)
            K[0, 0] *= 1.35
            intr[3] = (K, np.array(d))
            return intr

        monkeypatch.setattr(init_mod, "get_intrinsics_batch", corrupted_batch)
        monkeypatch.setattr(backend, "init_camera_batched", lambda p: True)
        ext, intr, poses, tree = init_mod.calibrate(
            rig4.all_calib_uvs, rig4.img_sizes, rig4.calib_objpoints,
            verbose=False, n_samples_for_intrinsics=30,
        )
        # The repair pass must have replaced the corrupted fx.
        assert abs(intr[3][0][0, 0] - rig4.all_intrinsics[3][0][0, 0]) < (
            0.05 * rig4.all_intrinsics[3][0][0, 0]
        )


class TestBundleAdjust:
    @pytest.fixture(scope="class")
    def ba_result(self, rig):
        ext, intr, poses, _ = mct.calibrate(
            rig.all_calib_uvs,
            rig.img_sizes,
            rig.calib_objpoints,
            verbose=False,
            n_samples_for_intrinsics=40,
        )
        adj = mct.bundle_adjust(
            rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses,
            verbose=False,
        )
        return ext, intr, poses, adj

    def test_cost_decreases(self, ba_result):
        _, _, _, (adj_ext, adj_intr, adj_poses, use_frames, res) = ba_result
        assert res["final_cost"] < res["initial_cost"]
        assert res["n_iters"] >= 1

    def test_rmse_at_noise_floor(self, rig, ba_result):
        _, _, _, (adj_ext, adj_intr, adj_poses, use_frames, res) = ba_result
        pred = np.asarray(
            mct.predict_calib_uvs(
                adj_ext, adj_intr, rig.calib_objpoints, adj_poses
            )
        )
        err = np.linalg.norm(rig.all_calib_uvs[:, use_frames] - pred, axis=-1)
        rmse = np.sqrt(np.nanmean(err**2))
        # Noise is 0.3 px/axis -> point-error floor ~0.42 px.
        assert rmse < 0.5

    def test_recovers_rig_geometry(self, rig, ba_result):
        _, _, _, (adj_ext, adj_intr, adj_poses, use_frames, res) = ba_result
        rel_est = relative_extrinsics(adj_ext)
        rel_true = relative_extrinsics(rig.all_extrinsics)
        np.testing.assert_allclose(rel_est[:, :3], rel_true[:, :3], atol=0.01)
        # ~0.5% of the 1.25 m rig radius: the statistical limit for 53
        # frames at 0.3 px noise (scipy TRF reaches the same cost basin,
        # see test_matches_scipy_trf_quality).
        assert np.linalg.norm(rel_est[:, 3:] - rel_true[:, 3:], axis=-1).max() < 8.0

    def test_serialize_roundtrip(self, rig):
        ext = rig.all_extrinsics
        intr = rig.all_intrinsics
        poses = rig.calib_poses
        x = mct.serialize_params(ext, intr, poses)
        assert x.shape == (12 * rig.n_cameras + 6 * rig.n_frames,)
        ext2, intr2, poses2 = mct.deserialize_params(x, rig.n_cameras)
        np.testing.assert_allclose(ext2, ext)
        np.testing.assert_allclose(poses2, poses)
        for (K1, d1), (K2, d2) in zip(intr, intr2):
            np.testing.assert_allclose(K2, K1)
            np.testing.assert_allclose(d2[:2], d1[:2])

    def test_matches_scipy_trf_quality(self, rig):
        """Our LM must reach (at least) scipy TRF's cost on the same problem."""
        from scipy.optimize import least_squares

        ext, intr, poses, _ = mct.calibrate(
            rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
            verbose=False, n_samples_for_intrinsics=40,
        )
        full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
        use = np.nonzero(full.sum(0) > 1)[0]
        obs = rig.all_calib_uvs[:, use]
        x0 = mct.serialize_params(ext, intr, np.asarray(poses)[use])
        A = mct.bundle_adjustment_sparsity(obs)
        res_scipy = least_squares(
            mct.residuals, x0, jac_sparsity=A, verbose=0,
            x_scale="jac", ftol=1e-4, method="trf", loss="soft_l1",
            args=(obs, rig.calib_objpoints),
        )
        adj = mct.bundle_adjust(
            rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses,
            outlier_threshold=np.inf, verbose=False,
        )
        ours_cost = float(adj[4]["final_cost"])
        # within 2% of scipy's converged robust cost (ftol=1e-4 both)
        assert ours_cost <= res_scipy.cost * 1.02


    def test_pose_repair_recovers_corrupted_frame(self, rig, ba_result):
        """_repair_bad_poses re-solves a frame pose stranded in a bad basin
        (soft-L1 caps its cost so plain LM can converge around it)."""
        from multicam_calibration_tpu.models.bundle_adjustment import (
            _params_to_arrays,
            _repair_bad_poses,
        )
        from multicam_calibration_tpu.models.lm_core import LMOptions

        _, _, _, (adj_ext, adj_intr, adj_poses, use_frames, res) = ba_result
        cam = jnp.asarray(_params_to_arrays(adj_ext, adj_intr))
        obs_np = rig.all_calib_uvs[:, use_frames]
        mask = jnp.asarray(~np.isnan(obs_np).any(-1))
        obs = jnp.asarray(np.nan_to_num(obs_np))
        objp = jnp.asarray(rig.calib_objpoints)
        poses_bad = np.asarray(adj_poses).copy()
        poses_bad[3] += np.array([1.5, -0.8, 0.6, 300.0, -200.0, 150.0])
        fixed, n = _repair_bad_poses(
            cam, jnp.asarray(poses_bad), obs, mask, objp, LMOptions()
        )
        assert n >= 1
        np.testing.assert_allclose(
            np.asarray(fixed)[3], np.asarray(adj_poses)[3], atol=2e-2
        )
        # Healthy poses untouched.
        np.testing.assert_allclose(
            np.asarray(fixed)[4:], np.asarray(poses_bad)[4:], atol=1e-7
        )

    def test_jac_dtype_f32_matches_f64(self, rig):
        """jac_dtype='float32' (f32 Jacobians, f64 gradient/solve) must
        reproduce the pure-f64 optimum — the bench runs this mode."""
        from multicam_calibration_tpu.models.bundle_adjustment import (
            _params_to_arrays,
        )
        from multicam_calibration_tpu.models.lm_core import lm_solve

        ext, intr, poses, _ = mct.calibrate(
            rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
            verbose=False, n_samples_for_intrinsics=40,
        )
        full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
        use = np.nonzero(full.sum(0) > 1)[0]
        obs_np = rig.all_calib_uvs[:, use]
        mask = jnp.asarray(~np.isnan(obs_np).any(-1))
        cam0 = jnp.asarray(_params_to_arrays(ext, intr))
        poses0 = jnp.asarray(np.asarray(poses)[use])
        obs = jnp.asarray(np.nan_to_num(obs_np))
        objp = jnp.asarray(rig.calib_objpoints)
        _, _, info64 = lm_solve(cam0, poses0, obs, mask, objp, LMOptions())
        _, _, info_h = lm_solve(
            cam0, poses0, obs, mask, objp, LMOptions(jac_dtype="float32")
        )
        np.testing.assert_allclose(
            float(info_h["final_cost"]), float(info64["final_cost"]),
            rtol=1e-5,
        )

    def test_f32_solver_quality(self, rig):
        """f32 LM (SPD Cholesky solves) lands within 3% of the f64 cost.

        In f32 the damped Schur system's conditioning (~1/lambda)
        made the previous LU-based f32 solve plateau ~3.5% high. Guards the
        bench.py quality gate (cost <= 1.05x reference)."""
        from multicam_calibration_tpu.models.bundle_adjustment import (
            _params_to_arrays,
        )
        from multicam_calibration_tpu.models.lm_core import lm_solve

        ext, intr, poses, _ = mct.calibrate(
            rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
            verbose=False, n_samples_for_intrinsics=40,
        )
        full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
        use = np.nonzero(full.sum(0) > 1)[0]
        obs_np = rig.all_calib_uvs[:, use]
        mask = jnp.asarray(~np.isnan(obs_np).any(-1))
        costs = {}
        for dt in (jnp.float64, jnp.float32):
            cam0 = jnp.asarray(_params_to_arrays(ext, intr), dtype=dt)
            poses0 = jnp.asarray(np.asarray(poses)[use], dtype=dt)
            obs = jnp.asarray(np.nan_to_num(obs_np), dtype=dt)
            objp = jnp.asarray(rig.calib_objpoints, dtype=dt)
            _, _, info = lm_solve(cam0, poses0, obs, mask, objp, LMOptions())
            costs[dt.__name__] = float(info["final_cost"])
        assert costs["float32"] <= costs["float64"] * 1.03

    def test_nielsen_damping_matches_classic_quality(self, rig):
        """The gain-ratio (Madsen-Nielsen-Tingleff) relaxation converges to
        the same cost as the classic schedule with no more cost evals.
        (Measured net wall LOSS on the bench problem — more outer
        iterations, i.e. more jacfwd builds — hence classic stays the
        default; see LMOptions.damping_schedule.)"""
        from multicam_calibration_tpu.models.bundle_adjustment import (
            _params_to_arrays,
        )
        from multicam_calibration_tpu.models.lm_core import lm_solve

        ext, intr, poses, _ = mct.calibrate(
            rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
            verbose=False, n_samples_for_intrinsics=40,
        )
        full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
        use = np.nonzero(full.sum(0) > 1)[0]
        obs_np = rig.all_calib_uvs[:, use]
        mask = jnp.asarray(~np.isnan(obs_np).any(-1))
        cam0 = jnp.asarray(_params_to_arrays(ext, intr), dtype=jnp.float64)
        poses0 = jnp.asarray(np.asarray(poses)[use], dtype=jnp.float64)
        obs = jnp.asarray(np.nan_to_num(obs_np), dtype=jnp.float64)
        objp = jnp.asarray(rig.calib_objpoints, dtype=jnp.float64)
        res = {}
        for sched in ("classic", "nielsen"):
            _, _, info = lm_solve(
                cam0, poses0, obs, mask, objp,
                LMOptions(damping_schedule=sched),
            )
            res[sched] = (float(info["final_cost"]), int(info["nfev"]))
        assert res["nielsen"][0] <= res["classic"][0] * 1.01
        assert res["nielsen"][1] <= res["classic"][1] * 1.5


class TestShardedLM:
    def test_sharded_matches_single_device(self, rig):
        from multicam_calibration_tpu.parallel import (
            make_frame_mesh,
            sharded_lm_solve,
        )

        ext, intr, poses, _ = mct.calibrate(
            rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
            verbose=False, n_samples_for_intrinsics=40,
        )
        full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
        use = np.nonzero(full.sum(0) > 1)[0]
        obs_np = rig.all_calib_uvs[:, use]
        mask = jnp.asarray(~np.isnan(obs_np).any(-1))
        obs = jnp.asarray(np.nan_to_num(obs_np))
        from multicam_calibration_tpu.models.bundle_adjustment import (
            _params_to_arrays,
        )

        cam0 = jnp.asarray(_params_to_arrays(ext, intr))
        poses0 = jnp.asarray(np.asarray(poses)[use])
        objp = jnp.asarray(rig.calib_objpoints)
        opts = LMOptions(max_iters=20)

        cam_s, poses_s, info_s = lm_solve(cam0, poses0, obs, mask, objp, opts)

        mesh = make_frame_mesh()
        assert mesh.devices.size == 8
        cam_m, poses_m, info_m = sharded_lm_solve(
            cam0, poses0, obs, mask, objp, opts, mesh=mesh
        )
        np.testing.assert_allclose(
            np.asarray(info_m["final_cost"]),
            np.asarray(info_s["final_cost"]),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(cam_m), np.asarray(cam_s), rtol=1e-4, atol=1e-5
        )
