"""Chunked (memory-bounded) normal-block assembly + Schur reduction tests.

The frame_chunk path lax.scans the linearization and Schur reduction over
frame slabs so peak memory is O(C * chunk) instead of O(C * F) — the design
that makes BASELINE config 5 (64 cams x 20k frames) feasible. These tests
pin chunked == unchunked semantics, including under frame sharding and with
frozen-parameter masks.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import multicam_calibration_tpu as mct
from multicam_calibration_tpu.models.lm_core import (
    HIST_FIELDS,
    LMOptions,
    build_normal_blocks,
    lm_solve,
    schur_solve,
)


@pytest.fixture(scope="module")
def problem():
    rig = mct.make_synthetic_rig(
        n_cameras=4, n_frames=50, noise_px=0.4, dropout=0.2, seed=5
    )
    ext, intr, poses, _ = mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=20,
    )
    from multicam_calibration_tpu.models.bundle_adjustment import (
        _params_to_arrays, select_ba_frames,
    )

    use = select_ba_frames(
        rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses,
        verbose=False,
    )
    obs_np = rig.all_calib_uvs[:, use]
    return dict(
        obs=jnp.asarray(np.nan_to_num(obs_np)),
        mask=jnp.asarray(~np.isnan(obs_np).any(-1)),
        cam0=jnp.asarray(_params_to_arrays(ext, intr)),
        poses0=jnp.asarray(np.nan_to_num(np.asarray(poses)[use])),
        objpoints=jnp.asarray(rig.calib_objpoints),
    )


@pytest.mark.parametrize("chunk", [16, 7])  # 7 does not divide F -> padding
def test_chunked_blocks_match_dense(problem, chunk):
    p = problem
    # Premise guard: with F <= chunk the builder takes the unchunked
    # early-exit and the layout reshapes below scramble W. F collapsing
    # here means the INIT degraded (r2: a degenerate intrinsics basin cut
    # select_ba_frames from 47 to 10 frames) — fail loudly on the cause.
    assert p["poses0"].shape[0] > chunk, (
        "fixture selected too few frames — init quality regression?"
    )
    opts_d = LMOptions()
    opts_c = LMOptions(frame_chunk=chunk)
    bd = build_normal_blocks(
        p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"], opts_d
    )
    bc = build_normal_blocks(
        p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"], opts_c
    )
    F = p["poses0"].shape[0]
    np.testing.assert_allclose(bc.U, bd.U, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(bc.g_cam, bd.g_cam, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(float(bc.cost), float(bd.cost), rtol=1e-12)
    # Chunked per-frame blocks: (nc, ck, ...) reshapes to padded-F layout.
    V_c = np.asarray(bc.V).reshape(-1, 6, 6)[:F]
    W_c = np.moveaxis(np.asarray(bc.W), 1, 0).reshape(
        p["cam0"].shape[0], -1, 12, 6
    )[:, :F]
    gp_c = np.asarray(bc.g_pose).reshape(-1, 6)[:F]
    np.testing.assert_allclose(V_c, bd.V, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(W_c, bd.W, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(gp_c, bd.g_pose, rtol=1e-10, atol=1e-8)

    # And the Schur step from the chunked blocks matches the dense one.
    lam = jnp.asarray(1e-4, p["cam0"].dtype)
    dcam_d, dpose_d = schur_solve(bd, lam, opts=opts_d)
    dcam_c, dpose_c = schur_solve(bc, lam, opts=opts_c)
    np.testing.assert_allclose(dcam_c, dcam_d, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(dpose_c[:F], dpose_d, rtol=1e-7, atol=1e-9)
    # Padded rows are exactly inert.
    assert np.all(np.asarray(dpose_c[F:]) == 0)


@pytest.mark.parametrize("jac_dtype", [None, "float32"])
def test_chunked_lm_matches_dense(problem, jac_dtype):
    p = problem
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    _, _, i_d = lm_solve(*args, LMOptions(jac_dtype=jac_dtype))
    _, _, i_c = lm_solve(*args, LMOptions(jac_dtype=jac_dtype, frame_chunk=16))
    # Same optimum, near-same trajectory. Iteration counts are allowed a
    # small band rather than exact equality: the analytic block assembly
    # (r3) contracts the frame axis INSIDE one einsum, so chunked and dense
    # runs sum in different orders and rounding can flip a near-tie damping
    # acceptance late in the descent (observed 23 vs 25 iters at the same
    # final cost under jac_dtype=float32).
    assert abs(int(i_c["n_iters"]) - int(i_d["n_iters"])) <= 3
    np.testing.assert_allclose(
        float(i_c["final_cost"]), float(i_d["final_cost"]), rtol=1e-6
    )


def test_chunked_respects_free_masks(problem):
    p = problem
    C = p["cam0"].shape[0]
    F = p["poses0"].shape[0]
    cam_free = jnp.ones((C, 12)).at[:, :6].set(0.0)  # freeze intrinsics
    pose_free = jnp.ones((F, 6)).at[::3].set(0.0)  # freeze every 3rd pose
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    cam_d, poses_d, i_d = lm_solve(
        *args, LMOptions(), cam_free=cam_free, pose_free=pose_free
    )
    cam_c, poses_c, i_c = lm_solve(
        *args, LMOptions(frame_chunk=16), cam_free=cam_free,
        pose_free=pose_free,
    )
    # Frozen entries never move, on either path.
    np.testing.assert_array_equal(
        np.asarray(cam_c)[:, :6], np.asarray(p["cam0"])[:, :6]
    )
    np.testing.assert_array_equal(
        np.asarray(poses_c)[::3], np.asarray(p["poses0"])[::3]
    )
    np.testing.assert_allclose(
        float(i_c["final_cost"]), float(i_d["final_cost"]), rtol=1e-6
    )


def test_chunked_sharded_matches_single_device(problem):
    if jax.device_count() < 2:
        pytest.skip("needs multiple devices")
    from multicam_calibration_tpu.parallel import make_frame_mesh
    from multicam_calibration_tpu.parallel.sharded import sharded_lm_solve

    p = problem
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    opts = LMOptions(frame_chunk=4)
    _, _, i_single = lm_solve(*args, opts)
    mesh = make_frame_mesh()
    _, _, i_shard = sharded_lm_solve(*args, opts, mesh=mesh)
    np.testing.assert_allclose(
        float(i_shard["final_cost"]), float(i_single["final_cost"]), rtol=1e-6
    )


def test_history_telemetry(problem):
    p = problem
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    _, _, info = lm_solve(*args, LMOptions())
    n = int(info["n_iters"])
    hist = np.asarray(info["history"])
    assert hist.shape[1] == len(HIST_FIELDS)
    assert n >= 2
    cost_col = hist[:n, HIST_FIELDS.index("cost")]
    # Monotone non-increasing accepted costs, ending at final_cost.
    assert np.all(np.diff(cost_col) <= 1e-9)
    np.testing.assert_allclose(cost_col[-1], float(info["final_cost"]))
    assert np.all(hist[:n, HIST_FIELDS.index("tries")] >= 1)
    assert float(info["optimality"]) > 0
    assert int(info["nfev"]) >= n + 1


MIXED = dict(
    jac_dtype="float32",
    block_dtype="float32",
    cost_dtype="float32",
    solve_dtype="float32",
)


def test_mixed_precision_recipe_matches_f64_optimum(problem):
    """The mixed recipe (f64 residual/gradient path only; f32 Jacobians,
    J^T J blocks, Schur solve, cost projections) reaches the same optimum as
    pure f64."""
    p = problem
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    _, _, i_f64 = lm_solve(*args, LMOptions())
    _, _, i_mix = lm_solve(*args, LMOptions(**MIXED))
    assert float(i_mix["final_cost"]) <= float(i_f64["final_cost"]) * (
        1 + 1e-5
    )


def test_mixed_precision_chunked_and_sharded(problem):
    """Chunked/sharded mixed runs reach the f64 optimum's neighborhood.

    The f32 Schur solve can stall a few percent high on this small
    gauge-ill-conditioned toy problem, and the stall point depends on the
    reduction order (chunk size, psum) — so the contract here is an 8%
    envelope around the f64 optimum, NOT trajectory equality. The
    f64-polish test below pins the production contract: bundle_adjust
    recovers f64-grade quality after a mixed descent."""
    p = problem
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    _, _, i_f64 = lm_solve(*args, LMOptions())
    ref = float(i_f64["final_cost"])
    _, _, i_chunk = lm_solve(*args, LMOptions(frame_chunk=16, **MIXED))
    assert float(i_chunk["final_cost"]) <= ref * 1.08
    if jax.device_count() >= 2:
        from multicam_calibration_tpu.parallel import make_frame_mesh
        from multicam_calibration_tpu.parallel.sharded import sharded_lm_solve

        mesh = make_frame_mesh()
        _, _, i_shard = sharded_lm_solve(
            *args, LMOptions(frame_chunk=4, **MIXED), mesh=mesh
        )
        assert float(i_shard["final_cost"]) <= ref * 1.08


def test_mixed_then_f64_polish_recovers_optimum(problem):
    """The production contract (bundle_adjust's auto path): a mixed-recipe
    descent followed by a short warm-started f64 polish lands at the f64
    optimum even where the f32 Schur solve alone shelves (measured 6.9%
    high at frame_chunk=16 on this problem)."""
    import dataclasses

    p = problem
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    _, _, i_f64 = lm_solve(*args, LMOptions())
    mixed = LMOptions(frame_chunk=16, **MIXED)
    cam_m, poses_m, i_m = lm_solve(*args, mixed)
    polish = dataclasses.replace(
        mixed, block_dtype=None, cost_dtype=None, solve_dtype=None,
        max_iters=10,
    )
    _, _, i_p = lm_solve(
        cam_m, poses_m, *args[2:], polish, init_lam=float(i_m["lambda"])
    )
    assert float(i_p["final_cost"]) <= float(i_f64["final_cost"]) * (1 + 1e-4)


def test_gtol_rel_stops_endgame_at_same_optimum(problem):
    """gtol_rel=1e-6 cuts the end-game gradient-polishing iterations (the
    ftol patience never accrues there — every round needs 2+ damping
    tries) without giving up cost: measured 22 -> 15 iterations on the
    bench problem at a 1e-7-relative cost difference."""
    p = problem
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    full = LMOptions(**MIXED, grad_dtype="float32", lambda_escalation=3.0)
    early = LMOptions(
        **MIXED, grad_dtype="float32", lambda_escalation=3.0, gtol_rel=1e-6
    )
    _, _, i_full = lm_solve(*args, full)
    _, _, i_early = lm_solve(*args, early)
    assert int(i_early["n_iters"]) <= int(i_full["n_iters"])
    assert float(i_early["final_cost"]) <= float(i_full["final_cost"]) * (
        1 + 1e-5
    )


def test_grad_dtype_matches_data_dtype_gradient(problem):
    """grad_dtype=f32 (per-observation weighting/gradient products in f32,
    residual formed in f64, frame-axis reduction in f64): near the mixed
    optimum on this small gauge-ill toy (it can shelve ~1e-4 relative,
    same class as the f32-Schur shelf), and at the f64 optimum after the
    production f64 polish (bundle_adjust's auto path)."""
    import dataclasses

    p = problem
    args = (p["cam0"], p["poses0"], p["obs"], p["mask"], p["objpoints"])
    _, _, i_f64g = lm_solve(*args, LMOptions(**MIXED))
    g32 = LMOptions(**MIXED, grad_dtype="float32")
    cam_m, poses_m, i_f32g = lm_solve(*args, g32)
    assert float(i_f32g["final_cost"]) <= float(i_f64g["final_cost"]) * (
        1 + 1e-3
    )
    polish = dataclasses.replace(
        g32, block_dtype=None, cost_dtype=None, solve_dtype=None,
        grad_dtype=None, max_iters=10,
    )
    _, _, i_p = lm_solve(
        cam_m, poses_m, *args[2:], polish, init_lam=float(i_f32g["lambda"])
    )
    _, _, i_f64 = lm_solve(*args, LMOptions())
    assert float(i_p["final_cost"]) <= float(i_f64["final_cost"]) * (1 + 1e-4)


def test_f64_polish_runs_on_default_device():
    """A mixed-recipe descent (solve_dtype f32 under f64 data) is followed
    by a warm-started f64 polish through the same solver on the default
    device, and reaches the pure-f64 optimum."""
    rig = mct.make_synthetic_rig(
        n_cameras=3, n_frames=40, noise_px=0.4, dropout=0.1, seed=3
    )
    ext, intr, poses, _ = mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=15,
    )
    # Baseline: pure-f64 solve (no polish fires).
    _, _, _, _, i_f64 = mct.bundle_adjust(
        rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses,
        verbose=False, repair_poses=False,
    )
    assert "polish_iters" not in i_f64
    _, _, _, _, info = mct.bundle_adjust(
        rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses,
        lm_options=dict(solve_dtype="float32"),
        verbose=False, repair_poses=False,
    )
    assert "polish_on_cpu" not in info
    assert info["polish_iters"] >= 0
    assert float(info["final_cost"]) <= float(i_f64["final_cost"]) * (
        1 + 1e-4
    )
