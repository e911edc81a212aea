"""Backend choices (multicam_calibration_tpu.backend) on faked platforms,
and the callers that ask for them."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import multicam_calibration_tpu as mct
from multicam_calibration_tpu import backend

# platform -> expected value of each choice (GPU values: PERF.md timings).
EXPECTED = {
    "gpu": dict(detection_stage1_fused=True, init_camera_batched=True),
    "cpu": dict(detection_stage1_fused=False, init_camera_batched=False),
}


@pytest.mark.parametrize("platform", sorted(EXPECTED))
@pytest.mark.parametrize("choice", sorted(EXPECTED["gpu"]))
def test_choice_per_platform(platform, choice):
    assert getattr(backend, choice)(platform) == EXPECTED[platform][choice]


def test_platform_is_default_device_platform():
    assert backend.platform() == jax.devices()[0].platform == "cpu"


def test_calibrate_asks_backend_for_batching(monkeypatch):
    """calibrate takes the camera-batched init exactly when the backend
    choice says so."""
    from multicam_calibration_tpu.models import initialize as init_mod

    calls = []
    real = init_mod.get_intrinsics_batch

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(init_mod, "get_intrinsics_batch", spy)
    rig = mct.make_synthetic_rig(
        n_cameras=3, n_frames=30, noise_px=0.2, dropout=0.1, seed=4
    )
    for batched in (False, True):
        monkeypatch.setattr(
            backend, "init_camera_batched", lambda p, b=batched: b
        )
        calls.clear()
        init_mod.calibrate(
            rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
            verbose=False, n_samples_for_intrinsics=15,
        )
        assert bool(calls) == batched


def test_stage1_asks_backend_for_fusion(monkeypatch):
    """_stage1_fast runs the fused program exactly when the backend choice
    says so, and both give the same result."""
    from multicam_calibration_tpu.detection import detector as det
    from multicam_calibration_tpu.detection.synthetic_images import (
        random_view_homography,
        render_board_view,
    )

    H = random_view_homography(np.random.default_rng(5), board_shape=(5, 7))
    v, _ = render_board_view(H, board_shape=(5, 7), seed=5)
    gray = det._gray_from_u8(jnp.asarray(v.astype(np.uint8)[None]))
    used = []
    real = det._stage1_fused

    def spy(*a, **k):
        used.append(1)
        return real(*a, **k)

    monkeypatch.setattr(det, "_stage1_fused", spy)
    outs = []
    for fused in (False, True):
        monkeypatch.setattr(
            backend, "detection_stage1_fused", lambda p, f=fused: f
        )
        used.clear()
        outs.append(det._stage1_fast(gray, 160, 4, 5, 7, 40, 5))
        assert bool(used) == fused
    for a, b in zip(*outs):
        np.testing.assert_allclose(
            np.asarray(a, np.float64), np.asarray(b, np.float64),
            rtol=1e-6, atol=1e-6,
        )


def test_streaming_pose_init_runs_on_default_device(monkeypatch):
    """RollingCalibrator initializes the incoming frames' poses on the
    default device (no host-CPU detour)."""
    from multicam_calibration_tpu.models import streaming

    seen = []
    real = streaming._batched_estimate_pose

    def spy(*a):
        out = real(*a)
        seen.append(set(out.devices()))
        return out

    monkeypatch.setattr(streaming, "_batched_estimate_pose", spy)
    dev = jax.devices()[3]
    rig = mct.make_synthetic_rig(
        n_cameras=3, n_frames=16, noise_px=0.3, dropout=0.1, seed=2
    )
    with jax.default_device(dev):
        rc = streaming.RollingCalibrator(
            rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints,
            window=16, iters_per_update=1,
        )
        info = rc.update(rig.all_calib_uvs[:, :8])
    assert seen == [{dev}]
    assert np.isfinite(info["cost"])
