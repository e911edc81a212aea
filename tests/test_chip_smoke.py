"""chip_smoke.py: refuses to run without a GPU, and its phase helpers'
limit checks on tiny CPU inputs."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    out = _run(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize(
    "value,op,limit,ok",
    [(0.5, "<=", 1.0, True), (1.5, "<=", 1.0, False),
     (0.95, ">=", 0.9, True), (float("nan"), "<=", 1.0, False)],
)
def test_check(value, op, limit, ok):
    c = chip_smoke.check(value, op, limit)
    assert c["ok"] is ok
    assert c["limit"] == f"{op} {limit}"


def test_detection_metrics():
    gt = np.stack(np.meshgrid(np.arange(7.0), np.arange(5.0)), -1).reshape(
        -1, 2) * 20 + 100
    dets = {
        0: (gt + 0.3, None),             # accurate, anchor first
        1: (gt[::-1].copy(), None),      # accurate, wrong orientation
        3: (gt + 5.0, None),             # corrupted
    }
    rate, med = chip_smoke.detection_metrics(dets, [gt] * 4)
    assert rate == 0.25
    assert np.isclose(med, np.sqrt(2) * 0.3)


def test_rigid_align_error_removes_gauge(rng):
    pts = rng.normal(0, 50, (200, 3))
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    moved = pts @ R.T + np.array([10.0, -4.0, 7.0])
    moved[5] = np.nan
    err = chip_smoke.rigid_align_error(moved, pts)
    assert np.nanmax(err) < 1e-9
    assert np.isnan(err[5])


def test_phase_response_small():
    checks, info = chip_smoke.phase_response(
        shapes=((2, 48, 80),), sigmas=(1.5, 3.5)
    )
    assert len(checks) == 2
    assert all(c["ok"] for c in checks.values()), checks
    assert info["wall_s"] > 0


def test_phase_downstream_small(tmp_path):
    """Triangulation, floor alignment and JSON export at the true
    calibration of a tiny rig."""
    import multicam_calibration_tpu as mct

    rig = mct.make_synthetic_rig(
        n_cameras=3, n_frames=20, noise_px=0.3, dropout=0.1, seed=6
    )
    checks, info = chip_smoke.phase_downstream(
        rig, (rig.all_extrinsics, rig.all_intrinsics), str(tmp_path),
        n_kp_frames=50,
    )
    assert all(c["ok"] for c in checks.values()), checks
    assert info["n_points"] == 400
