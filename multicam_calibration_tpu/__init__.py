"""multicam_calibration_tpu — multi-camera calibration on an accelerator.

A ground-up JAX/XLA re-design with the full capability surface of the
reference package (dattalab-6-cam/multicam-calibration): chessboard detection,
intrinsics/extrinsics initialization, sparse Schur-complement bundle
adjustment, triangulation, flatibration, QC visualization, and JSON/JARVIS/
GIMBAL export — engineered for device meshes (frame-axis sharding, XLA
collectives) rather than single-process CPU loops.
"""

from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .models.initialize import (
    calibrate,
    consensus_calib_poses,
    estimate_all_extrinsics,
    estimate_pairwise_camera_transform,
    estimate_pose,
    estimate_pose_batch,
    get_camera_spanning_tree,
    get_intrinsics,
    get_intrinsics_batch,
)
from .models.bundle_adjustment import (
    bundle_adjust,
    bundle_adjustment_sparsity,
    deserialize_params,
    embed_calib_objpoints,
    predict_calib_uvs,
    residuals,
    select_ba_frames,
    serialize_params,
)
from .models.lm_core import LMOptions
from .models.streaming import RollingCalibrator
from .models.uncertainty import calibration_uncertainty
from .models.flatibration import (
    center_arena,
    flatibrate,
    flip_z_axis,
    get_floor_points,
)
from .utils.io import load_calibration, save_calibration
from .viz import (
    compute_residual_metric,
    overlay_detections,
    pad_axis_limits,
    plot_chessboard_qc_data,
    plot_residuals,
    plot_shared_detections,
    set_axis_limits,
    visualize_flatibration,
)
from .detection import (
    detect_chessboard,
    detect_chessboard_batch,
    detect_chessboard_batches,
    extend_grid,
    generate_chessboard_objpoints,
    process_video,
    reorder_chessboard_corners,
    run_calibration_detection,
    summarize_detections,
)
from .synthetic import make_synthetic_rig

__all__ = list(_ops_all) + [
    "calibrate",
    "consensus_calib_poses",
    "estimate_all_extrinsics",
    "estimate_pairwise_camera_transform",
    "estimate_pose",
    "estimate_pose_batch",
    "get_camera_spanning_tree",
    "get_intrinsics",
    "get_intrinsics_batch",
    "bundle_adjust",
    "bundle_adjustment_sparsity",
    "deserialize_params",
    "embed_calib_objpoints",
    "predict_calib_uvs",
    "residuals",
    "select_ba_frames",
    "serialize_params",
    "LMOptions",
    "RollingCalibrator",
    "calibration_uncertainty",
    "center_arena",
    "flatibrate",
    "flip_z_axis",
    "get_floor_points",
    "load_calibration",
    "save_calibration",
    "compute_residual_metric",
    "overlay_detections",
    "pad_axis_limits",
    "plot_chessboard_qc_data",
    "plot_residuals",
    "plot_shared_detections",
    "set_axis_limits",
    "visualize_flatibration",
    "generate_chessboard_objpoints",
    "detect_chessboard",
    "detect_chessboard_batch",
    "detect_chessboard_batches",
    "extend_grid",
    "process_video",
    "reorder_chessboard_corners",
    "run_calibration_detection",
    "summarize_detections",
    "make_synthetic_rig",
]

# Git-derived (versioneer parity, reference setup.py:1-26); falls back to
# the release pin outside a checkout.
from ._version import __version__  # noqa: E402
