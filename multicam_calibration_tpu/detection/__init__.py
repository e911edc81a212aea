"""Calibration-target detection: board models, batched corner detector, video IO."""
from .board import generate_chessboard_objpoints
from .detector import (
    detect_chessboard,
    detect_chessboard_batch,
    detect_chessboard_batches,
    extend_grid,
    reorder_chessboard_corners,
)
from .video import (
    process_video,
    run_calibration_detection,
    summarize_detections,
)

__all__ = [
    "generate_chessboard_objpoints",
    "detect_chessboard",
    "detect_chessboard_batch",
    "detect_chessboard_batches",
    "extend_grid",
    "reorder_chessboard_corners",
    "process_video",
    "run_calibration_detection",
    "summarize_detections",
]
