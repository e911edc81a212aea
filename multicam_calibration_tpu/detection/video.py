"""Video-level detection orchestration with per-video HDF5 caching.

Capability parity with the reference's detection drivers
(/root/reference/multicam_calibration/detection.py:32-256), re-designed for
an accelerator: instead of pickling raw frames to a multiprocessing worker
pool (detection.py:80-112), the host decodes frames into batches and the
device runs the batched corner-response/subpixel stages; only the tiny
lattice-ordering step loops on host. Cache format is identical
(``{video}.detections.h5`` with uvs / frame_ixs / img_size / qc_data), so
caches interoperate with the reference.
"""
from __future__ import annotations

import os

import numpy as np

from .detector import detect_chessboard, detect_chessboard_batch

__all__ = [
    "VideoReader",
    "open_video",
    "process_video",
    "run_calibration_detection",
    "summarize_detections",
]

# Frames per device batch in process_video. On an H100, 64 and 256 run at
# the same end-to-end rate (the host side bounds it; PERF.md), and 64
# holds a quarter of the frames in device memory.
BATCH_SIZE = 64


def open_video(path, gray=False, prefetch=64):
    """Open a video with the best available backend.

    Prefers the native C++ loader (libmccvideo: libavformat decode on a
    background thread, see native/src/video_loader.cc) and falls back to
    the cv2-based VideoReader. Returns an object supporting len() and
    frame indexing; the native reader additionally supports read_batch().
    """
    from .native_video import available, NativeVideoReader

    if available():
        try:
            reader = NativeVideoReader(path, gray=gray, prefetch=prefetch)
        except IOError:
            reader = None  # container the native build can't read -> cv2
        if reader is not None:
            if reader.n_frames >= 0:
                return reader
            # Index-less container (no frame count): callers need len();
            # prefer the cv2 reader, keep the native one as last resort.
            try:
                cv2_reader = VideoReader(path)
            except Exception:
                return reader
            reader.close()
            return cv2_reader
    return VideoReader(path)


class VideoReader:
    """Minimal random-access video reader over cv2.VideoCapture.

    (The reference uses vidio's OpenCVReader; this is the same concept
    without the dependency.)
    """

    def __init__(self, path):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"could not open video {path}")
        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._next = 0
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0

    def __len__(self):
        return self._n

    def __getitem__(self, ix):
        import cv2

        if ix != self._next:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, int(ix))
        ok, frame = self._cap.read()
        self._next = ix + 1
        if not ok:
            raise IndexError(f"failed to read frame {ix}")
        return frame


def process_video(
    video_path,
    detection_fun=detect_chessboard,
    detection_options=None,
    use_frames=None,
    n_workers=1,
    frames=None,
    img_size=None,
    batch_size=BATCH_SIZE,
):
    """Detect the calibration object in one video; cache to HDF5.

    Reference-parity behavior (detection.py:32-144): writes
    ``{video}.detections.h5`` containing ``uvs (n_det, N, 2)``,
    ``frame_ixs``, ``img_size`` and (when the detector returns scores)
    ``qc_data``. ``n_workers`` is accepted for parity; the device pipeline
    replaces the process pool. ``frames`` allows passing pre-decoded frames
    (e.g. synthetic) instead of reading ``video_path``.

    When ``detection_fun`` is the default detector, frames are processed in
    fixed-size device batches (tail padded by repetition so every batch
    compiles to the same shape): native C++ decode-ahead overlaps the
    device's batched corner pipeline. ``batch_size=0`` forces the
    per-frame path.

    KeyboardInterrupt performs a partial save, like the reference
    (detection.py:98-123).
    """
    detection_options = detection_options or {}
    reader = None
    if frames is None:
        reader = open_video(video_path)
        first = reader[0]
        img_size = first.shape[:2][::-1]
        total = len(reader)
        get = lambda ix: reader[ix]
    else:
        img_size = img_size or frames[0].shape[:2][::-1]
        total = len(frames)
        get = lambda ix: frames[ix]

    if use_frames is None:
        use_frames = np.arange(total)

    batched = detection_fun is detect_chessboard and batch_size and batch_size > 1

    detections = {}
    try:
        if batched:
            from .detector import detect_chessboard_batches

            use = np.asarray(use_frames, int)
            chunks = [
                use[lo : lo + batch_size]
                for lo in range(0, len(use), batch_size)
            ]

            def _batches():
                for chunk in chunks:
                    imgs = [get(int(ix)) for ix in chunk]
                    while len(imgs) < batch_size:  # pad tail: constant shape
                        imgs.append(imgs[-1])
                    yield imgs

            # Double-buffered: the generator dispatches batch k+1's device
            # stage (and decodes its frames) before batch k's host lattice
            # ordering runs — decode + transfer + device compute overlap the
            # host work.
            for chunk, found in zip(
                chunks, detect_chessboard_batches(_batches(), **detection_options)
            ):
                for j, det in found.items():
                    if j < len(chunk):
                        detections[int(chunk[j])] = det
        else:
            for frame_ix in use_frames:
                det = detection_fun(get(int(frame_ix)), **detection_options)
                if det is not None:
                    detections[int(frame_ix)] = det
    except KeyboardInterrupt:
        print("Early termination, saving results so far...")
    finally:
        # Always release the native reader's decode thread + ring buffer
        # (a 'No detections found' raise must not leak them).
        if reader is not None and hasattr(reader, "close"):
            reader.close()

    if len(detections) == 0:
        raise ValueError("No detections found")

    frame_ixs = np.array(sorted(detections.keys()))
    first = detections[frame_ixs[0]]
    if isinstance(first, tuple) and len(first) == 2:
        uvs = np.stack([detections[i][0] for i in frame_ixs])
        qc_data = np.stack([detections[i][1] for i in frame_ixs])
    else:
        uvs = np.stack([detections[i] for i in frame_ixs])
        qc_data = None

    import h5py

    save_path = os.path.splitext(video_path)[0] + ".detections.h5"
    with h5py.File(save_path, "w") as h5:
        h5.create_dataset("uvs", data=uvs)
        h5.create_dataset("frame_ixs", data=frame_ixs)
        h5.create_dataset("img_size", data=np.asarray(img_size))
        if qc_data is not None:
            h5.create_dataset("qc_data", data=qc_data)
    return save_path


def run_calibration_detection(
    video_paths,
    detection_fun=detect_chessboard,
    detection_options=None,
    aligned_frame_ixs=None,
    overwrite=False,
    n_workers=1,
    all_frames=None,
):
    """Detect over a camera set; returns (all_calib_uvs, img_sizes).

    Reference-parity semantics (detection.py:147-234): per-video caches are
    reused unless ``overwrite``; ``aligned_frame_ixs (n_framesets,
    n_cameras)`` maps simultaneous frames across cameras (NaN = dropped);
    output is the NaN-padded (n_cameras, n_frames, N, 2) array. ``all_frames``
    optionally supplies pre-decoded frames per camera (synthetic pipelines).
    """
    import h5py

    all_uvs, all_img_sizes, all_frame_ixs = [], [], []

    if aligned_frame_ixs is None:
        if all_frames is not None:
            n_frames = min(len(f) for f in all_frames)
        else:
            n_frames = min(len(open_video(vp)) for vp in video_paths)
        aligned_frame_ixs = np.stack([np.arange(n_frames)] * len(video_paths)).T

    for i, video_path in enumerate(video_paths):
        save_path = os.path.splitext(video_path)[0] + ".detections.h5"
        if overwrite or not os.path.exists(save_path):
            print(f"Processing {video_path}")
            use = aligned_frame_ixs[:, i]
            use = use[~np.isnan(use)].astype(int)
            process_video(
                video_path,
                detection_fun,
                detection_options,
                use,
                n_workers,
                frames=None if all_frames is None else all_frames[i],
            )
        with h5py.File(save_path, "r") as h5:
            all_uvs.append(h5["uvs"][:])
            all_img_sizes.append(tuple(h5["img_size"][:]))
            all_frame_ixs.append(h5["frame_ixs"][:])

    assert np.all([len(u) > 0 for u in all_uvs]), (
        "At least one video has no detections"
    )

    n_calib_points = all_uvs[0].shape[1]
    n_frames = aligned_frame_ixs.shape[0]
    n_cameras = len(video_paths)
    all_calib_uvs = np.full((n_cameras, n_frames, n_calib_points, 2), np.nan)
    for i, (uvs, frame_ixs) in enumerate(zip(all_uvs, all_frame_ixs)):
        order = np.argsort(frame_ixs)
        uvs = uvs[order]
        frame_ixs = np.sort(frame_ixs)
        col = aligned_frame_ixs[:, i]
        slots = np.searchsorted(col, frame_ixs)
        all_calib_uvs[i, slots] = uvs
    return all_calib_uvs, all_img_sizes


def summarize_detections(all_calib_uvs):
    """Pairwise shared-detection counts as a DataFrame (detection.py:237-256)."""
    import pandas as pd

    has_detection = ~np.isnan(np.asarray(all_calib_uvs)).any(axis=(2, 3))
    n_shared = (has_detection[:, None, :] & has_detection[None, :, :]).sum(2)
    names = [f"Camera {i}" for i in range(len(all_calib_uvs))]
    return pd.DataFrame(n_shared, index=names, columns=names)
