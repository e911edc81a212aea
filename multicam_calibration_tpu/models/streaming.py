"""Rolling re-calibration: windowed BA over a stream of frame batches.

BASELINE.json config 4 ("Rolling re-calibration stream: windowed BA over
incoming frame batches (online keyframe partitioning)") — a capability the
reference lacks entirely (its answer to drift is a full offline re-run).

Device-shaped design: the keyframe window has a FIXED capacity, so every
update executes the same compiled LM program (static shapes, zero
recompilation in steady state). Each `update(batch_uvs)`:

1. initializes the new frames' board poses by batched planar PnP against
   the *current* camera estimates (+ consensus across cameras),
2. admits them to the window, evicting the lowest-value keyframes — value
   = sum over camera pairs of 1/pair_coverage, i.e. frames that are the
   rare witnesses of a camera pair are protected (recent frames are always
   protected to track drift),
3. runs a few warm-started LM iterations on the window (damping state
   carried across updates via ``init_lam``) and re-estimates the cameras.

The result is a calibration that tracks slow rig drift at a per-batch cost
of O(window) instead of O(history).
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

import jax

from .bundle_adjustment import _arrays_to_params, _params_to_arrays
from .initialize import _estimate_pose_impl, consensus_calib_poses
from .lm_core import LMOptions, lm_solve

# Pose init for all cameras in ONE dispatch: vmap _estimate_pose_impl over
# the camera axis (per-camera intrinsics stacked) instead of C dispatches.
_batched_estimate_pose = jax.jit(
    jax.vmap(_estimate_pose_impl, in_axes=(0, 0, 0, None))
)

__all__ = ["RollingCalibrator"]


class RollingCalibrator:
    """Windowed streaming re-calibration over incoming frame batches.

    Keeps a fixed-capacity keyframe window ON DEVICE; ``update(batch_uvs)``
    PnP-initializes the new frames' board poses against the current
    cameras, admits them (evicting the lowest-value keyframes — rare
    camera-pair witnesses are protected, recent frames always kept), and
    runs a few warm-started LM iterations in one fused device program.
    Tracks slow rig drift at O(window) cost per batch; the reference's
    only equivalent is a full offline re-run (bundle_adjustment.py:195).
    See the module docstring for the design rationale.
    """

    def __init__(
        self,
        all_extrinsics,
        all_intrinsics,
        calib_objpoints,
        window=256,
        iters_per_update=3,
        protect_recent=32,
        refine_intrinsics=False,
        dtype=None,
        lm_options=None,
    ):
        # refine_intrinsics=False by default: rig drift is geometric (mounts
        # flex, lenses don't), and with a small window free intrinsics trade
        # off against depth (fx <-> z ambiguity) — observed ~20-40 mm
        # relative-extrinsics drift at healthy reprojection cost when all 12
        # camera params float on a 64-frame window.
        self._ext = np.asarray(all_extrinsics, np.float64)
        self._intr = [
            (np.asarray(K, np.float64), np.asarray(d, np.float64))
            for K, d in all_intrinsics
        ]
        self.objpoints = np.asarray(calib_objpoints, np.float64)
        self.window = int(window)
        self.protect_recent = int(protect_recent)
        n_cameras = self._ext.shape[0]
        N = self.objpoints.shape[0]
        self._dtype = dtype or jnp.zeros(0).dtype
        self._opts = lm_options or LMOptions(
            max_iters=int(iters_per_update), ftol=0.0
        )
        cam_free = np.ones((n_cameras, 12), np.float32)
        if not refine_intrinsics:
            cam_free[:, :6] = 0.0
        self._cam_free = cam_free
        # Window state lives ON DEVICE (obs, per-point masks, poses): each
        # update scatters only the incoming batch and runs one fused
        # program instead of re-uploading the window (9.2 MB f64 at 64cam
        # x 256; the window data never changes except the admitted slots).
        # The host keeps only what eviction logic reads: per-(camera, slot)
        # visibility + arrival order.
        dt = self._dtype
        self._obs_d = jnp.zeros((n_cameras, self.window, N, 2), dt)
        self._msk_d = jnp.zeros((n_cameras, self.window, N), bool)
        self._poses_d = jnp.zeros((self.window, 6), dt)
        self._objp_d = jnp.asarray(self.objpoints, dt)
        self._seen2d = np.zeros((n_cameras, self.window), bool)
        self._order = np.full(self.window, -1, dtype=np.int64)  # arrival idx
        self._next_arrival = 0
        self._lam = None
        self._progs = {}
        self.n_updates = 0

    # -- public state ------------------------------------------------------
    @property
    def n_cameras(self):
        return self._ext.shape[0]

    def calibration(self):
        """Current (all_extrinsics, all_intrinsics)."""
        return self._ext.copy(), [(K.copy(), d.copy()) for K, d in self._intr]

    @property
    def occupancy(self):
        return int((self._order >= 0).sum())

    # -- internals -----------------------------------------------------------
    def _frame_values(self):
        """Keyframe value: rare camera-pair witnesses are precious.

        Vectorized over all C*(C-1)/2 pairs at once (the per-pair Python
        loop was O(C^2) interpreter iterations per update — 2016 at 64
        cameras); peak temp is the (P, W) co-visibility table, ~0.5 MB at
        64 cams x window 256.
        """
        so = self._seen2d & (self._order >= 0)[None, :]
        a, b = np.triu_indices(so.shape[0], k=1)
        co = so[a] & so[b]  # (P, W)
        counts = co.sum(1)
        nz = counts > 0
        if not nz.any():
            return np.zeros(self.window)
        return (co[nz] / counts[nz, None]).sum(0)

    def _evict_slots(self, n_needed):
        """Pick distinct slots for new frames: empty first, then the
        lowest-value unprotected keyframes, then (only if the batch exceeds
        window - protect_recent) the oldest protected ones."""
        empty = np.nonzero(self._order < 0)[0]
        if len(empty) >= n_needed:
            return empty[:n_needed]
        slots = list(empty)
        n_more = n_needed - len(empty)
        occupied_ix = np.nonzero(self._order >= 0)[0]
        recency = np.argsort(self._order[occupied_ix])[::-1]
        protected = set(occupied_ix[recency[: self.protect_recent]].tolist())
        value = self._frame_values()
        evictable = np.asarray(
            [s for s in occupied_ix if s not in protected], dtype=np.int64
        )
        if len(evictable):
            order = evictable[np.argsort(value[evictable])]
            slots.extend(order[:n_more].tolist())
            n_more = n_needed - len(slots)
        if n_more > 0:  # huge batch: give up the oldest protected frames
            by_age = occupied_ix[np.argsort(self._order[occupied_ix])]
            remaining = [s for s in by_age.tolist() if s not in slots]
            slots.extend(remaining[:n_more])
        return np.asarray(slots[:n_needed], dtype=np.int64)

    def _update_program(self, Bp):
        """Fused per-update program (cached per padded batch size): scatter
        the admitted frames into the device window, apply the active-frame
        mask, and run the warm-started windowed LM — ONE device dispatch
        per update instead of a full-window upload + solver dispatch +
        scattered scalar syncs."""
        fn = self._progs.get(Bp)
        if fn is not None:
            return fn
        opts = self._opts
        objp = self._objp_d

        @functools.partial(
            jax.jit, donate_argnames=("obs_d", "msk_d", "poses_d")
        )
        def step(
            cam0, obs_d, msk_d, poses_d, b_obs, b_msk, b_poses, slots,
            active, cam_free, lam,
        ):
            # Padded batch rows carry slot index == window (out of bounds)
            # and are dropped by the scatter.
            obs2 = obs_d.at[:, slots].set(b_obs, mode="drop")
            msk2 = msk_d.at[:, slots].set(b_msk, mode="drop")
            poses2 = poses_d.at[slots].set(b_poses, mode="drop")
            mask_eff = msk2 & active[None, :, None]
            cam, poses_out, info = lm_solve(
                cam0, poses2, obs2, mask_eff, objp, opts,
                cam_free=cam_free, init_lam=lam,
            )
            return obs2, msk2, poses_out, cam, info

        self._progs[Bp] = step
        return step

    def update(self, batch_uvs):
        """Ingest (n_cameras, B, N, 2) detections (NaN = unseen); refine.

        Returns an info dict (cost, n_iters, window occupancy).
        """
        batch_uvs = np.asarray(batch_uvs, np.float64)
        C, B = batch_uvs.shape[:2]
        if C != self.n_cameras:
            raise ValueError(f"expected {self.n_cameras} cameras, got {C}")

        # 1. pose init for the incoming frames at current cameras (one
        # batched vmapped call across all cameras) + consensus across
        # cameras, on the default device.
        Ks = np.stack([K for K, _ in self._intr])
        ds = np.stack([d for _, d in self._intr])
        per_cam = _batched_estimate_pose(
            jnp.asarray(batch_uvs), jnp.asarray(Ks), jnp.asarray(ds),
            jnp.asarray(self.objpoints),
        )
        poses_new = np.asarray(
            consensus_calib_poses(per_cam, jnp.asarray(self._ext))
        )
        ok = ~np.isnan(poses_new).any(-1)

        # 2. admit to the window (a batch larger than the window keeps its
        # newest `window` frames); host mirrors carry only visibility +
        # arrival order (what eviction reads).
        new_ix = np.nonzero(ok)[0]
        if len(new_ix) > self.window:
            new_ix = new_ix[-self.window :]
        slots = self._evict_slots(len(new_ix))
        for slot, j in zip(slots, new_ix):
            self._seen2d[:, slot] = ~np.isnan(batch_uvs[:, j]).any((-1, -2))
            self._order[slot] = self._next_arrival
            self._next_arrival += 1
        occupied = self._order >= 0
        active = occupied & ((self._seen2d & occupied[None]).sum(0) >= 2)

        # 3. fused scatter + windowed LM (static shapes: the batch is
        # padded to a power of two so batch-size jitter reuses programs).
        nb = len(new_ix)
        N = self.objpoints.shape[0]
        Bp = max(1, 1 << max(nb - 1, 0).bit_length())
        b_obs = np.zeros((C, Bp, N, 2))
        b_msk = np.zeros((C, Bp, N), bool)
        b_poses = np.zeros((Bp, 6))
        slots_p = np.full(Bp, self.window, np.int32)  # OOB -> dropped
        if nb:
            sel = batch_uvs[:, new_ix]
            b_obs[:, :nb] = np.nan_to_num(sel)
            b_msk[:, :nb] = ~np.isnan(sel).any(-1)
            b_poses[:nb] = np.nan_to_num(poses_new[new_ix])
            slots_p[:nb] = slots
        dt = self._dtype
        lam = (
            self._lam if self._lam is not None
            else float(self._opts.init_lambda)
        )
        step = self._update_program(Bp)
        self._obs_d, self._msk_d, self._poses_d, cam_d, info = step(
            jnp.asarray(_params_to_arrays(self._ext, self._intr), dt),
            self._obs_d, self._msk_d, self._poses_d,
            jnp.asarray(b_obs, dt), jnp.asarray(b_msk),
            jnp.asarray(b_poses, dt), jnp.asarray(slots_p),
            jnp.asarray(active), jnp.asarray(self._cam_free, dt),
            jnp.asarray(lam, dt),
        )
        # One gathered download (cameras + the scalars the host needs).
        cam_h, cost, n_iters, lam_out = jax.device_get(
            (cam_d, info["final_cost"], info["n_iters"], info["lambda"])
        )
        self._lam = float(lam_out)
        self._ext, self._intr = _arrays_to_params(
            np.array(cam_h, np.float64)
        )
        self.n_updates += 1
        return {
            "cost": float(cost),
            "n_iters": int(n_iters),
            "occupancy": self.occupancy,
            "admitted": int(nb),
        }
