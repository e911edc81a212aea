"""Frame-sharded LM bundle adjustment via shard_map over a device mesh.

Realizes SURVEY.md §5's sharding design: poses + observations are sharded
along the 'frames' mesh axis, camera parameters are replicated, and each LM
iteration communicates only the reduced camera system (psum inside
lm_core.schur_solve) plus scalar costs. The entire optimizer loop runs inside
one shard_map-ped XLA program — no host round-trips.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..models.lm_core import LMOptions, lm_solve
from ..ops.triangulation import _prep_triangulate_inputs, _triangulate_impl

__all__ = ["sharded_lm_solve", "sharded_triangulate"]


@functools.lru_cache(maxsize=32)
def _build_sharded_solver(
    mesh, opts, axis_name, with_cam_free, with_init_lam, with_init_grad0,
):
    """Cached jitted shard_map solver (keyed by mesh + options)."""

    def local_solve(cam, poses, obs_l, mask_l, objp, cam_free, init_lam):
        return lm_solve(
            cam, poses, obs_l, mask_l, objp, opts,
            cam_free=cam_free if with_cam_free else None,
            axis_name=axis_name,
            init_lam=init_lam[0] if with_init_lam else None,
            init_grad0=init_lam[1] if with_init_grad0 else None,
        )

    fn = jax.shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(
            P(), P(axis_name), P(None, axis_name), P(None, axis_name), P(),
            P(), P(),
        ),
        out_specs=(P(), P(axis_name), P()),
    )
    return jax.jit(fn)


def sharded_lm_solve(
    cam_params,
    pose_params,
    obs,
    mask,
    objpoints,
    opts: LMOptions = LMOptions(),
    mesh=None,
    axis_name="frames",
    cam_free=None,
    init_lam=None,
    init_grad0=None,
):
    """Run lm_solve with frames sharded over ``mesh[axis_name]``.

    Frames are zero-padded to a multiple of the mesh size; padded frames have
    all-False masks, so their pose blocks are identity-padded in the Schur
    solve and receive exactly zero updates.
    """
    n_dev = mesh.shape[axis_name]
    F = pose_params.shape[0]
    F_pad = -(-F // n_dev) * n_dev
    pad = F_pad - F
    if pad:
        pose_params = jnp.concatenate(
            [pose_params, jnp.zeros((pad, 6), pose_params.dtype)]
        )
        obs = jnp.concatenate(
            [obs, jnp.zeros((obs.shape[0], pad, *obs.shape[2:]), obs.dtype)], axis=1
        )
        mask = jnp.concatenate(
            [mask, jnp.zeros((mask.shape[0], pad, *mask.shape[2:]), bool)], axis=1
        )

    solver = _build_sharded_solver(
        mesh, opts, axis_name, cam_free is not None, init_lam is not None,
        init_grad0 is not None,
    )
    cam_free_arg = (
        cam_free if cam_free is not None else jnp.ones_like(cam_params)
    )
    # Packed (init_lam, init_grad0) scalar pair (replicated); unset slots
    # carry benign values that the with_* switches ignore.
    init_lam_arg = jnp.asarray(
        [
            init_lam if init_lam is not None else opts.init_lambda,
            init_grad0 if init_grad0 is not None else -1.0,
        ],
        cam_params.dtype,
    )
    cam, poses, info = solver(
        cam_params, pose_params, obs, mask, objpoints, cam_free_arg,
        init_lam_arg,
    )
    return cam, poses[:F], info


def sharded_triangulate(
    all_uvs,
    all_extrinsics,
    all_intrinsics,
    mesh=None,
    axis_name="points",
    refine=True,
    return_sd=False,
):
    """Points-sharded robust triangulation for large keypoint clouds.

    Same semantics and arguments as :func:`multicam_calibration_tpu.
    triangulate` (reference geometry.py:361-433 parity plus the
    ``refine``/``return_sd`` extensions), with the POINTS axis sharded over
    ``mesh[axis_name]``. Every stage — undistortion, pair DLT, masked
    median, the optional GN polish — is elementwise over points, so XLA
    partitions the whole program with ZERO collectives: scaling is linear
    in devices up to the HBM-bandwidth roofline. Points are NaN-padded to
    a multiple of the mesh size (padded outputs are NaN and trimmed).
    """
    if mesh is None:
        from .mesh import make_frame_mesh

        mesh = make_frame_mesh(axis_name=axis_name)
    refine = refine or return_sd
    uvs, Ks, dists, exts, r2_maxs = _prep_triangulate_inputs(
        all_uvs, all_extrinsics, all_intrinsics
    )
    if uvs.ndim != 3:
        raise ValueError(
            "sharded_triangulate expects (C, n_points, 2) observations"
        )
    n_dev = mesh.shape[axis_name]
    n = uvs.shape[1]
    pad = (-n) % n_dev
    if pad:
        uvs = jnp.concatenate(
            [uvs, jnp.full((uvs.shape[0], pad, 2), jnp.nan, uvs.dtype)],
            axis=1,
        )
    sharding = jax.sharding.NamedSharding(mesh, P(None, axis_name, None))
    uvs = jax.device_put(uvs, sharding)
    rep = jax.sharding.NamedSharding(mesh, P())
    Ks, dists, exts, r2_maxs = (
        jax.device_put(a, rep) for a in (Ks, dists, exts, r2_maxs)
    )
    out = _triangulate_impl(uvs, Ks, dists, exts, r2_maxs, refine=refine)
    if not refine:
        return out[:n]
    pts, sd = out
    return (pts[:n], sd[:n]) if return_sd else pts[:n]
