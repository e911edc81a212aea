"""Sparse Schur-complement Levenberg–Marquardt engine for bundle adjustment.

This module replaces the reference's entire refinement stack —
scipy.optimize.least_squares(method='trf', jac_sparsity=...) with
finite-difference grouped Jacobians (bundle_adjustment.py:301-313) — with a
design for an accelerator:

- **Analytic Jacobians**: each observation block (camera c, frame f) touches
  exactly 12 camera params + 6 pose params; ``jax.jacfwd`` over the
  per-(c,f) projection yields the closed 18-wide blocks, batched with vmap.
  The big sparse J is never materialized.
- **Block normal equations**: per-camera 12x12 blocks U_c, per-frame 6x6
  blocks V_f, cross blocks W_cf, assembled by einsum (batched matmuls).
- **Schur complement**: eliminate the frame-pose blocks (batched 6x6
  solves — embarrassingly parallel over the frame axis), reduce the dense
  camera system S (12C x 12C) with a single ``psum`` over the frame-sharded
  mesh axis, solve replicated, back-substitute poses locally. This is the
  "shard the long axis, replicate the small global state" recipe from the
  scaling playbook applied to BA (SURVEY.md §5 long-context analogue).
- **Robust loss**: soft-L1 via IRLS weights (parity with loss='soft_l1');
  Jacobi equilibration of both solves stands in for x_scale='jac' and keeps
  float32 solves well-conditioned.
- **Static shapes**: missing observations are weight-0 mask entries, never
  gathers; frozen parameters (e.g. root-camera gauge or intrinsics-only
  solves) are handled by masking Jacobian columns.

The whole optimizer is a single jitted ``lax.while_loop`` — one XLA program,
no host round-trips per iteration.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.precision import with_highest_precision
from ..ops.projection import distort_normalized
from ..ops.rotation import so3_exp, so3_left_jacobian

__all__ = [
    "LMOptions",
    "LMState",
    "HIST_FIELDS",
    "project_board_points",
    "compute_residuals",
    "compute_cost",
    "build_normal_blocks",
    "schur_solve",
    "lm_solve",
]


@dataclasses.dataclass(frozen=True)
class LMOptions:
    """Optimizer options (static under jit).

    Defaults mirror the reference's scipy call: ftol=1e-4, soft_l1 loss with
    f_scale=1 (bundle_adjustment.py:301-303).
    """

    max_iters: int = 100
    max_tries: int = 10  # damping retries per outer iteration
    ftol: float = 1e-4
    gtol: float = 1e-12
    # RELATIVE gradient stop: done when grad_norm < gtol_rel * grad_norm at
    # the first linearization. 0.0 disables. The ftol patience only counts
    # steps accepted at the first damping try (see the easy_step comment in
    # lm_solve) — correct mid-descent, but in the END-GAME every round
    # needs 2+ tries, so the optimizer polishes the gradient for many extra
    # iterations (measured 9 of 21 on the bench problem chasing gnorm
    # 25 -> 0.006 with the cost already at the f64 optimum). The gradient
    # contracts ~6 orders from its initial value by then; 1e-6 stops there
    # while being unreachable mid-descent.
    gtol_rel: float = 0.0
    init_lambda: float = 1e-4
    lambda_up: float = 5.0
    # Escalation of the rejection multiplier WITHIN a damping round: the
    # t-th consecutive failed try multiplies lambda by
    # lambda_up * lambda_escalation**t. 1.0 = classic constant multiplier;
    # 2.0 reaches a workable lambda in ~half the tries when the current
    # lambda is far too small (end-game rounds otherwise burn max_tries
    # Schur solves + cost evals marching lambda up by 5x steps).
    lambda_escalation: float = 1.0
    lambda_down: float = 1.0 / 3.0
    # Post-acceptance relaxation. "classic": lambda *= lambda_down.
    # "nielsen": lambda *= clip(1 - (2*rho - 1)^3, lambda_down, 2) with
    # rho = actual / predicted cost reduction (Madsen-Nielsen-Tingleff):
    # a high-gain step relaxes the full 3x, a barely-accepted one keeps or
    # RAISES lambda. Measured on the bench problem (CPU f64+mixed): nielsen
    # 19 iters / 24 nfev vs classic 15 / 26 — it saves retries (cheap:
    # solve + cost eval) by spending OUTER iterations (expensive: the
    # jacfwd block build), a net wall LOSS (4.5 vs 3.4 s) for this
    # build-dominated solver. Kept as an option for solve-dominated
    # problem shapes; "classic" is the right default here.
    damping_schedule: str = "classic"
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    loss: str = "soft_l1"  # or "linear"
    f_scale: float = 1.0
    # Consecutive sub-ftol easy steps required to declare convergence. f32
    # step noise produces isolated spuriously-slow iterations mid-descent;
    # with patience=1 those stop the optimizer at compile-dependent shelves
    # of the valley (observed 6x run-to-run final-cost spread).
    ftol_patience: int = 2
    # Solve precision for the Schur reduction/back-substitution. None keeps
    # the data dtype. "float64" buys f64 step quality while the bulk FLOPs
    # (block building) stay f32 — the damped camera system is
    # conditioned like 1/lambda, which f32 alone cannot solve accurately
    # (requires jax x64 mode to be enabled).
    solve_dtype: str | None = None
    # Precision for the 18-tangent jacfwd only. With f64 data,
    # jac_dtype="float32" keeps residuals/gradients/solve in f64 (the LM
    # fixed point is where the GRADIENT vanishes — it needs f64 because
    # obs-pred cancels ~4 digits) while the approximate-Hessian Jacobians
    # tolerate f32: measured identical final cost and iteration count to
    # pure f64.
    jac_dtype: str | None = None
    # Precision for the J^T J block einsums (U/V/W) only; results are cast
    # back to the data dtype. The gradient einsums (J^T r) and the residual
    # stay in the data dtype — they are the precision-critical path (obs-pred
    # cancels ~4 digits). block_dtype="float32" under f64 data changes
    # U/V/W entries only at f32 rounding (~1e-7 relative) — the approximate
    # Hessian, like jac_dtype, tolerates that.
    block_dtype: str | None = None
    # Precision for the per-damping-try cost evaluation's projection. The
    # residual is formed in this dtype then accumulated in the data dtype:
    # at 0.3 px residuals on ~300 px coordinates, f32 rounding perturbs the
    # total cost by ~1e-2 absolute (~1e-6 relative), far below the ftol
    # acceptance granularity (~1e-4 relative). Runs the forward
    # projections (one per damping try) in f32.
    cost_dtype: str | None = None
    # Precision for the per-observation weighting + gradient PRODUCTS in
    # the block build. The residual r = obs - pred is still formed in the
    # data dtype (f64 — the obs-pred cancellation is the precision-critical
    # step), and the frame-axis reduction of the per-frame gradient
    # fragments stays in the data dtype (cross-frame cancellation is where
    # the optimum's ~0 gradient emerges); only the per-observation products
    # A*w and sum_n A*(r*w) within one frame (N<=~100 terms, ~1e-7 relative
    # rounding of a correctly-computed f64 residual value) run in this
    # dtype.
    grad_dtype: str | None = None
    # Frames per linearization chunk. None materializes all (C, F) Jacobian
    # blocks in one shot (fastest for small problems). An int bounds peak
    # memory at O(C * frame_chunk * N * 36) transients by lax.scan-ning the
    # block build AND the Schur reduction over frame chunks — the dense
    # one-shot path materializes O(C * F * N * 36) jacfwd transients, which
    # at BASELINE config 5 scale (64 cams x 20k frames) is tens of GB.
    # Observation-sparse in effect: unobserved (camera, frame) pairs cost
    # FLOPs inside a chunk but never persist blocks.
    frame_chunk: int | None = None
    # Jacobian construction. "analytic": closed-form chain-rule blocks
    # computed batched over (C, F, N) in one shot — ~18x fewer FLOPs than
    # the 18-tangent jacfwd (each tangent re-runs ~the primal) and the
    # U/V/W assembly becomes full-contraction einsums (contraction axes
    # F*N*2 / C*N*2 instead of per-(c,f) N*2=70-wide matmuls). "jacfwd":
    # the original per-(c,f) jax.jacfwd path, kept as the autodiff oracle the analytic
    # blocks are tested against (they agree to f64 roundoff; see
    # tests/test_lm_analytic_jac.py). One behavioral difference: with
    # block_dtype="float32" the analytic path accumulates U/V/W over the
    # frames WITHIN a chunk inside the f32 einsum (~sqrt(chunk*70)*1e-7
    # relative rounding vs the jacfwd path's per-frame-f64 reduction) —
    # approximate-Hessian-tolerable, validated cost-vs-cost on the bench
    # problem; cross-chunk accumulation stays in the data dtype.
    jacobian: str = "analytic"


class LMState(NamedTuple):
    cam_params: jnp.ndarray  # (C, 12)
    pose_params: jnp.ndarray  # (F_local, 6)
    lam: jnp.ndarray  # damping scalar
    cost: jnp.ndarray  # current robust cost
    it: jnp.ndarray  # outer iteration counter
    done: jnp.ndarray  # convergence flag
    slow_steps: jnp.ndarray  # consecutive sub-ftol easy steps (patience)
    grad_norm: jnp.ndarray  # gradient norm at the last linearization
    grad0: jnp.ndarray  # gradient norm at the FIRST linearization (<0 unset)
    nfev: jnp.ndarray  # cumulative cost evaluations (scipy nfev analogue)
    # Per-iteration trace (max_iters, 6): cost, grad_norm, step_norm,
    # lambda, damping tries, relative cost drop — scipy verbose=2 parity
    # (bundle_adjustment.py:302) without leaving the XLA program.
    hist: jnp.ndarray


HIST_FIELDS = ("cost", "grad_norm", "step_norm", "lambda", "tries", "rel_drop")


def _unpack_cam(cam12):
    """cam12 = [fx, fy, cx, cy, k1, k2, rx, ry, rz, tx, ty, tz].

    Exact reference parameter layout (bundle_adjustment.py:128-192) so
    serialized vectors interoperate.
    """
    fx, fy, cx, cy = cam12[0], cam12[1], cam12[2], cam12[3]
    dist = cam12[4:6]
    rvec, tvec = cam12[6:9], cam12[9:12]
    return fx, fy, cx, cy, dist, rvec, tvec


def project_board_points(cam12, pose6, objpoints):
    """Forward model for one (camera, frame) block: board points -> pixels.

    Composes board->world (pose6) with world->camera (cam12[6:]) and applies
    the reference's radial k1,k2 distortion model (geometry.py:277-325).
    Returns (N, 2). Everything is fused so jacfwd emits tight 18-wide blocks.
    """
    fx, fy, cx, cy, dist, rvec, tvec = _unpack_cam(cam12)
    R_pose = so3_exp(pose6[:3])
    pts_world = objpoints @ R_pose.T + pose6[3:]
    R_cam = so3_exp(rvec)
    pts_cam = pts_world @ R_cam.T + tvec
    xy = pts_cam[..., :2] / pts_cam[..., 2:]
    xy_d = distort_normalized(xy, dist)
    u = fx * xy_d[..., 0] + cx
    v = fy * xy_d[..., 1] + cy
    return jnp.stack([u, v], axis=-1)


def compute_residuals(cam_params, pose_params, obs, mask, objpoints):
    """Masked residuals (C, F, N, 2): (obs - pred) * mask (zeros where unseen)."""
    pred = jax.vmap(  # over cameras
        jax.vmap(project_board_points, in_axes=(None, 0, None)),  # over frames
        in_axes=(0, None, None),
    )(cam_params, pose_params, objpoints)
    r = jnp.nan_to_num(obs) - pred
    return jnp.where(mask[..., None], r, 0.0)


def _robust_weights(r2, opts: LMOptions):
    """Per-component IRLS weight sqrt(rho'(z)), z = r^2 / f_scale^2.

    soft_l1: rho(z) = 2(sqrt(1+z)-1), rho'(z) = 1/sqrt(1+z).
    """
    if opts.loss == "linear":
        return jnp.ones_like(r2)
    z = r2 / (opts.f_scale**2)
    return (1.0 + z) ** -0.25  # sqrt(rho'(z))


def _robust_cost(r2_masked, opts: LMOptions, axis=None):
    """0.5 * sum rho(r_i^2) with scipy's elementwise loss semantics."""
    if opts.loss == "linear":
        return 0.5 * jnp.sum(r2_masked, axis=axis)
    fs2 = opts.f_scale**2
    z = r2_masked / fs2
    return 0.5 * fs2 * jnp.sum(2.0 * (jnp.sqrt(1.0 + z) - 1.0), axis=axis)


@with_highest_precision
def compute_cost(cam_params, pose_params, obs, mask, objpoints, opts, axis_name=None):
    """Robust cost over (optionally frame-sharded) observations.

    With ``opts.cost_dtype`` set, the forward projection and residual run in
    that dtype and only the reduction runs in the data dtype (see LMOptions).
    Carries its own fp32-matmul-precision context: a caller jitting this
    standalone (outside lm_solve's context) must not silently get
    reduced-precision (TF32) f32 projections.
    """
    dtype = cam_params.dtype
    cd = jnp.dtype(opts.cost_dtype) if opts.cost_dtype else None
    if cd is not None and cd != dtype:
        r = compute_residuals(
            cam_params.astype(cd),
            pose_params.astype(cd),
            obs.astype(cd),
            mask,
            objpoints.astype(cd),
        ).astype(dtype)
    else:
        r = compute_residuals(cam_params, pose_params, obs, mask, objpoints)
    r2 = jnp.where(mask[..., None], r**2, 0.0)
    cost = _robust_cost(r2, opts)
    if axis_name is not None:
        cost = lax.psum(cost, axis_name)
    return cost


class NormalBlocks(NamedTuple):
    """Block normal equations.

    Unchunked layout (frame_chunk=None): V (F, 6, 6), W (C, F, 12, 6),
    g_pose (F, 6). Chunked layout (scan over ``nc`` chunks of ``ck`` frames,
    F padded to nc*ck): V (nc, ck, 6, 6), W (nc, C, ck, 12, 6),
    g_pose (nc, ck, 6) — ``schur_solve`` dispatches on W.ndim.
    """

    U: jnp.ndarray  # (C, 12, 12)  camera blocks (summed over local frames)
    V: jnp.ndarray  # pose blocks (see layouts above)
    W: jnp.ndarray  # cross blocks
    g_cam: jnp.ndarray  # (C, 12)  gradient (camera part, local sum)
    g_pose: jnp.ndarray  # gradient (pose part)
    cost: jnp.ndarray  # robust cost at linearization point (local sum)


def _pvary(tree, axis_name):
    """Mark fresh arrays as varying over ``axis_name`` (shard_map scan
    carries must type-match the varying outputs they accumulate)."""
    if axis_name is None:
        return tree
    return jax.tree.map(
        lambda x: lax.pcast(x, axis_name, to="varying"), tree
    )


def build_normal_blocks(
    cam_params, pose_params, obs, mask, objpoints, opts: LMOptions,
    cam_free=None, pose_free=None, axis_name=None,
):
    """Linearize at the current params and form block normal equations.

    ``cam_free`` (C, 12) / ``pose_free`` (F, 6) are 0/1 masks; frozen columns
    get zero Jacobian (their updates come out exactly 0 after the solve since
    the corresponding diagonal is identity-padded in ``schur_solve``).

    All quantities are *local sums* over the frame axis; under frame sharding
    the caller psums U/g_cam/cost (V, W, g_pose stay local).
    """
    C = cam_params.shape[0]
    F = pose_params.shape[0]

    data_dtype = cam_params.dtype

    def per_cf(cam12, pose6, obs_cf, mask_cf):
        keep_jac = opts.grad_dtype is not None and opts.jac_dtype is not None
        pred, (A, B) = _value_and_jacs(
            cam12, pose6, objpoints, jac_dtype=opts.jac_dtype,
            keep_jac_dtype=keep_jac,
        )
        # Mask via where (NOT multiplication): masked-out entries may hold
        # NaN/inf (e.g. padded frames whose pose puts points at z=0), and
        # NaN * 0 would poison the whole normal system.
        m = mask_cf[..., None]  # (N, 1) -> broadcasts over the uv axis
        r = jnp.where(m, jnp.nan_to_num(obs_cf) - pred, 0.0)  # (N, 2)
        w = jnp.where(m, _robust_weights(r**2, opts), 0.0)  # (N, 2)
        cost_cf = _robust_cost(jnp.where(mask_cf[..., None], r**2, 0.0), opts)
        if opts.grad_dtype is not None:
            # Per-observation work in grad_dtype: the residual VALUE is
            # f64-accurate (computed above), only the products round at
            # ~1e-7 relative; per-frame fragments are cast back and frame-
            # reduced in the data dtype (see LMOptions.grad_dtype).
            gd = jnp.dtype(opts.grad_dtype)
            wg = w.astype(gd)
            A = jnp.where(m[..., None], A.astype(gd) * wg[..., None], 0.0)
            B = jnp.where(m[..., None], B.astype(gd) * wg[..., None], 0.0)
            rw = (r * w).astype(gd)
        else:
            A = jnp.where(m[..., None], A * w[..., None], 0.0)  # (N, 2, 12)
            B = jnp.where(m[..., None], B * w[..., None], 0.0)  # (N, 2, 6)
            rw = r * w
        # U/V/W in block_dtype (cast back): the approximate-Hessian blocks
        # tolerate f32 rounding; the gradient einsums keep the data dtype
        # unless grad_dtype opts in (see LMOptions.block_dtype/grad_dtype).
        # block_dtype=None means the DATA dtype even when grad_dtype has
        # downcast A/B — the two options are independent contracts.
        bd = jnp.dtype(opts.block_dtype) if opts.block_dtype else data_dtype
        Ab, Bb = A.astype(bd), B.astype(bd)
        U_cf = jnp.einsum("nki,nkj->ij", Ab, Ab).astype(data_dtype)
        V_cf = jnp.einsum("nki,nkj->ij", Bb, Bb).astype(data_dtype)
        W_cf = jnp.einsum("nki,nkj->ij", Ab, Bb).astype(data_dtype)
        g_cam_cf = jnp.einsum("nki,nk->i", A, rw).astype(data_dtype)
        g_pose_cf = jnp.einsum("nki,nk->i", B, rw).astype(data_dtype)
        return U_cf, V_cf, W_cf, g_cam_cf, g_pose_cf, cost_cf

    per_f = jax.vmap(per_cf, in_axes=(None, 0, 0, 0))  # over frames
    per_cf_all = jax.vmap(per_f, in_axes=(0, None, 0, 0))  # over cameras

    cf = None if cam_free is None else cam_free.astype(cam_params.dtype)

    def linearize(pose_k, obs_k, mask_k, pose_free_k):
        """Blocks for one frame slab: ((C,12,12),(Fk,6,6),(C,Fk,12,6),...).

        The cam_free/pose_free freezes are applied to the REDUCED blocks:
        both masks are per-camera resp. per-frame, so they distribute over
        the frame/camera sums and the result is identical to masking each
        (c, f) block before reduction.
        """
        if opts.jacobian == "analytic":
            U, V, W, g_cam, g_pose, cost = _linearize_analytic(
                cam_params, pose_k, obs_k, mask_k, objpoints, opts
            )
        else:
            U_all, V_all, W_all, gc_all, gp_all, cost_all = per_cf_all(
                cam_params, pose_k, obs_k, mask_k
            )
            # (C,Fk,12,12),(C,Fk,6,6),(C,Fk,12,6),(C,Fk,12),(C,Fk,6),(C,Fk)
            U = jnp.sum(U_all, axis=1)
            V = jnp.sum(V_all, axis=0)
            W = W_all
            g_cam = jnp.sum(gc_all, axis=1)
            g_pose = jnp.sum(gp_all, axis=0)
            cost = jnp.sum(cost_all)
        if cf is not None:
            U = U * cf[:, :, None] * cf[:, None, :]
            W = W * cf[:, None, :, None]
            g_cam = g_cam * cf
        if pose_free_k is not None:
            pf = pose_free_k.astype(pose_k.dtype)  # (Fk, 6)
            V = V * pf[:, :, None] * pf[:, None, :]
            W = W * pf[None, :, None, :]
            g_pose = g_pose * pf
        return U, V, W, g_cam, g_pose, cost

    chunk = opts.frame_chunk
    if chunk is None or chunk >= F:
        U, V, W, g_cam, g_pose, cost = linearize(
            pose_params, obs, mask, pose_free
        )
        return NormalBlocks(U=U, V=V, W=W, g_cam=g_cam, g_pose=g_pose, cost=cost)

    # Chunked: scan over frame slabs; camera accumulators carried, per-frame
    # blocks emitted in chunked layout (consumed chunked by schur_solve —
    # never re-materialized as one (C, F, ...) array).
    pad = (-F) % chunk
    nc = (F + pad) // chunk

    def pad_frames(x, axis):
        if not pad:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return jnp.pad(x, widths)

    pose_c = pad_frames(pose_params, 0).reshape(nc, chunk, 6)
    obs_c = jnp.moveaxis(
        pad_frames(obs, 1).reshape(C, nc, chunk, *obs.shape[2:]), 1, 0
    )
    mask_c = jnp.moveaxis(
        pad_frames(mask, 1).reshape(C, nc, chunk, *mask.shape[2:]), 1, 0
    )
    pf_c = (
        None
        if pose_free is None
        else pad_frames(pose_free, 0).reshape(nc, chunk, 6)
    )

    dtype = cam_params.dtype

    def body(carry, xs):
        U_acc, g_acc, cost_acc = carry
        pose_k, obs_k, mask_k = xs[:3]
        pfk = xs[3] if pf_c is not None else None
        U_k, V_k, W_k, gc_k, gp_k, cost_k = linearize(pose_k, obs_k, mask_k, pfk)
        return (U_acc + U_k, g_acc + gc_k, cost_acc + cost_k), (V_k, W_k, gp_k)

    init = _pvary(
        (
            jnp.zeros((C, 12, 12), dtype),
            jnp.zeros((C, 12), dtype),
            jnp.zeros((), dtype),
        ),
        axis_name,
    )
    xs = (pose_c, obs_c, mask_c) + (() if pf_c is None else (pf_c,))
    (U, g_cam, cost), (V_s, W_s, gp_s) = lax.scan(body, init, xs)
    return NormalBlocks(U=U, V=V_s, W=W_s, g_cam=g_cam, g_pose=gp_s, cost=cost)


def _analytic_pred_and_jacs(cam_params, pose_params, objpoints, jac_dtype=None):
    """Batched predictions + closed-form Jacobian blocks for ALL (c, f) pairs.

    cam_params (C,12), pose_params (F,6), objpoints (N,3) ->
    pred (C,F,N,2) in the data dtype; A (C,F,N,2,12), B (C,F,N,2,6) in
    ``jac_dtype`` (data dtype if None).

    Chain rule of ``project_board_points`` written out: with
    q = R_c (R_p b + t_p) + t_c, (x, y) = (q_x, q_y)/q_z,
    s(r2) = 1 + k1 r2 + k2 r2^2, (u, v) = (fx x s + cx, fy y s + cy):

      M   = diag(fx, fy) @ D @ G          (2x3 per point), where
      D   = d(x s, y s)/d(x, y) = [[s + 2x^2 s', 2xy s'], [2xy s', s + 2y^2 s']]
      G   = d(x, y)/dq = 1/q_z [[1, 0, -x], [0, 1, -y]]
      dq/dt_c = I,  dq/dr = -skew(R_c p_w) J_l(r)      (so3_left_jacobian)
      dq/dt_p = R_c, dq/drho = -R_c skew(R_p b) J_l(rho)

    The row-vector identity m^T (-skew(w)) = cross(w, m)^T turns the skew
    products into two cross products per point, so the whole Jacobian costs
    ~2x the primal instead of jacfwd's ~2x18 tangents. Verified against
    jacfwd to f64 roundoff (tests/test_lm_analytic_jac.py), including the
    theta=0 series branch. Division by q_z is guarded (|q_z| < 1e-12 -> 1)
    so masked/padded observations yield finite garbage for the caller's
    where-mask, never NaN.
    """
    dtype = cam_params.dtype
    jd = jnp.dtype(jac_dtype) if jac_dtype is not None else dtype
    fx, fy = cam_params[:, 0], cam_params[:, 1]
    cx, cy = cam_params[:, 2], cam_params[:, 3]
    k1, k2 = cam_params[:, 4], cam_params[:, 5]
    rvec, tvec = cam_params[:, 6:9], cam_params[:, 9:12]
    rho, tp = pose_params[:, :3], pose_params[:, 3:]
    R_c = so3_exp(rvec)  # (C,3,3)
    R_p = so3_exp(rho)  # (F,3,3)

    Rb = jnp.einsum("nj,fij->fni", objpoints, R_p)  # (F,N,3)
    p_w = Rb + tp[:, None, :]
    q = jnp.einsum("fnj,cij->cfni", p_w, R_c) + tvec[:, None, None, :]
    Z = q[..., 2]
    Zs = jnp.where(jnp.abs(Z) < 1e-12, jnp.ones_like(Z), Z)
    invZp = 1.0 / Zs  # one f64 division per point, not two
    x, y = q[..., 0] * invZp, q[..., 1] * invZp
    r2 = x * x + y * y
    k1b, k2b = k1[:, None, None], k2[:, None, None]
    s = 1.0 + r2 * (k1b + r2 * k2b)
    xd, yd = x * s, y * s
    fxb, fyb = fx[:, None, None], fy[:, None, None]
    pred = jnp.stack(
        [fxb * xd + cx[:, None, None], fyb * yd + cy[:, None, None]], -1
    )

    # --- Jacobian, entirely in jac_dtype (the approximate-Hessian blocks
    # tolerate f32; see LMOptions.jac_dtype). Intermediates are reused from
    # the primal by casting — identical to recomputing in jd up to rounding.
    if jd != dtype:
        cast = lambda *xs: tuple(v.astype(jd) for v in xs)
        x, y, r2, s, Zs, q, Rb, xd, yd = cast(x, y, r2, s, Zs, q, Rb, xd, yd)
        fxb, fyb, k1b, k2b = cast(fxb, fyb, k1b, k2b)
        R_c = R_c.astype(jd)
        tvec_j = tvec.astype(jd)
        Jl_c = so3_left_jacobian(rvec.astype(jd))
        Jl_p = so3_left_jacobian(rho.astype(jd))
    else:
        tvec_j = tvec
        Jl_c = so3_left_jacobian(rvec)
        Jl_p = so3_left_jacobian(rho)

    sp = k1b + 2.0 * k2b * r2  # s'(r2)
    d11 = s + 2.0 * x * x * sp
    d12 = 2.0 * x * y * sp
    d22 = s + 2.0 * y * y * sp
    invZ = 1.0 / Zs
    M0 = jnp.stack([d11, d12, -(d11 * x + d12 * y)], -1) * (fxb * invZ)[..., None]
    M1 = jnp.stack([d12, d22, -(d12 * x + d22 * y)], -1) * (fyb * invZ)[..., None]
    M = jnp.stack([M0, M1], -2)  # (C,F,N,2,3)

    zero = jnp.zeros_like(xd)
    one = jnp.ones_like(xd)
    intr_cols = jnp.stack(  # (C,F,N,2,6): d(u,v)/d(fx,fy,cx,cy,k1,k2)
        [
            jnp.stack([xd, zero], -1),
            jnp.stack([zero, yd], -1),
            jnp.stack([one, zero], -1),
            jnp.stack([zero, one], -1),
            jnp.stack([fxb * x * r2, fyb * y * r2], -1),
            jnp.stack([fxb * x * r2 * r2, fyb * y * r2 * r2], -1),
        ],
        -1,
    )
    w_cam = q - tvec_j[:, None, None, :]  # R_c p_w
    A_r = jnp.einsum(
        "cfnkj,cji->cfnki", jnp.cross(w_cam[..., None, :], M, axis=-1), Jl_c
    )
    A = jnp.concatenate([intr_cols, A_r, M], axis=-1)  # (C,F,N,2,12)
    Mc = jnp.einsum("cfnkj,cji->cfnki", M, R_c)
    B_r = jnp.einsum(
        "cfnkj,fji->cfnki",
        jnp.cross(Rb[None, :, :, None, :], Mc, axis=-1),
        Jl_p,
    )
    B = jnp.concatenate([B_r, Mc], axis=-1)  # (C,F,N,2,6)
    return pred, A, B


def _linearize_analytic(cam_params, pose_params, obs, mask, objpoints, opts):
    """Reduced normal blocks for one frame slab via the analytic Jacobians.

    Returns (U (C,12,12), V (F,6,6), W (C,F,12,6), g_cam (C,12),
    g_pose (F,6), cost) — the same local sums as the jacfwd path, but the
    U/V/W assembly runs as FULL-contraction einsums (contraction axes
    F*N*2 resp. C*N*2 instead of 70-wide per-(c,f) matmuls): a few large
    matmuls per slab instead of C*F tiny ones.

    Precision contracts (LMOptions.jac/block/grad_dtype) are preserved:
    the residual is formed in the data dtype, per-observation products run
    in grad_dtype, the gradient's frame/camera-axis reduction runs in the
    data dtype, and only U/V/W contract in block_dtype (accumulating over
    the slab's frames inside the einsum — see LMOptions.jacobian).
    """
    data_dtype = cam_params.dtype
    pred, A, B = _analytic_pred_and_jacs(
        cam_params, pose_params, objpoints, jac_dtype=opts.jac_dtype
    )
    m = mask[..., None]  # (C,F,N,1) -> broadcasts over the uv axis
    r = jnp.where(m, jnp.nan_to_num(obs) - pred, 0.0)  # data dtype
    gd = jnp.dtype(opts.grad_dtype) if opts.grad_dtype else data_dtype
    cd = jnp.dtype(opts.cost_dtype) if opts.cost_dtype else data_dtype
    # The residual VALUE r is the precision-critical quantity (obs - pred
    # cancels ~4 digits; formed in the data dtype above). The robust WEIGHT
    # w = sqrt(rho'(r^2)) and the per-observation loss rho(r^2) are smooth
    # functions of an already-accurate r — no cancellation — so with the
    # grad_dtype/cost_dtype contracts opted in they run in those dtypes.
    # The cost's cross-frame accumulation still runs in the data dtype.
    r_g = r.astype(gd)
    w = jnp.where(m, _robust_weights(r_g**2, opts), 0.0)
    rho = _robust_cost(
        jnp.where(m, r_g.astype(cd) ** 2, 0.0), opts, axis=(-2, -1)
    )  # (C, F) per-frame partials in cost_dtype
    cost = jnp.sum(rho.astype(data_dtype))

    wg = w  # already grad_dtype
    Aw = jnp.where(m[..., None], A.astype(gd) * wg[..., None], 0.0)
    Bw = jnp.where(m[..., None], B.astype(gd) * wg[..., None], 0.0)
    rw = r_g * w

    bd = jnp.dtype(opts.block_dtype) if opts.block_dtype else data_dtype
    Ab, Bb = Aw.astype(bd), Bw.astype(bd)
    U = jnp.einsum("cfnki,cfnkj->cij", Ab, Ab).astype(data_dtype)
    V = jnp.einsum("cfnki,cfnkj->fij", Bb, Bb).astype(data_dtype)
    W = jnp.einsum("cfnki,cfnkj->cfij", Ab, Bb).astype(data_dtype)
    # Per-frame gradient fragments in grad_dtype; the frame/camera-axis
    # reduction (where the optimum's ~0 gradient emerges by cancellation)
    # runs in the data dtype — same contract as the jacfwd path.
    g_cam = jnp.einsum("cfnki,cfnk->cfi", Aw, rw).astype(data_dtype).sum(1)
    g_pose = jnp.einsum("cfnki,cfnk->cfi", Bw, rw).astype(data_dtype).sum(0)
    return U, V, W, g_cam, g_pose, cost


def _value_and_jacs(cam12, pose6, objpoints, jac_dtype=None,
                    keep_jac_dtype=False):
    """Prediction plus Jacobians wrt (cam12, pose6): ((N,2), ((N,2,12),(N,2,6))).

    ``jac_dtype`` runs the jacfwd (the 18-tangent bulk of the FLOPs) in a
    lower precision than the prediction; results are cast back to the data
    dtype (see LMOptions.jac_dtype) unless ``keep_jac_dtype`` — the
    grad_dtype path consumes them in low precision directly, skipping the
    (N, 2, 18) cast-to-f64 entirely.
    """
    fun = lambda c, p: project_board_points(c, p, objpoints)
    pred = fun(cam12, pose6)
    if jac_dtype is not None and jnp.dtype(jac_dtype) != cam12.dtype:
        jd = jnp.dtype(jac_dtype)
        fun_j = lambda c, p: project_board_points(c, p, objpoints.astype(jd))
        A, B = jax.jacfwd(fun_j, argnums=(0, 1))(
            cam12.astype(jd), pose6.astype(jd)
        )
        if not keep_jac_dtype:
            A = A.astype(cam12.dtype)
            B = B.astype(cam12.dtype)
    else:
        A, B = jax.jacfwd(fun, argnums=(0, 1))(cam12, pose6)
    return pred, (A, B)


def _spd_solve(M, b):
    """Solve SPD M x = b via Cholesky (batched over leading dims).

    Cholesky instead of LU: the normal blocks are SPD by construction and
    it's ~2x cheaper.
    """
    from jax.scipy.linalg import solve_triangular

    L = jnp.linalg.cholesky(M)
    y = solve_triangular(L, b[..., None], lower=True)
    return solve_triangular(L, y, lower=True, trans=1)[..., 0]


def _spd_inverse(M):
    """Batched SPD inverse via Cholesky (see _spd_solve for why)."""
    from jax.scipy.linalg import solve_triangular

    L = jnp.linalg.cholesky(M)
    n = M.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape)
    y = solve_triangular(L, eye, lower=True)
    return solve_triangular(L, y, lower=True, trans=1)


def _equilibrated_solve(M, b):
    """Solve M x = b with Jacobi equilibration (keeps f32 solves stable)."""
    d = 1.0 / jnp.sqrt(jnp.clip(jnp.diagonal(M, axis1=-2, axis2=-1), 1e-30))
    Ms = M * d[..., :, None] * d[..., None, :]
    x = _spd_solve(Ms, b * d)
    return x * d


def schur_solve(blocks: NormalBlocks, lam, axis_name=None, eps=1e-12, opts=None):
    """Solve the damped normal equations via Schur complement.

    Damping is Marquardt-style (lam * diag), which realizes the same
    column-scaling effect as scipy's x_scale='jac'. Returns
    (dcam (C,12), dpose (F,6)). Under frame sharding (``axis_name``), U,
    g_cam and the reduced system are psum-ed; the pose back-substitution is
    local to the shard.

    With ``opts.solve_dtype`` set (e.g. "float64"), the solve runs in that
    precision while the blocks stay in the data dtype: the damped system's
    conditioning is ~1/lam, which f32 cannot solve to step accuracy — the
    cast costs O(C^2 + F) memory traffic, negligible next to block building.
    """
    C = blocks.U.shape[0]
    dtype = blocks.U.dtype
    sd = jnp.dtype(opts.solve_dtype) if opts is not None and opts.solve_dtype else dtype
    chunked = blocks.W.ndim == 5

    U = blocks.U.astype(sd)
    g_cam = blocks.g_cam.astype(sd)
    lam = jnp.asarray(lam, sd)
    if axis_name is not None:
        U = lax.psum(U, axis_name)
        g_cam = lax.psum(g_cam, axis_name)

    # Damped diagonal; identity-pad zero diagonals (frozen params / empty
    # frames) so every block stays invertible with a zero update.
    diag_U = jnp.diagonal(U, axis1=-2, axis2=-1)
    U_d = U + _diag_embed(lam * diag_U + eps + (diag_U <= 0))

    def damped_vinv(V):
        """Damped, equilibrated, batched SPD 6x6 pose-block inverses."""
        diag_V = jnp.diagonal(V, axis1=-2, axis2=-1)
        V_d = V + _diag_embed(lam * diag_V + eps + (diag_V <= 0))
        d = 1.0 / jnp.sqrt(
            jnp.clip(jnp.diagonal(V_d, axis1=-2, axis2=-1), 1e-30)
        )
        V_s = V_d * d[..., :, None] * d[..., None, :]
        return _spd_inverse(V_s) * d[..., :, None] * d[..., None, :]

    def reduce_slab(V, W, g_pose):
        """Schur contribution of one frame slab: S_cross, rhs_cross, V_inv."""
        V_inv = damped_vinv(V)
        WVinv = jnp.einsum("cfij,fjk->cfik", W, V_inv)
        S_cross = jnp.einsum("afik,bfjk->aibj", WVinv, W)
        rhs_cross = jnp.einsum("cfik,fk->ci", WVinv, g_pose)
        return S_cross, rhs_cross, V_inv

    def back_substitute(V_inv, W, g_pose, dcam):
        """dpose_f = V_f^-1 (g_pose_f - W^T dcam) for one frame slab."""
        Wt_dcam = jnp.einsum("cfik,ci->fk", W, dcam)
        return jnp.einsum("fij,fj->fi", V_inv, g_pose - Wt_dcam)

    if not chunked:
        V = blocks.V.astype(sd)
        W = blocks.W.astype(sd)
        g_pose = blocks.g_pose.astype(sd)
        S_cross, rhs_cross, V_inv = reduce_slab(V, W, g_pose)
        if axis_name is not None:
            S_cross = lax.psum(S_cross, axis_name)
            rhs_cross = lax.psum(rhs_cross, axis_name)
        S = _blockdiag_embed(U_d, C) - S_cross.reshape(12 * C, 12 * C)
        rhs = (g_cam - rhs_cross).reshape(12 * C)
        dcam = _equilibrated_solve(S, rhs).reshape(C, 12)
        dpose = back_substitute(V_inv, W, g_pose, dcam)
        return dcam.astype(dtype), dpose.astype(dtype)

    # Chunked layout: scan the Schur reduction over frame slabs so peak
    # memory is O(C * chunk * 72) regardless of F (BASELINE config 5 path).
    V_c = blocks.V.astype(sd)  # (nc, ck, 6, 6)
    W_c = blocks.W.astype(sd)  # (nc, C, ck, 12, 6)
    gp_c = blocks.g_pose.astype(sd)  # (nc, ck, 6)

    def body(carry, xs):
        S_acc, r_acc = carry
        S_k, r_k, V_inv_k = reduce_slab(*xs)
        return (S_acc + S_k, r_acc + r_k), V_inv_k

    init = _pvary(
        (
            jnp.zeros((C, 12, C, 12), sd),
            jnp.zeros((C, 12), sd),
        ),
        axis_name,
    )
    (S_cross, rhs_cross), V_inv_c = lax.scan(body, init, (V_c, W_c, gp_c))
    if axis_name is not None:
        S_cross = lax.psum(S_cross, axis_name)
        rhs_cross = lax.psum(rhs_cross, axis_name)

    S = _blockdiag_embed(U_d, C) - S_cross.reshape(12 * C, 12 * C)
    rhs = (g_cam - rhs_cross).reshape(12 * C)
    dcam = _equilibrated_solve(S, rhs).reshape(C, 12)

    _, dpose_c = lax.scan(
        lambda c, xs: (c, back_substitute(*xs, dcam)),
        jnp.zeros((), sd),
        (V_inv_c, W_c, gp_c),
    )
    # (nc, ck, 6) -> (nc*ck, 6); callers slice off frame padding.
    dpose = dpose_c.reshape(-1, 6)
    return dcam.astype(dtype), dpose.astype(dtype)


def _diag_embed(diags):
    """(..., n) -> (..., n, n) diagonal matrices."""
    n = diags.shape[-1]
    return diags[..., :, None] * jnp.eye(n, dtype=diags.dtype)


def _blockdiag_embed(blocks, C):
    """(C, 12, 12) -> (12C, 12C) block-diagonal."""
    out = jnp.zeros((C, 12, C, 12), dtype=blocks.dtype)
    idx = jnp.arange(C)
    out = out.at[idx, :, idx, :].set(blocks)
    return out.reshape(12 * C, 12 * C)


@functools.partial(jax.jit, static_argnames=("opts", "axis_name"))
@with_highest_precision
def lm_solve(
    cam_params,
    pose_params,
    obs,
    mask,
    objpoints,
    opts: LMOptions = LMOptions(),
    cam_free=None,
    pose_free=None,
    axis_name=None,
    init_lam=None,
    init_grad0=None,
):
    """Run the full LM loop; returns (cam, poses, info dict).

    Single XLA program: ``lax.while_loop`` over outer iterations, nested
    ``lax.while_loop`` over damping retries (blocks reused across retries —
    only the cheap Schur solve and a residual-only cost eval re-run).
    Works identically single-device or inside shard_map with ``axis_name``
    set to the frame mesh axis. ``init_lam`` (traced) overrides
    ``opts.init_lambda`` so a checkpointed run resumes with its saved
    damping without recompiling; ``init_grad0`` likewise carries the
    FIRST linearization's gradient norm across checkpoint chunks so the
    ``gtol_rel`` stop measures contraction from the true start of the
    optimization, not of each resumed segment.
    """
    dtype = cam_params.dtype
    cost0 = compute_cost(
        cam_params, pose_params, obs, mask, objpoints, opts, axis_name
    )

    def cost_fn(cam, poses):
        return compute_cost(cam, poses, obs, mask, objpoints, opts, axis_name)

    def outer_body(state: LMState):
        blocks = build_normal_blocks(
            state.cam_params, state.pose_params, obs, mask, objpoints, opts,
            cam_free, pose_free, axis_name=axis_name,
        )
        grad_norm = jnp.sqrt(
            jnp.sum(
                (lax.psum(blocks.g_cam, axis_name) if axis_name else blocks.g_cam)
                ** 2
            )
            + (
                lax.psum(jnp.sum(blocks.g_pose**2), axis_name)
                if axis_name
                else jnp.sum(blocks.g_pose**2)
            )
        )

        nielsen = opts.damping_schedule == "nielsen"
        cdtype = state.cost.dtype

        def gain_ratio(lam, dcam, dpose, cost_try):
            """rho = actual / predicted reduction. For the Marquardt step
            (A + lam*D) h = g (D = diag blocks, g the solve RHS) the model
            reduction is L(0)-L(h) = 0.5 * h^T (lam*D*h + g). O(C*12+F*6)
            dot products — negligible next to the solve itself."""
            diag_u = jnp.diagonal(blocks.U, axis1=-2, axis2=-1).astype(cdtype)
            g_cam = blocks.g_cam.astype(cdtype)
            if axis_name is not None:
                diag_u = lax.psum(diag_u, axis_name)
                g_cam = lax.psum(g_cam, axis_name)
            F = state.pose_params.shape[0]
            diag_v = jnp.diagonal(
                blocks.V.reshape(-1, 6, 6)[:F], axis1=-2, axis2=-1
            ).astype(cdtype)
            g_pose = blocks.g_pose.reshape(-1, 6)[:F].astype(cdtype)
            dc = dcam.astype(cdtype)
            dp = dpose.astype(cdtype)
            lam_c = jnp.asarray(lam, cdtype)
            term_cam = jnp.sum(dc * (lam_c * diag_u * dc + g_cam))
            term_pose = jnp.sum(dp * (lam_c * diag_v * dp + g_pose))
            if axis_name is not None:
                term_pose = lax.psum(term_pose, axis_name)
            pred = 0.5 * (term_cam + term_pose)
            return (state.cost - cost_try) / jnp.maximum(pred, 1e-30)

        # Inner: retry with increasing damping until cost decreases.
        def inner_cond(t):
            _, _, _, lam, tries, accepted, _, _ = t
            return (~accepted) & (tries < opts.max_tries) & (lam < opts.max_lambda)

        def inner_body(t):
            cam, poses, cost_new, lam, tries, _, _, rho_prev = t
            dcam, dpose = schur_solve(blocks, lam, axis_name, opts=opts)
            cam_try = state.cam_params + dcam
            # Chunked solves return nc*ck >= F rows; drop frame padding.
            poses_try = state.pose_params + dpose[: state.pose_params.shape[0]]
            cost_try = cost_fn(cam_try, poses_try)
            accepted = (cost_try < state.cost) & jnp.isfinite(cost_try)
            rho = (
                gain_ratio(lam, dcam, dpose[: state.pose_params.shape[0]], cost_try)
                if nielsen
                else rho_prev
            )
            step_up = opts.lambda_up * opts.lambda_escalation ** tries.astype(
                state.cost.dtype
            )
            lam_next = jnp.where(accepted, lam, lam * step_up)
            return (
                jnp.where(accepted, cam_try, cam),
                jnp.where(accepted, poses_try, poses),
                jnp.where(accepted, cost_try, cost_new),
                lam_next,
                tries + 1,
                accepted,
                lam,
                rho,
            )

        init = (
            state.cam_params,
            state.pose_params,
            state.cost,
            state.lam,
            jnp.zeros((), jnp.int32),
            jnp.zeros((), bool),
            state.lam,
            jnp.ones((), cdtype),
        )
        cam_n, poses_n, cost_n, lam_n, tries_used, accepted, lam_used, rho_used = (
            lax.while_loop(inner_cond, inner_body, init)
        )

        # On acceptance relax damping; on total failure keep raised lambda.
        if nielsen:
            relax = jnp.clip(
                1.0 - (2.0 * rho_used - 1.0) ** 3, opts.lambda_down, 2.0
            )
        else:
            relax = jnp.asarray(opts.lambda_down, cdtype)
        lam_next = jnp.clip(
            jnp.where(accepted, lam_used * relax, lam_n),
            opts.min_lambda,
            opts.max_lambda,
        )
        rel_drop = (state.cost - cost_n) / jnp.maximum(state.cost, 1e-30)
        # ftol convergence only counts on an UNthrottled step (accepted at
        # the first damping try): a small drop forced by a temporarily high
        # lambda mid-descent is not convergence (scipy TRF keeps going in
        # that situation too — it shrinks the trust region and retries).
        easy_step = accepted & (tries_used == 1)
        # A failed round of damping retries is NOT termination unless lambda
        # has hit its ceiling: persist with the raised lambda, like scipy TRF
        # shrinking the trust region across iterations. Terminating on the
        # first failed round made f32 runs stop at wildly run-dependent
        # points of the valley (observed 6.5k-57k final costs on the same
        # problem). (Counting failed rounds toward the ftol patience was
        # tried in r2: zero wall-clock effect on the bench problem, and it
        # let chunked/dense trajectories diverge in iteration count at the
        # endgame — reverted.)
        exhausted = (~accepted) & (lam_next >= opts.max_lambda)
        slow = easy_step & (rel_drop < opts.ftol)
        slow_steps = jnp.where(slow, state.slow_steps + 1, 0)
        grad0 = jnp.where(state.grad0 < 0, grad_norm, state.grad0)
        done = exhausted | (slow_steps >= opts.ftol_patience) | (
            grad_norm < opts.gtol
        )
        if opts.gtol_rel > 0:
            done = done | (grad_norm < opts.gtol_rel * grad0)
        step_sq = jnp.sum((cam_n - state.cam_params) ** 2)
        pose_sq = jnp.sum((poses_n - state.pose_params) ** 2)
        if axis_name is not None:
            pose_sq = lax.psum(pose_sq, axis_name)
        hist = state.hist.at[state.it].set(
            jnp.stack(
                [
                    cost_n,
                    grad_norm,
                    jnp.sqrt(step_sq + pose_sq),
                    lam_used,
                    tries_used.astype(dtype),
                    rel_drop,
                ]
            ).astype(dtype)
        )
        return LMState(
            cam_n, poses_n, lam_next, cost_n, state.it + 1, done, slow_steps,
            grad_norm, grad0, state.nfev + tries_used, hist,
        )

    def outer_cond(state: LMState):
        return (~state.done) & (state.it < opts.max_iters)

    init_state = LMState(
        cam_params=cam_params,
        pose_params=pose_params,
        lam=(
            jnp.asarray(opts.init_lambda, dtype)
            if init_lam is None
            else jnp.asarray(init_lam, dtype)
        ),
        cost=cost0,
        it=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        slow_steps=jnp.zeros((), jnp.int32),
        grad_norm=jnp.zeros((), dtype),
        grad0=(
            jnp.full((), -1.0, dtype)
            if init_grad0 is None
            else jnp.asarray(init_grad0, dtype)
        ),
        nfev=jnp.ones((), jnp.int32),  # the initial cost evaluation
        hist=jnp.zeros((opts.max_iters, len(HIST_FIELDS)), dtype),
    )
    final = lax.while_loop(outer_cond, outer_body, init_state)
    info = {
        "initial_cost": cost0,
        "final_cost": final.cost,
        "n_iters": final.it,
        "lambda": final.lam,
        "converged": final.done,
        "optimality": final.grad_norm,  # scipy OptimizeResult.optimality
        "nfev": final.nfev,
        "grad0": final.grad0,
        "history": final.hist,  # (max_iters, 6), rows [:n_iters] valid
    }
    return final.cam_params, final.pose_params, info
