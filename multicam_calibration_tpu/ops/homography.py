"""Batched planar homography ops (DLT fit, application, image warping).

JAX replacement for the reference's OpenCV homography delegates
(cv2.findHomography at detection.py:291, cv2.getPerspectiveTransform /
cv2.warpPerspective at detection.py:417-433, cv2.perspectiveTransform at
viz.py:168-171): a Hartley-normalized DLT solved as a batched SVD, an exact
4-point solve, and a bilinear inverse-warp usable on batches of images.
"""
from __future__ import annotations

import jax.numpy as jnp

from .transforms import euclidean_to_homogenous, homogeneous_to_euclidean

__all__ = [
    "fit_homography",
    "apply_homography",
    "get_perspective_transform",
    "warp_perspective",
]


def _normalization_transform(pts):
    """Hartley normalization: similarity mapping pts to mean 0, RMS sqrt(2)."""
    mean = jnp.mean(pts, axis=-2, keepdims=True)
    centered = pts - mean
    scale = jnp.sqrt(2.0) / jnp.maximum(
        jnp.mean(jnp.linalg.norm(centered, axis=-1), axis=-1), 1e-12
    )
    s = scale[..., None, None]
    zeros = jnp.zeros_like(s)
    ones = jnp.ones_like(s)
    mx = mean[..., 0:1, 0:1]
    my = mean[..., 0:1, 1:2]
    row0 = jnp.concatenate([s, zeros, -s * mx], axis=-1)
    row1 = jnp.concatenate([zeros, s, -s * my], axis=-1)
    row2 = jnp.concatenate([zeros, zeros, ones], axis=-1)
    return jnp.concatenate([row0, row1, row2], axis=-2)


def inv3x3(M):
    """Closed-form (adjugate) 3x3 inverse, batched over leading dims.

    Closed form instead of an LU decomposition: one fused elementwise
    computation for any batch. Singular inputs produce inf/NaN, matching
    LU behavior.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([D, E, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def fit_homography(src, dst, weights=None, method="eigh"):
    """Least-squares homography H with dst ~ H @ src, batched over leading dims.

    ``src``/``dst``: (..., N, 2) with N >= 4. Hartley-normalized DLT; the
    solution is the smallest right singular vector of the (2N, 9) design
    matrix. Optional per-point ``weights`` (..., N) downweight rows (used for
    masked/ragged batches — weight 0 removes a correspondence).

    ``method`` selects the minimizer of the (normalized) algebraic error:

    - ``"eigh"`` (default): the classic ||h|| = 1 DLT via a batched 9x9
      eigendecomposition — handles every homography including those with
      h33 ~ 0 after normalization.
    - ``"solve"``: gauge-fix h33 = 1 and solve the 8x8 normal equations
      (one fused Cholesky-style solve), cheaper than eigh's iterative
      Jacobi sweeps; Hartley normalization keeps
      h33 = 1 valid for the near-affine grid/anchor homographies the
      detection fast path fits (a true h33 ~ 0 view is a board seen
      edge-on — rejected upstream long before the fit).
    """
    src = jnp.asarray(src)
    dst = jnp.asarray(dst)
    Ts = _normalization_transform(src)
    Td = _normalization_transform(dst)
    src_n = homogeneous_to_euclidean(
        jnp.einsum("...ij,...nj->...ni", Ts, euclidean_to_homogenous(src))
    )
    dst_n = homogeneous_to_euclidean(
        jnp.einsum("...ij,...nj->...ni", Td, euclidean_to_homogenous(dst))
    )
    x, y = src_n[..., 0], src_n[..., 1]
    u, v = dst_n[..., 0], dst_n[..., 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    # Standard DLT rows for each correspondence.
    row_u = jnp.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], axis=-1)
    row_v = jnp.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v], axis=-1)
    A = jnp.concatenate([row_u, row_v], axis=-2)
    if weights is not None:
        w = jnp.concatenate([weights, weights], axis=-1)[..., None]
        A = A * w
    if method == "solve":
        # min ||A8 h8 + a9|| with h9 = 1: 8x8 normal equations.
        A8, a9 = A[..., :8], A[..., 8]
        N8 = jnp.einsum("...ni,...nj->...ij", A8, A8)
        g8 = jnp.einsum("...ni,...n->...i", A8, a9)
        # SPD solve via Cholesky (the SPD normal matrix needs no
        # pivoting at any dtype).
        eye8 = jnp.eye(8, dtype=A.dtype)
        tr = jnp.trace(N8, axis1=-2, axis2=-1)[..., None, None]
        L = jnp.linalg.cholesky(N8 + 1e-9 * tr * eye8)
        from jax.scipy.linalg import cho_solve

        h8 = cho_solve((L, True), -g8[..., None])[..., 0]
        h = jnp.concatenate([h8, jnp.ones_like(h8[..., :1])], axis=-1)
    else:
        # Smallest right singular vector via eigh of A^T A (9x9, batched).
        ATA = jnp.einsum("...ni,...nj->...ij", A, A)
        _, vecs = jnp.linalg.eigh(ATA)
        h = vecs[..., :, 0]
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    # Td is an upper-triangular similarity -> triangular solve.
    from jax.scipy.linalg import solve_triangular

    H = solve_triangular(Td, Hn @ Ts, lower=False)
    return H / H[..., 2:3, 2:3]


def apply_homography(H, pts):
    """Apply 3x3 homographies to points (..., N, 2) (cv2.perspectiveTransform)."""
    out = jnp.einsum("...ij,...nj->...ni", H, euclidean_to_homogenous(pts))
    return homogeneous_to_euclidean(out)


def get_perspective_transform(src, dst):
    """Exact homography from 4 point pairs (cv2.getPerspectiveTransform)."""
    return fit_homography(src, dst)


def warp_perspective(image, H, out_shape):
    """Inverse-warp ``image`` (H, W) or (H, W, C) by homography ``H``.

    Samples ``image`` at ``H^-1 @ (x, y, 1)`` for each output pixel with
    bilinear interpolation and zero padding — semantics of
    ``cv2.warpPerspective(image, H, (out_w, out_h))``. ``out_shape`` is
    (out_h, out_w). Fully vectorized; batch by vmap-ing over (image, H).
    """
    out_h, out_w = out_shape
    Hinv = inv3x3(H)
    ys, xs = jnp.meshgrid(
        jnp.arange(out_h, dtype=Hinv.dtype),
        jnp.arange(out_w, dtype=Hinv.dtype),
        indexing="ij",
    )
    grid = jnp.stack([xs, ys], axis=-1).reshape(-1, 2)
    src_xy = apply_homography(Hinv, grid).reshape(out_h, out_w, 2)
    x, y = src_xy[..., 0], src_xy[..., 1]

    img = image if image.ndim == 3 else image[..., None]
    in_h, in_w = img.shape[:2]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < in_h) & (xi >= 0) & (xi < in_w)
        yi_c = jnp.clip(yi, 0, in_h - 1).astype(jnp.int32)
        xi_c = jnp.clip(xi, 0, in_w - 1).astype(jnp.int32)
        vals = img[yi_c, xi_c].astype(wx.dtype)
        return jnp.where(valid[..., None], vals, 0.0)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )
    return out[..., 0] if image.ndim == 2 else out
