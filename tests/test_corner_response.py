"""Corner response and NMS: the shift-add forms against the plain references.

``corner_response`` (sums of shifted slices) must match
``corner_response_reference`` (five 1-channel convolutions, f64) over the
whole image, borders included — both are zero-padded SAME filters at
every step. Production grays are f32, so the f32 comparison is at f32
rounding; the limit 1e-5 of max |response| is what a TF32 path (~1e-3)
would fail.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import lax

from multicam_calibration_tpu.detection.detector import (
    _local_max_mask,
    corner_response,
    corner_response_reference,
    find_corner_candidates,
)


def _reference(g, sigma):
    with jax.default_matmul_precision("highest"):
        return np.asarray(
            corner_response_reference(jnp.asarray(g, jnp.float64), sigma)
        )


def _rel_err(out, ref):
    return float(np.abs(np.asarray(out, np.float64) - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize(
    "shape",
    [(1, 64, 64), (2, 100, 150), (3, 128, 256), (1, 130, 131)],
)
def test_corner_response_matches_reference(shape, rng):
    g = rng.random(shape)
    ref = _reference(g, 1.5)
    out = corner_response(jnp.asarray(g, jnp.float32))
    assert out.shape == ref.shape and out.dtype == jnp.float32
    assert _rel_err(out, ref) <= 1e-5
    # In f64 the two forms agree to rounding.
    assert _rel_err(corner_response(jnp.asarray(g)), ref) <= 1e-12


@pytest.mark.parametrize("sigma", [2.5, 3.5, 6.0, 9.0])
def test_corner_response_sigmas(rng, sigma):
    """The coarse-retry ladder (_COARSE_SCALES) runs sigma 3.5/6/9 —
    radius 11-27 taps on a frame not much larger than the kernel."""
    g = rng.random((1, 128, 192))
    ref = _reference(g, sigma)
    assert _rel_err(corner_response(jnp.asarray(g, jnp.float32), sigma),
                    ref) <= 1e-5


def test_corner_response_ignores_matmul_precision(rng):
    """No matrix unit in the shift-add form: the default (possibly TF32)
    and highest precisions give bit-identical responses."""
    g = jnp.asarray(rng.random((1, 64, 96)), jnp.float32)
    a = jax.jit(corner_response)(g)
    with jax.default_matmul_precision("highest"):
        b = jax.jit(corner_response)(g)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("shape", [(2, 100, 150), (1, 128, 256)])
def test_local_max_mask_matches_reduce_window(shape, radius, rng):
    resp = jnp.asarray(rng.standard_normal(shape))
    win = 2 * radius + 1
    local_max = lax.reduce_window(
        resp, -jnp.inf, lax.max, (1, win, win), (1, 1, 1), "SAME"
    )
    ref = (resp >= local_max) & (resp > 0)
    np.testing.assert_array_equal(
        np.asarray(_local_max_mask(resp, radius)), np.asarray(ref)
    )


def test_find_corner_candidates_on_checkerboard(rng):
    """Candidates land on the X-corners of a synthetic checkerboard, with
    scores sorted descending."""
    H = W = 96
    y, x = np.mgrid[0:H, 0:W]
    board = ((x // 16 + y // 16) % 2).astype(np.float32)
    g = jnp.asarray(board[None] + 0.005 * rng.random((1, H, W)), jnp.float32)
    xy, score = find_corner_candidates(g, max_candidates=32)
    s = np.asarray(score[0])
    assert np.all(np.diff(s) <= 0)
    strong = np.asarray(xy[0])[s > 0.5 * s[0]]
    assert len(strong) >= 16  # the 5x5 interior X-corners minus margins
    # Integer NMS peaks sit within a pixel of a lattice corner (x, y = 16k).
    off = np.abs(((strong + 8) % 16) - 8)
    assert off.max() <= 1.0


def test_corner_response_finds_saddles(rng):
    H = W = 96
    y, x = np.mgrid[0:H, 0:W]
    board = ((x // 16 + y // 16) % 2).astype(np.float32)
    g = jnp.asarray(board[None] + 0.01 * rng.random((1, H, W)), jnp.float32)
    out = np.asarray(corner_response(g))[0]
    iy, ix = np.unravel_index(np.argmax(out), out.shape)
    assert min(iy % 16, 16 - iy % 16) <= 1
    assert min(ix % 16, 16 - ix % 16) <= 1
    assert out.max() > 0
