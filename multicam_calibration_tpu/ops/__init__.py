"""Geometry + image compute ops: the JAX foundation layer.

Everything here is a pure function (vmap/jit/grad-safe) — this layer replaces
the reference's geometry.py plus its OpenCV/LAPACK delegates (SURVEY.md §2).
"""
from .rotation import rodrigues, rodrigues_inv, so3_exp, so3_log, skew
from .transforms import (
    apply_rigid_transform,
    euclidean_to_homogenous,
    get_projection_matrix,
    get_transformation_matrix,
    get_transformation_vector,
    homogeneous_to_euclidean,
    rigid_transform_from_correspondences,
    se3_compose,
    se3_inverse,
    se3_inverse_vector,
)
from .projection import (
    denormalize_points,
    distort_normalized,
    distort_points,
    normalize_points,
    project_points,
    undistort_normalized,
    undistort_points,
)
from .homography import (
    apply_homography,
    fit_homography,
    inv3x3,
    get_perspective_transform,
    warp_perspective,
)
from .triangulation import triangulate, triangulate_dlt, triangulate_pairs
from .reductions import masked_mean, masked_median, nanmedian

__all__ = [
    "rodrigues",
    "rodrigues_inv",
    "so3_exp",
    "so3_log",
    "skew",
    "apply_rigid_transform",
    "euclidean_to_homogenous",
    "get_projection_matrix",
    "get_transformation_matrix",
    "get_transformation_vector",
    "homogeneous_to_euclidean",
    "rigid_transform_from_correspondences",
    "se3_compose",
    "se3_inverse",
    "se3_inverse_vector",
    "denormalize_points",
    "distort_normalized",
    "distort_points",
    "normalize_points",
    "project_points",
    "undistort_normalized",
    "undistort_points",
    "apply_homography",
    "fit_homography",
    "inv3x3",
    "get_perspective_transform",
    "warp_perspective",
    "triangulate",
    "triangulate_dlt",
    "triangulate_pairs",
    "masked_mean",
    "masked_median",
    "nanmedian",
]
