"""Batched geometry: rotations, projection, DLT triangulation.

The port of monocularsfm_tpu/geometry (reference parity:
src/Reconstruction/Projection.cpp, Triangulator.cpp and the Rodrigues
conversions OpenCV supplies to the reference), as plain tensor code.
"""

from monocularsfm_torch.geometry.rotations import (
    angle_axis_to_matrix,
    matrix_to_angle_axis,
    matrix_to_quaternion,
    quaternion_to_matrix,
)
from monocularsfm_torch.geometry.projection import (
    project,
    calculate_reprojection_error,
    calculate_parallax_angle_deg,
    has_positive_depth,
    camera_center,
)
from monocularsfm_torch.geometry.triangulation import (
    triangulate_two_view,
    triangulate_n_view,
)

__all__ = [
    "angle_axis_to_matrix",
    "matrix_to_angle_axis",
    "matrix_to_quaternion",
    "quaternion_to_matrix",
    "project",
    "calculate_reprojection_error",
    "calculate_parallax_angle_deg",
    "has_positive_depth",
    "camera_center",
    "triangulate_two_view",
    "triangulate_n_view",
]
