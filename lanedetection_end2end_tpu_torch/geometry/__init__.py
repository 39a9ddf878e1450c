from lanedetection_end2end_tpu_torch.geometry.dlt import (
    dlt_anchor_points, dlt_homography)
from lanedetection_end2end_tpu_torch.geometry.homography import (
    base_grid, bev_matrices_normalized, bev_matrices_pixel, camera_roll,
    eval_matrices_normalized, get_perspective_transform,
    homogeneous_transform, projective_grid)

__all__ = ["base_grid", "bev_matrices_normalized", "bev_matrices_pixel",
           "camera_roll", "dlt_anchor_points", "dlt_homography",
           "eval_matrices_normalized", "get_perspective_transform",
           "homogeneous_transform", "projective_grid"]
