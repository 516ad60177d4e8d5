"""Course generation, spline smoothing and horizon resampling."""

from ccv_mppi_path_tracker_tpu_torch.paths.courses import (
    circle_course,
    dkan_course,
    filtered_square_course,
    sum_of_cosines_course,
    waypoint_course,
)
from ccv_mppi_path_tracker_tpu_torch.paths.resample import (
    PathBuffer,
    nearest_index,
    resample_reference,
    resample_references,
)
from ccv_mppi_path_tracker_tpu_torch.paths.spline import CubicSpline, spline_resample_course

__all__ = ["CubicSpline", "PathBuffer", "circle_course", "dkan_course",
           "filtered_square_course", "nearest_index", "resample_reference",
           "resample_references", "spline_resample_course", "sum_of_cosines_course",
           "waypoint_course"]
