"""Course generation and horizon resampling."""

from ccv_mppi_path_tracker_tpu_torch.paths.courses import sum_of_cosines_course
from ccv_mppi_path_tracker_tpu_torch.paths.resample import (
    PathBuffer,
    nearest_index,
    resample_reference,
    resample_references,
)

__all__ = ["PathBuffer", "nearest_index", "resample_reference", "resample_references",
           "sum_of_cosines_course"]
