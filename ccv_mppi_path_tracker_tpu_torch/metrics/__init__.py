"""Tracking-quality metrics and CSV recording."""

from ccv_mppi_path_tracker_tpu_torch.metrics.recorder import Recorder, read_log
from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import (
    nearest_point_errors,
    tracking_metrics,
)

__all__ = ["Recorder", "nearest_point_errors", "read_log", "tracking_metrics"]
