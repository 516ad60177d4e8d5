"""Tracking-quality metrics and CSV recording. The figures and the animation
(``metrics/plots.py``, ``metrics/animate.py``) are imported from their
modules; they need matplotlib, which they import when they draw."""

from ccv_mppi_path_tracker_tpu_torch.metrics.recorder import Recorder, read_log
from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import (
    nearest_point_errors,
    tracking_metrics,
)

__all__ = ["Recorder", "nearest_point_errors", "read_log", "tracking_metrics"]
