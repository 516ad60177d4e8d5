"""Tracking-quality metrics."""

from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import (
    nearest_point_errors,
    tracking_metrics,
)

__all__ = ["nearest_point_errors", "tracking_metrics"]
