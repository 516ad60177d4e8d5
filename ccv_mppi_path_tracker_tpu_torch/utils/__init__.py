"""Tracing and profiling utilities."""

from ccv_mppi_path_tracker_tpu_torch.utils.profiling import PhaseTimer, device_trace

__all__ = ["PhaseTimer", "device_trace"]
