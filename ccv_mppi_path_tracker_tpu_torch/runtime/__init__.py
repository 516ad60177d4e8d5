"""Plant and closed-loop driver."""

from ccv_mppi_path_tracker_tpu_torch.runtime.loop import (
    ControlLoop,
    run_tracking_experiment,
    simulate,
)
from ccv_mppi_path_tracker_tpu_torch.runtime.plant import Plant

__all__ = ["ControlLoop", "Plant", "run_tracking_experiment", "simulate"]
