"""Configuration, types, presets and the PRNG policy."""

from ccv_mppi_path_tracker_tpu_torch.core.config import (
    CostParams,
    SolverConfig,
    SolverParams,
    diff_drive_config,
    full_body_config,
    make_cost_params,
    make_solver_params,
    rate_limited_steering_config,
    steering_diff_drive_config,
)
from ccv_mppi_path_tracker_tpu_torch.core.presets import (
    PRESETS,
    diff_drive_launch,
    full_body_launch,
    rate_limited_launch,
    steering_launch,
)
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, RefWindow, StepResult

__all__ = [
    "ControllerState", "CostParams", "PRESETS", "RefWindow", "SolverConfig",
    "SolverParams", "StepResult", "diff_drive_config", "diff_drive_launch",
    "full_body_config", "full_body_launch", "make_cost_params",
    "make_solver_params", "rate_limited_launch", "rate_limited_steering_config",
    "steering_diff_drive_config", "steering_launch",
]
