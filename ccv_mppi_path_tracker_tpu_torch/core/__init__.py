"""Configuration, types, presets and the PRNG policy."""

from ccv_mppi_path_tracker_tpu_torch.core.config import (
    CostParams,
    SolverConfig,
    SolverParams,
    full_body_config,
    make_cost_params,
    make_solver_params,
)
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS, full_body_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, RefWindow, StepResult

__all__ = [
    "ControllerState", "CostParams", "PRESETS", "RefWindow", "SolverConfig",
    "SolverParams", "StepResult", "full_body_config", "full_body_launch",
    "make_cost_params", "make_solver_params",
]
