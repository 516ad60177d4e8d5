"""The MPPI control step and the command geometry."""

from ccv_mppi_path_tracker_tpu_torch.solver.batch import build_fleet_step, init_fleet
from ccv_mppi_path_tracker_tpu_torch.solver.command import (
    STEERING_MODE_NAMES,
    WheelSteerCommand,
    command_from_solution,
    steering_mode,
    wheel_speeds,
    wheel_steer_angles,
)
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import (
    CompiledStep,
    MPPISolver,
    compile_step,
    mppi_step,
)

__all__ = ["CompiledStep", "MPPISolver", "STEERING_MODE_NAMES", "WheelSteerCommand",
           "build_fleet_step", "command_from_solution", "compile_step", "init_fleet",
           "mppi_step", "steering_mode", "wheel_speeds", "wheel_steer_angles"]
