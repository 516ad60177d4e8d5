"""The MPPI control step."""

from ccv_mppi_path_tracker_tpu_torch.solver.batch import build_fleet_step, init_fleet
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import MPPISolver, mppi_step

__all__ = ["MPPISolver", "build_fleet_step", "init_fleet", "mppi_step"]
