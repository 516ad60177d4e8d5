"""The MPPI control step."""

from ccv_mppi_path_tracker_tpu_torch.solver.mppi import MPPISolver, mppi_step

__all__ = ["MPPISolver", "mppi_step"]
