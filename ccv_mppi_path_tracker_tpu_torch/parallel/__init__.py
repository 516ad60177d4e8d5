"""Sample-sharded MPPI over ``torch.distributed`` (port of ``parallel/``)."""

from ccv_mppi_path_tracker_tpu_torch.parallel.mesh import SAMPLES_AXIS, samples_group
from ccv_mppi_path_tracker_tpu_torch.parallel.multihost import (
    initialize_multihost,
    shutdown_multihost,
)
from ccv_mppi_path_tracker_tpu_torch.parallel.sharded import (
    build_sharded_simulate,
    build_sharded_step,
)

__all__ = ["SAMPLES_AXIS", "build_sharded_simulate", "build_sharded_step",
           "initialize_multihost", "samples_group", "shutdown_multihost"]
