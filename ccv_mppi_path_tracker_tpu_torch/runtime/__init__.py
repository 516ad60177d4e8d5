"""Plant, closed-loop drivers and checkpoint/resume. The serving loops
(``runtime/realtime.py``), the host runtime (``runtime/native.py``), the
input gate, estimation, synthetic sensors and the pure-pursuit baseline are
imported from their modules."""

from ccv_mppi_path_tracker_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from ccv_mppi_path_tracker_tpu_torch.runtime.loop import (
    ControlLoop,
    run_tracking_experiment,
    simulate,
)
from ccv_mppi_path_tracker_tpu_torch.runtime.plant import Plant

__all__ = ["ControlLoop", "Plant", "load_checkpoint", "run_tracking_experiment",
           "save_checkpoint", "simulate"]
