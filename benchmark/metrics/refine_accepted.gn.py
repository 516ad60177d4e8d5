"""Share of the Gauss-Newton steps that the Levenberg-Marquardt guard
accepted, in %: the device counters ``refine.lm_accepted`` over
``refine.lm_steps`` of the port's registry (utils/profiling.py). A CUDA graph
of the refined update adds to them at every replay, so they count every
refined update of the run: set-up, the timed window and the traced window.
None where the port counted no step (a port without device counters).
Moves ``propagations_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    steps = counters.get("refine.lm_steps", 0)
    return 100.0 * counters.get("refine.lm_accepted", 0) / steps if steps else None
