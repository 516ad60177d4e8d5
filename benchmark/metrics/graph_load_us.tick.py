"""Microseconds a compiled fleet tick spends in the load of the graph's inputs:
the check of which tensors changed and their grouped copy into the graph's
buffers (``_Graph.load``): span ``graphed.load`` of the port's registry
(utils/profiling.py), mean a call. The spans record only while the profiler
runs, so the calls are the traced window's; None where the port recorded none.
Moves ``robot_updates_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):   # a port without the registry
        return None
    s = profiling.spans().get("graphed.load")
    return 1e6 * s["total_s"] / s["count"] if s and s["count"] else None
