"""Microseconds a compiled fleet tick spends in the replay: the process-group
check, ``CUDAGraph.replay`` and the launch counters (``_Graph.replay``): span
``graphed.replay`` of the port's registry (utils/profiling.py), mean a call. The
spans record only while the profiler runs, so the calls are the traced window's;
None where the port recorded none. Moves ``robot_updates_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):   # a port without the registry
        return None
    s = profiling.spans().get("graphed.replay")
    return 1e6 * s["total_s"] / s["count"] if s and s["count"] else None
