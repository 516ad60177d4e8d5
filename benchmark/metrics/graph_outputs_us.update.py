"""Microseconds a compiled update spends in the output copies: a clone of each
of the graph's outputs and the result rebuilt around them (``_Graph.__call__``):
span ``graphed.outputs`` of the port's registry (utils/profiling.py), mean a
call. The spans record only while the profiler runs, so the calls are the traced
window's; None where the port recorded none. Moves ``propagations_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):   # a port without the registry
        return None
    s = profiling.spans().get("graphed.outputs")
    return 1e6 * s["total_s"] / s["count"] if s and s["count"] else None
