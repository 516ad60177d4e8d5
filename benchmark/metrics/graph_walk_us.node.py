"""Microseconds a compiled node-sized update spends in the argument walk of its
CUDA graph: the cache key's walk over the arguments, the refusal check and the
cache lookup (utils/cuda_graph.py ``Graphed._find``): span ``graphed.walk`` of
the port's registry (utils/profiling.py), mean a call. The spans record only
while the profiler runs, so the calls are the traced window's; None where the
port recorded none. Moves ``propagations_per_s.node``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):   # a port without the registry
        return None
    s = profiling.spans().get("graphed.walk")
    return 1e6 * s["total_s"] / s["count"] if s and s["count"] else None
