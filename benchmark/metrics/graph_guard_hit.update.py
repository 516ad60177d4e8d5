"""Share of the calls of a compiled update whose arguments the guard of the CUDA
graph used last accepted, in %: counter ``graphed.guard_hits`` over it and
``graphed.guard_misses`` of the port's registry (utils/profiling.py); a call
the guard refuses takes the full path (the argument walk, the refusal check and
the cache lookup, utils/cuda_graph.py ``Graphed._find``). The counters record
only while the profiler runs, so the calls are the traced window's; None where
the port recorded neither. Moves ``propagations_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):   # a port without the registry
        return None
    counters = profiling.counters()
    hits = counters.get("graphed.guard_hits", 0)
    calls = hits + counters.get("graphed.guard_misses", 0)
    return 100.0 * hits / calls if calls else None
