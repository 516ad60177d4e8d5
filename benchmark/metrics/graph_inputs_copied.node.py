"""Tensors a compiled node-sized update copies into its CUDA graph's input
buffers, mean a call: counter ``graphed.inputs_copied`` over the count of span
``graphed.load`` of the port's registry (utils/profiling.py); a tensor whose
buffer already holds it is not copied. The spans record only while the profiler
runs, so the calls are the traced window's; None where the port recorded none.
Moves ``propagations_per_s.node``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):   # a port without the registry
        return None
    load = profiling.spans().get("graphed.load")
    if not (load and load["count"]):
        return None
    return profiling.counters().get("graphed.inputs_copied", 0) / load["count"]
