"""Seconds of set-up in the CUDA graphs' captures, each graph's first eager run
on a side stream and its capture (span ``graphed.capture`` of the port's
registry, utils/profiling.py), less the kernel library's load that the first
capture holds (``kernel.load``). Both record always, once a process; None where
the port recorded no capture. Moves ``setup_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):   # a port without the registry
        return None
    spans = profiling.spans()
    capture = spans.get("graphed.capture")
    if not capture:
        return None
    load = spans.get("kernel.load")
    return capture["total_s"] - (load["total_s"] if load else 0.0)
