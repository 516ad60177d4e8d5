"""Seconds of set-up in loading the fused kernel's library: nvcc's build where
none is cached, and its ``ctypes`` load (span ``kernel.load`` of the port's
registry, utils/profiling.py; kernels/build.py ``load_library``). It records
always, once a library and process; None where the port recorded none. Moves
``setup_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):   # a port without the registry
        return None
    load = profiling.spans().get("kernel.load")
    return load["total_s"] if load else None
