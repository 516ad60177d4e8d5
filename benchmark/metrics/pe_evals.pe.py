"""Member evaluations of the ensemble an update, one a particle and step:
the port's device counter ``model.pe_evals`` (utils/profiling.py) over the
updates the traffic kind ``chained_update`` ran, the first (the capture),
its ``warmup_units``, the timed window's (span ``call.update``) and its
``trace_units``. A CUDA graph of the update adds to the counter at every
replay. K·P·(T-1) in a lean update. None where the port has no such
counter. Moves ``propagations_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    evals = profiling.counters().get("model.pe_evals")
    window = obs["spans"].get("call.update")
    if not evals or window is None:
        return None
    tr = obs["traffic"]
    return evals / (1 + tr["warmup_units"] + len(window) + tr["trace_units"])
