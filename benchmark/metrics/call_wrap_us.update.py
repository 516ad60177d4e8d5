"""Microseconds a compiled update spends around its CUDA graph: the graph's
arguments built from the caller's (span ``compiled.wrap_in``: the options, the
bare ControllerState with its key, the path's count as a tensor, dt) and the
caller's seed and step put back on the returned state (``compiled.wrap_out``),
of the port's registry (utils/profiling.py), over the calls
(``compiled.wrap_out``'s count). The spans record only while the profiler runs,
so the calls are the traced window's; None where the port recorded none. Moves
``propagations_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):   # a port without the registry
        return None
    spans = profiling.spans()
    wrap_in, wrap_out = spans.get("compiled.wrap_in"), spans.get("compiled.wrap_out")
    if not (wrap_in and wrap_out and wrap_out["count"]):
        return None
    return 1e6 * (wrap_in["total_s"] + wrap_out["total_s"]) / wrap_out["count"]
