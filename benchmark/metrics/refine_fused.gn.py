"""Share of the Gauss-Newton steps that the refine stage's fused kernel took,
in %: the device counter ``refine.fused_steps`` over ``refine.lm_steps`` of
the port's registry (utils/profiling.py). The kernel adds to both; the
op-by-op stage adds to ``refine.lm_steps`` only. Like ``refine_accepted.gn``
it counts every refined update of the run. None where the port has no
``refine.fused_steps`` counter (a port without the kernel) or counted no step.
Moves ``propagations_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    steps = counters.get("refine.lm_steps", 0)
    if "refine.fused_steps" not in counters or not steps:
        return None
    return 100.0 * counters["refine.fused_steps"] / steps
