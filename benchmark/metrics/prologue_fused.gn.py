"""Share of the kernel-path control updates whose prologue (the reference
window, the scalars, the fused kernel's centred operands, tickets and next
key) was the one-launch kernel, in %: the device counter
``step.prologue_fused`` over ``step.kernel_updates`` of the port's registry
(utils/profiling.py). The kernel adds to both; the op-by-op prologue adds to
``step.kernel_updates`` only. It counts every update of the run, set-up
included. None where the port has no ``step.prologue_fused`` counter (a port
without the kernel) or counted no update. Moves ``propagations_per_s`` in
``full_body_gn.update``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    updates = counters.get("step.kernel_updates", 0)
    if "step.prologue_fused" not in counters or not updates:
        return None
    return 100.0 * counters["step.prologue_fused"] / updates
