"""Share of the network's evaluations that the fused network-rollout kernel
ran, in %: the device counter ``model.nn_fused`` over ``model.nn_evals`` of
the port's registry (utils/profiling.py). The kernel adds to both; the
op-by-op rollout adds to ``model.nn_evals`` only. Like ``nn_evals.nn`` it
counts every update of the run, the capture's and the warm-up's too. None
where the port has no ``model.nn_fused`` counter (a port without the kernel)
or counted no evaluation. Moves ``propagations_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    evals = counters.get("model.nn_evals", 0)
    if "model.nn_fused" not in counters or not evals:
        return None
    return 100.0 * counters["model.nn_fused"] / evals
