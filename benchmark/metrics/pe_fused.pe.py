"""Share of the ensemble's member evaluations that the fused PETS rollout
kernel ran, in %: the device counter ``model.pe_fused`` over
``model.pe_evals`` of the port's registry (utils/profiling.py). The kernel
adds to both; the op-by-op particle rollout adds to ``model.pe_evals`` only.
Like ``pe_evals.pe`` it counts every update of the run, the capture's and
the warm-up's too. None where the port has no ``model.pe_fused`` counter (a
port without the kernel) or counted no evaluation. Moves
``propagations_per_s``."""


def read(obs):
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    evals = counters.get("model.pe_evals", 0)
    if "model.pe_fused" not in counters or not evals:
        return None
    return 100.0 * counters["model.pe_fused"] / evals
