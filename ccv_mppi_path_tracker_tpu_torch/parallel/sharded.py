"""Sample-sharded MPPI over a ``torch.distributed`` group (port of
``parallel/sharded.py``).

``mppi_step`` threads ``group`` through its reductions (ops/softmax_update.py);
here each rank runs it on K/N samples. Each shard draws its own samples: the
kernel samples first_sample ... first_sample + K/N - 1 of the unsharded
Philox stream (counter word 0), the eager path the generator of its rank;
the softmax update is exact through an all-reduce MIN and SUMs. Every output
is replicated, so the controller state stays identical on every rank, and a
run fed the whole noise tensor equals the unsharded step up to the order of
the final sums.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ccv_mppi_path_tracker_tpu_torch.core.config import SolverConfig
from ccv_mppi_path_tracker_tpu_torch.runtime.loop import simulate
from ccv_mppi_path_tracker_tpu_torch.runtime.plant import Plant
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import mppi_step


def _shard(cfg: SolverConfig, group):
    """(group, K/N, first sample of this rank) of the group's shards; group
    None is the default group."""
    if group is None:
        group = dist.group.WORLD
    n = dist.get_world_size(group)
    if cfg.num_samples % n != 0:
        raise ValueError(f"num_samples={cfg.num_samples} not divisible by the group's "
                         f"size {n}")
    k_local = cfg.num_samples // n
    return group, k_local, dist.get_rank(group) * k_local


def build_sharded_step(cfg: SolverConfig, group=None, use_kernel: bool = False,
                       solver_options: Optional[dict] = None):
    """The sample-sharded control step of this rank over ``group`` (None:
    the default group).

    Returns ``step(ctrl, state, path, dt, sp, cp, model_params=None,
    noise=None)``. ``noise``, when given for parity tests, is the full
    (T-1, K, U) tensor; each rank takes its slice of the sample axis. Every
    input is the same on every rank and so is every output. ``use_kernel``
    runs each shard through the fused kernel (any K/N).
    ``solver_options`` forwards extra mppi_step keywords (shift_warm_start,
    delay, adapt_sigma, elite_frac, ...); elite_frac ranks the costs of all
    shards (ops/softmax_update.py elite_threshold), so the threshold equals
    the unsharded one. The step reads nothing back to the host.
    """
    group, k_local, first = _shard(cfg, group)
    opts = dict(solver_options or {}, group=group, num_samples=k_local,
                first_sample=first, use_kernel=use_kernel)

    def step(ctrl, state, path, dt, sp, cp, model_params=None, noise=None):
        if noise is not None:
            noise = noise[:, first:first + k_local]
        return mppi_step(cfg, ctrl, state, path, dt, sp, cp, model_params=model_params,
                         noise=noise, **opts)

    return step


def build_sharded_simulate(cfg: SolverConfig, group=None, num_steps: int = 100,
                           plant: Optional[Plant] = None, use_kernel: bool = False):
    """The closed loop (runtime/loop.py simulate) with the controller
    sample-sharded over ``group``. The plant runs replicated: each rank
    steps the same robot with the same process-noise generator, so every
    rank holds the same state. Returns ``sim(ctrl, state0, path, dt, sp,
    cp, model_params=None) -> (ctrl, logs)`` as ``simulate`` does."""
    group, k_local, first = _shard(cfg, group)
    opts = dict(group=group, num_samples=k_local, first_sample=first)

    def sim(ctrl, state0, path, dt, sp, cp, model_params=None):
        return simulate(cfg, ctrl, state0, path, dt, sp, cp, model_params=model_params,
                        plant=plant, num_steps=num_steps, use_kernel=use_kernel,
                        solver_options=opts)

    return sim
