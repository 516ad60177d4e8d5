"""Sample-sharded MPPI over a ``torch.distributed`` group (port of
``parallel/sharded.py``).

``mppi_step`` threads ``group`` through its reductions (ops/softmax_update.py);
here each rank runs it on K/N samples. Each shard draws its own samples,
on either path samples first_sample ... first_sample + K/N - 1 of the
unsharded Philox stream (counter word 0; the eager path through
ops/sampling.py draw_standard_normals), so a run on N shards uses the
unsharded step's samples; the softmax update is exact through an all-reduce
MIN and SUMs. Every output is replicated, so the controller state stays
identical on every rank, and a sharded step equals the unsharded one, in
its RNG mode or fed the whole noise tensor, up to the order of the final
sums.

Over NCCL the step and the loop are compiled, the counterparts of the JAX
package's ``jax.jit(shard_map(...))``: on the card a step is one CUDA graph's
replay with the collectives inside (solver/mppi.py ``compile_step``), and a
closed-loop cycle is one graph replayed a cycle (runtime/loop.py
``simulate``). Over gloo, which the caller picks explicitly (several ranks
on one card, or the CPU), they run op by op: gloo's collectives copy through
the host, which a graph cannot hold. The returned function says which form
it is (``compiled``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch.distributed as dist

from ccv_mppi_path_tracker_tpu_torch.core.config import SolverConfig
from ccv_mppi_path_tracker_tpu_torch.runtime.loop import simulate
from ccv_mppi_path_tracker_tpu_torch.runtime.plant import Plant
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import compile_step, mppi_step
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import collectives_capturable


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

    Over NCCL the step is ``compile_step``'s (``step.compiled`` True, the
    CompiledStep in ``step.compiled_step``): on the card each call replays
    one CUDA graph, the collectives inside it and this rank's slice of
    ``noise`` one of its inputs. Over gloo each call is ``mppi_step`` op by
    op (``step.compiled`` False, ``step.compiled_step`` None).
    """
    group, k_local, first = _shard(cfg, group)
    opts = dict(solver_options or {}, group=group, num_samples=k_local,
                first_sample=first, use_kernel=use_kernel)
    compiled = collectives_capturable(group)
    run = (compile_step(cfg, **opts) if compiled
           else functools.partial(mppi_step, cfg, **opts))

    def step(ctrl, state, path, dt, sp, cp, model_params=None, noise=None):
        if noise is not None:
            noise = noise[:, first:first + k_local]
        return run(ctrl, state, path, dt, sp, cp, model_params=model_params, noise=noise)

    step.compiled = compiled
    step.compiled_step = run if compiled else None
    return step


def build_sharded_simulate(cfg: SolverConfig, group=None, num_steps: int = 100,
                           plant: Optional[Plant] = None, use_kernel: bool = False):
    """The closed loop (runtime/loop.py simulate) with the controller
    sample-sharded over ``group``. The plant runs replicated: each rank
    steps the same robot with the same process noise (drawn from the key),
    so every rank holds the same state. Returns ``sim(ctrl, state0, path, dt, sp,
    cp, model_params=None) -> (ctrl, logs)`` as ``simulate`` does. Over NCCL
    (``sim.compiled`` True) the cycle is one CUDA graph on the card, the
    collectives inside it, replayed ``num_steps`` times with its carry in
    the graph's buffers (the counterpart of ``jax.jit`` of the JAX package's
    ``shard_map`` of ``lax.scan``); over gloo it runs op by op."""
    group, k_local, first = _shard(cfg, group)
    opts = dict(group=group, num_samples=k_local, first_sample=first)

    def sim(ctrl, state0, path, dt, sp, cp, model_params=None):
        return simulate(cfg, ctrl, state0, path, dt, sp, cp, model_params=model_params,
                        plant=plant, num_steps=num_steps, use_kernel=use_kernel,
                        solver_options=opts)

    sim.compiled = collectives_capturable(group)
    return sim
