"""Fleet-scale batched control: many independent robots in one program
(port of ``solver/batch.py``).

A fleet of B robots, each with its own pose, warm start, random stream and,
optionally, its own course, runs B complete MPPI updates per control tick.
With B=256, K=1024 that is a quarter-million trajectories per tick on one
card, the JAX package's production serving shape.

- Eager arm: ``torch.func.vmap`` of :func:`mppi_step`, as the JAX package
  vmaps it, so every op runs once for the whole fleet. The normals of every
  robot come from one draw before it (ops/sampling.py
  draw_standard_normals, (B, T-1, K, U); a launch of the draw's kernel
  cannot run inside ``vmap``): robot b's are the kernel's Philox stream at
  counter word 3 = b, robot 0's the single-robot stream.
- Kernel arm: one launch of the fused kernel for all B robots (grid B x K
  blocks; past 65535 robots, one launch a chunk of at most 65535 at its
  robot offset) between batched glue: the references (``resample_references``),
  the scalars (``pack_scalars``) and the per-robot finish, with no loop over
  robots. Robot b draws the same Philox stream as on the eager arm.

On the card either arm's tick is one CUDA graph's replay
(utils/cuda_graph.py), the counterpart of the JAX package's ``@jax.jit``
fleet step.

The fleet's ControllerState is the single robot's with a leading robot axis
on ``u_prev`` (B, T-1, U). Its seed and step stay host integers, and its key
their copy on the device, shared by the fleet: every robot steps together
(the JAX package carries a key and a step per robot).
"""

from __future__ import annotations

from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import SolverConfig
from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.core.types import (
    ControllerState,
    RefWindow,
    StepResult,
    make_key,
)
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost,
    should_use_kernel,
)
from ccv_mppi_path_tracker_tpu_torch.kernels.step_prologue import step_prologue
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import softmax_weights
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph, _opt_rollout, mppi_step
from ccv_mppi_path_tracker_tpu_torch.utils.profiling import tracing


def init_fleet(cfg: SolverConfig, num_robots: int, seed: int = 0,
               dtype=torch.float32, device=None) -> ControllerState:
    """Batched ControllerState: zero warm starts (B, T-1, U) and the key on
    ``device`` (None: the card); each robot's random stream derives from
    ``seed`` and its index."""
    model = get_model(cfg.model)
    device = resolve_device(device)
    return ControllerState(
        u_prev=torch.zeros((num_robots, cfg.horizon - 1, model.num_controls),
                           dtype=dtype, device=device),
        seed=int(seed),
        step=0,
        key=make_key(seed, 0, device),
    )


def build_fleet_step(cfg: SolverConfig, shared_path: bool = True,
                     use_kernel: bool = False):
    """The fleet control step.

    Returns ``step(ctrls, states, path, dt, sp, cp, model_params=None,
    noise=None) -> (next ctrls, StepResult)``. ctrls and states (B, S) carry
    the leading robot axis; ``path`` is one course for the whole fleet when
    ``shared_path``, else per-robot paths from ``PathBuffer.stack``. dt and
    the parameters are shared. noise: optional injected standard normals
    (B, T-1, K, U). The result has u_opt (B, T-1, U), u0 (B, U), ref (B, T,
    2) and (B, T), opt_states (B, T, S) and per-robot stats (B,).

    ``use_kernel`` runs the fleet through one fused-kernel launch (float32,
    the four built-in models), else through the vmapped eager arm;
    ``"auto"`` chooses by kernels/rollout_cost.py should_use_kernel. A model
    that samples its own transitions (``Model.stochastic``) raises
    ValueError: the fleet draws no propagation stream per robot. On the
    card either is the replay of the tick's CUDA graph (captured by the
    first tick of its shapes; dt, the parameters and the paths are its
    inputs, the key is read and advanced on the device, and the step's host
    integer is set on the result; ``step.graphed`` counts the captures); on
    the CPU, op by op.
    """
    if get_model(cfg.model).stochastic:
        raise ValueError(f"the fleet step has no per-robot stream for the transitions that "
                         f"{cfg.model} samples: run its robots one mppi_step each")
    tick = KeyedGraph(_tick)

    def step(ctrls: ControllerState, states, path: PathBuffer, dt, sp, cp,
             model_params=None, noise: Optional[torch.Tensor] = None):
        if (path.xy.dim() == 2) != shared_path:
            raise ValueError(f"shared_path={shared_path} needs a path xy of "
                             f"{'(N, 2)' if shared_path else '(B, N, 2)'}, got "
                             f"{tuple(path.xy.shape)}")
        return tick.call(ctrls, path, dt, (states, sp, cp, model_params, noise, cfg, use_kernel),
                         1, True, tracing())

    step.graphed = tick
    return step


def _tick(ctrls, path, dt, states, sp, cp, model_params, noise, cfg, use_kernel):
    """One fleet tick: the update of every robot, then its planned path
    (``use_kernel="auto"`` resolved for the device of ``states``, where the
    tick runs op by op or is captured)."""
    model = get_model(cfg.model)
    if use_kernel == "auto":
        use_kernel = should_use_kernel(cfg.model, states.device)
    update = _kernel_update if use_kernel else _eager_update
    u_opt, ref, stats, next_key = update(cfg, ctrls, states, path, dt, sp, cp, model_params,
                                         noise)
    opt_states = _opt_rollout(cfg.model, model, states, u_opt.transpose(0, 1),
                              dt, model_params).transpose(0, 1)
    return ctrls.advanced(u_opt, next_key=next_key), StepResult(
        u_opt=u_opt, u0=u_opt[:, 0], ref=ref, opt_states=opt_states, stats=stats)


def _eager_update(cfg, ctrls, states, path, dt, sp, cp, model_params, noise):
    """mppi_step per robot, vectorized over the fleet by torch.func.vmap,
    on the normals of one draw for the whole fleet. Returns (u_opt, ref,
    stats, None): the tick advances the key."""
    model = get_model(cfg.model)
    if model_params is None and model.default_params is not None:
        model_params = model.default_params(device=states.device, dtype=states.dtype)
    if noise is None:
        num_robots, tm1, u_dim = ctrls.u_prev.shape
        noise = draw_standard_normals(**ctrls.rng(), shape=(num_robots, tm1, cfg.num_samples,
                                                            u_dim),
                                      dtype=states.dtype, device=states.device)
    dims = None if path.xy.dim() == 2 else 0

    def one(u_prev, state, nz, xy, num_valid, resolution):
        _, res = mppi_step(cfg, ControllerState(u_prev, ctrls.seed, ctrls.step), state,
                           PathBuffer(xy, num_valid, resolution), dt, sp, cp,
                           model_params=model_params, noise=nz)
        return res.u_opt, res.ref.xy, res.ref.yaw, res.stats

    u_opt, ref_xy, ref_yaw, stats = torch.func.vmap(
        one, in_dims=(0, 0, 0, dims, dims, dims))(
        ctrls.u_prev, states, noise, path.xy, path.num_valid, path.resolution)
    return u_opt, RefWindow(xy=ref_xy, yaw=ref_yaw), stats, None


def _kernel_update(cfg, ctrls, states, path, dt, sp, cp, model_params, noise):
    """The kernel branch of mppi_step for B robots in one launch (a chunk
    of at most 65535 robots a launch: kernels/rollout_cost.py
    fleet_chunks), after the fleet's prologue (kernels/step_prologue.py: the
    windows, scalars, centred operands, tickets and next key of every robot,
    one launch on the card). Returns (u_opt, ref, stats, next key)."""
    pro = step_prologue(cfg, path, states, dt, sp, cp, model_params, key=ctrls.key)
    costs, u_num, norm = fused_sample_rollout_cost(
        ctrls.u_prev, sp.control_noise, sp.u_min, sp.u_max, pro.ref.xy, states, pro.scal,
        num_samples=cfg.num_samples, model=cfg.model, steer_off=cfg.steer_off,
        noise=noise, prepared=pro.launch, **ctrls.rng())
    stats = torch.func.vmap(lambda c: softmax_weights(c, sp.lam)[1])(costs)
    return u_num / norm[:, None, None], pro.ref, stats, pro.next_key
