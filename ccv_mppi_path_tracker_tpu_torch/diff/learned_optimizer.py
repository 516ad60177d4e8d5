"""Learned update rule for sampled MPC, "learning to optimize" (port of
``diff/learned_optimizer.py``).

PAPERS.md "Learning to Optimize in Model Predictive Control" (arxiv
2212.02603): keep MPPI's sampling and rollouts, and replace the hand-designed
softmax-weighted update (calc_Weights/determine_OptimalSolution,
src/diff_drive_mppi.cpp:212-246) by a learned weighting of the samples,
meta-trained through the differentiable rollouts on the realized trajectory
cost after a fixed number of solver iterations:

    z_k     = (cost_k - min cost) / lambda                (vanilla exponent)
    n_k     = (cost_k - min cost) / (mean - min + eps)    (scale-free feature)
    logit_k = -z_k + MLP([n_k, exp(-n_k)])
    w       = softmax(logit)
    u_opt   = clip(u_prev + gain * (sum_k w_k u_k - u_prev), bounds)

At identity initialization the MLP's output layer is zero and the gain 1,
so ``w`` is the MPPI softmax and the update is ``ops/softmax_update.py``'s.

:func:`meta_train` and :func:`evaluate_rule` vmap :func:`solved_cost` over
a batch of poses and their noise, drawn before the ``vmap`` (``vmap`` can
pass neither a ``torch.Generator`` draw nor a batched tensor to the draw
kernel's launch). Meta-training is one scan of :func:`_meta_step` (the rule's
parameters and the Adam state carried as plain tensors, diff/optim.py): on
the card one CUDA graph replayed a step, as the JAX package jits its step.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.types import (
    ControllerState,
    StepResult,
    advance_key,
    make_key,
)
from ccv_mppi_path_tracker_tpu_torch.diff.gradients import make_trajectory_cost
from ccv_mppi_path_tracker_tpu_torch.diff.learned_sampler import random_poses
from ccv_mppi_path_tracker_tpu_torch.diff.optim import Program, adam_init, adam_update
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import model_rollout
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import (
    STEER_DIM,
    draw_standard_normals,
    sample_controls,
)
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import weighted_update
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import Graphed


class UpdateRule(nn.Module):
    """Learned weighting and step parameters; identity init is vanilla MPPI.

    w1 (F, H), b1 (H,): per-sample feature MLP; w2 (H, 1), b2 (1,): its
    output layer, zero at init (logit correction 0); log_gain (U,): per-dim
    update relaxation, zero at init (gain 1).
    """

    NUM_FEATURES = 2

    def __init__(self, w1, b1, w2, b2, log_gain):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)
        self.log_gain = nn.Parameter(log_gain)

    @classmethod
    def init_identity(cls, u_dim: int, generator: torch.Generator, hidden: int = 16,
                      dtype=torch.float32):
        """Parameters that reproduce the classic MPPI update exactly, w1
        He-initialized from ``generator`` on its device."""
        f = cls.NUM_FEATURES
        kw = dict(dtype=dtype, device=generator.device)
        return cls(
            w1=torch.randn((f, hidden), generator=generator, **kw) * math.sqrt(2.0 / f),
            b1=torch.zeros(hidden, **kw),
            w2=torch.zeros((hidden, 1), **kw),
            b2=torch.zeros(1, **kw),
            log_gain=torch.zeros(u_dim, **kw),
        )

    def logit_correction(self, n):
        """Pointwise MLP over the scale-free cost feature n (K,) -> (K,)."""
        feats = torch.stack([n, torch.exp(-n)], dim=-1)  # (K, F)
        h = torch.tanh(feats @ self.w1 + self.b1)
        return (h @ self.w2 + self.b2)[..., 0]

    def tensors(self) -> tuple:
        """The parameters as plain tensors, in :class:`RuleTensors`' order."""
        return tuple(p.detach() for p in self.parameters())


class RuleTensors(NamedTuple):
    """An :class:`UpdateRule`'s parameters as plain tensors, the form that
    meta-training carries and differentiates with ``torch.func``."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    log_gain: torch.Tensor

    logit_correction = UpdateRule.logit_correction


def learned_weights(rule: UpdateRule, costs, lam, eps: float = 1e-6):
    """Per-sample weights of the learned rule; softmax(-z) at identity."""
    centered = costs - torch.amin(costs)
    n = centered / (torch.mean(centered) + eps)
    return torch.softmax(-centered / lam + rule.logit_correction(n), dim=-1)


def learned_update_step(
    cfg: SolverConfig,
    rule: UpdateRule,
    ctrl: ControllerState,
    state,
    path: PathBuffer,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    noise: Optional[torch.Tensor] = None,
):
    """One control cycle with the learned update rule: ``mppi_step``'s eager
    path (sample, sequential rollout, cost) with the weighting and step size
    of ``rule``. Without ``noise`` the normals are the cycle's draw from its
    key (ops/sampling.py draw_standard_normals), as in ``mppi_step``. Returns (next
    ControllerState, StepResult); differentiable in ``rule``."""
    model = get_model(cfg.model)
    if model_params is None and model.default_params is not None:
        model_params = model.default_params(device=state.device, dtype=state.dtype)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    if noise is None:
        tm1, u_dim = ctrl.u_prev.shape
        noise = draw_standard_normals(**ctrl.rng(), shape=(tm1, cfg.num_samples, u_dim),
                                      dtype=state.dtype, device=state.device)
    u_samples = sample_controls(ctrl.u_prev, sp, cfg.num_samples, steer_off=cfg.steer_off,
                                noise=noise)
    states = model_rollout(model, state.expand(cfg.num_samples, -1), u_samples, dt,
                           model_params)
    aux = {}
    if model.aux_from_rollout is not None:
        aux = model.aux_from_rollout(states, u_samples, dt, model_params)
    costs = trajectory_costs(cfg.model, states, u_samples, aux, ref, cp)

    weights = learned_weights(rule, costs, sp.lam)
    u_bar = weighted_update(weights, u_samples)
    step = ctrl.u_prev + torch.exp(rule.log_gain) * (u_bar - ctrl.u_prev)
    # jnp.clip's derivative at the bounds (0.5), not torch.clamp's (1)
    u_opt = torch.minimum(torch.maximum(step, sp.u_min), sp.u_max)
    if cfg.steer_off:
        u_opt = u_opt.clone()
        u_opt[:, STEER_DIM] = 0.0
    stats = {"min_cost": torch.amin(costs), "mean_cost": torch.mean(costs),
             "ess": 1.0 / torch.sum(weights * weights)}
    next_ctrl = ctrl.advanced(u_opt)
    return next_ctrl, StepResult(u_opt=u_opt, u0=u_opt[0], ref=ref,
                                 opt_states=model_rollout(model, state, u_opt, dt,
                                                          model_params),
                                 stats=stats)


def _identity(cfg, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return UpdateRule.init_identity(get_model(cfg.model).num_controls, gen, dtype=dtype)


def solved_cost(cfg, rule, state, path, dt, sp, cp, seed: int = 0, iterations: int = 2,
                noise=None):
    """Realized trajectory cost of the update after ``iterations`` solver
    cycles at a frozen state from a zero (cold) start. ``rule`` is an
    :class:`UpdateRule` or :class:`RuleTensors`; None runs the vanilla update
    (the identity rule). Differentiable in ``rule``.

    noise: optional standard normals (iterations, T-1, K, U), one draw per
    cycle (the JAX function takes one (T-1, K, U) draw and repeats it every
    cycle: pass it stacked). Without it cycle i draws the Philox stream of
    (seed, i) (ops/sampling.py draw_standard_normals).
    """
    model = get_model(cfg.model)
    if rule is None:
        rule = _identity(cfg, state.device, state.dtype)
    ctrl = ControllerState(
        u_prev=torch.zeros((cfg.horizon - 1, model.num_controls), dtype=state.dtype,
                           device=state.device),
        seed=seed, step=0)
    for i in range(iterations):
        ctrl, _ = learned_update_step(cfg, rule, ctrl, state, path, dt, sp, cp,
                                      noise=None if noise is None else noise[i])
    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    return make_trajectory_cost(cfg)(ctrl.u_prev, state, ref, dt, cp)


def _batch_costs(cfg, rule, sp, cp, path, dt, states, noise, iterations):
    """solved_cost of every pose, vmapped over poses (B, S) and their noise
    (iterations, B, T-1, K, U)."""
    return torch.func.vmap(
        lambda s, nz: solved_cost(cfg, rule, s, path, dt, sp, cp, iterations=iterations,
                                  noise=nz),
        in_dims=(0, 1))(states, noise)


def _step_noise(cfg, key, iterations, num, dtype):
    """A meta-training step's noise, (iterations, B, T-1, K, U): the Philox
    stream of ``key`` [seed, step], robot word i * B + b for cycle i of pose
    b, in one draw (on the card one launch of the draw kernel)."""
    u_dim = get_model(cfg.model).num_controls
    noise = draw_standard_normals(key, None, None, (iterations * num, cfg.horizon - 1,
                                                    cfg.num_samples, u_dim), dtype=dtype)
    return noise.reshape(iterations, num, *noise.shape[1:])


def _meta_step(carry, cfg, sp, cp, path, dt, poses, iterations, learning_rate, noise=None):
    """One meta-training step, carry (rule parameters, Adam state, key [seed,
    i]): the mean realized cost over batch i of ``poses`` (num_steps, B, S),
    picked on the device by the key's step, with the noise of
    :func:`_step_noise` (or ``noise``), its gradient and the Adam update.
    Returns (the carry with the key advanced, the loss before the update)."""
    params, state, key = carry
    states = poses.index_select(0, key[1:])[0]
    if noise is None:
        noise = _step_noise(cfg, key, iterations, states.shape[0], states.dtype)
    grads, loss = torch.func.grad_and_value(lambda ps: _mean_cost(
        cfg, ps, sp, cp, path, dt, states, noise, iterations))(params)
    params, state = adam_update(params, grads, state, learning_rate)
    return (params, state, advance_key(key)), loss


def _mean_cost(cfg, params, sp, cp, path, dt, states, noise, iterations):
    """The mean realized cost of the rule of tensors ``params`` over the
    poses ``states`` and their noise: meta-training's loss and
    :func:`evaluate_rule`'s value."""
    return torch.mean(_batch_costs(cfg, RuleTensors(*params), sp, cp, path, dt, states,
                                   noise, iterations))


# The compiled programs: on the card one CUDA graph per configuration and
# shape set a process runs (least recently used dropped first).
META_TRAIN = Graphed(_meta_step, max_graphs=8)
EVALUATE = Graphed(_mean_cost, max_graphs=8)


def meta_train(
    cfg: SolverConfig,
    sp: SolverParams,
    cp: CostParams,
    course,
    generator: torch.Generator,
    num_steps: int = 120,
    batch: int = 32,
    iterations: int = 2,
    dt: float = 0.1,
    hidden: int = 16,
    learning_rate: float = 3e-3,
    lateral_spread: float = 0.5,
    yaw_spread: float = 0.5,
):
    """Meta-train the update rule end to end through the rollouts.

    Loss: the mean realized cost over a fresh batch of randomized poses
    after ``iterations`` cold-start cycles. Gradients flow through the
    (reparameterized) sampling, the rollout, the cost and the softmax.

    ``generator`` (on any device) draws, in this order: the initial rule's
    w1, the poses of all ``num_steps`` batches (num_steps * batch poses, step
    i's batch the i-th run of ``batch``), and a seed. Step i's noise is the
    Philox stream of (seed, i) (:func:`_step_noise`), drawn inside the step.
    So the result is a function of ``generator``'s state: with a generator
    on the CPU, the same on the CPU and the card up to float rounding. The
    steps are one scan of :func:`_meta_step`: on the card one CUDA graph
    replayed ``num_steps`` times, with one launch of the draw kernel a step.
    Returns (rule, losses: a NumPy array, each step's loss before its
    update).
    """
    (params, _, _), losses = _meta_train_program(
        cfg, sp, cp, course, generator, num_steps, batch, iterations, dt, hidden,
        learning_rate, lateral_spread, yaw_spread)()
    return UpdateRule(*params), losses.cpu().numpy()


def _meta_train_program(cfg, sp, cp, course, generator, num_steps=120, batch=32,
                        iterations=2, dt=0.1, hidden=16, learning_rate=3e-3,
                        lateral_spread=0.5, yaw_spread=0.5) -> Program:
    """:func:`meta_train`'s scan, not yet run (its draws from ``generator``
    made)."""
    device, dtype = sp.lam.device, sp.lam.dtype
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device=device)
    dtt = torch.full((), dt, dtype=dtype, device=device)
    rule = UpdateRule.init_identity(get_model(cfg.model).num_controls, generator, hidden,
                                    dtype).to(device)
    poses = random_poses(cfg, course, generator, num_steps * batch, lateral_spread,
                         yaw_spread, dtype).to(device).reshape(num_steps, batch, -1)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                             device=generator.device))
    params = rule.tensors()
    carry = (params, adam_init(params), make_key(seed, 0, device))
    return Program(META_TRAIN, (carry, cfg, sp, cp, path, dtt, poses, iterations,
                                learning_rate), num_steps)


@torch.no_grad()
def evaluate_rule(cfg, rule, sp, cp, course, generator: torch.Generator,
                  num_states: int = 32, iterations: int = 2, dt: float = 0.1,
                  lateral_spread: float = 0.5, yaw_spread: float = 0.5):
    """Mean realized cost over held-out randomized poses drawn from
    ``generator`` (on any device), with their noise (rule=None: vanilla). On
    the card the costs are one CUDA graph's replay."""
    return float(_evaluate_rule_program(cfg, rule, sp, cp, course, generator, num_states,
                                        iterations, dt, lateral_spread, yaw_spread)())


def _evaluate_rule_program(cfg, rule, sp, cp, course, generator, num_states=32,
                           iterations=2, dt=0.1, lateral_spread=0.5,
                           yaw_spread=0.5) -> Program:
    """:func:`evaluate_rule`'s call, not yet run (its draws made)."""
    device, dtype = sp.lam.device, sp.lam.dtype
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device=device)
    dtt = torch.full((), dt, dtype=dtype, device=device)
    states = random_poses(cfg, course, generator, num_states, lateral_spread, yaw_spread,
                          dtype).to(device)
    shape = (iterations, num_states, cfg.horizon - 1, cfg.num_samples,
             get_model(cfg.model).num_controls)
    noise = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device).to(device)
    if rule is None:
        rule = _identity(cfg, device, dtype)
    return Program(EVALUATE, (cfg, rule.tensors(), sp, cp, path, dtt, states, noise,
                              iterations))
