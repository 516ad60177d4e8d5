"""The MPPI control step (port of ``solver/mppi.py``, full-body model).

One function runs the reference's per-cycle sampling -> predict_States ->
calc_Weights -> determine_OptimalSolution (src/diff_drive_mppi.cpp:332-369):

    sample K Gaussian sequences around the warm start   (ops/sampling.py)
    prefix-sum rollout of all K trajectories            (ops/rollout.py)
    vectorized ZMP chain                                (models/full_body.py)
    per-trajectory cost                                 (ops/costs.py)
    min-baseline softmax weights and weighted update    (ops/softmax_update.py)

or, with ``use_kernel=True``, all of it in the fused kernel
(kernels/rollout_cost.py). Everything stays on the device of ``state``; the
step reads nothing back to the host (the cycle's seed and counter are host
integers in ControllerState).
"""

from __future__ import annotations

from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.random import cycle_generator
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, StepResult
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost,
    pack_scalars,
)
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import rollout_closed_form
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import sample_controls
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import (
    softmax_weights,
    weighted_update,
)
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer, resample_reference


def mppi_step(
    cfg: SolverConfig,
    ctrl: ControllerState,
    state: torch.Tensor,
    path: PathBuffer,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    noise: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
    shift_warm_start: bool = False,
    delay: Optional[float] = None,
    lean: bool = False,
):
    """Run one MPPI control cycle. Returns (next ControllerState, StepResult).

    state: (S,) measured state. dt: control period (tensor or number).
    noise: optional injected standard normals (T-1, K, U) for parity tests;
        otherwise the eager path draws from a generator seeded by
        (ctrl.seed, ctrl.step) and the kernel from its Philox stream keyed
        by the same pair.
    use_kernel: run sample + rollout + cost + update in the fused kernel
        (float32 only, any K).
    shift_warm_start: center sampling on the one-step-shifted previous
        optimum (last control repeated); the reference does not shift.
    delay: actuation-latency compensation in seconds: Euler-predict the
        state under the command in flight (ctrl.u_prev[0]) before solving.
    lean: return only u_opt/u0 (ref/opt_states None, stats empty).
    """
    model = get_model(cfg.model)
    if model_params is None:
        model_params = model.default_params(device=state.device, dtype=state.dtype)
    if delay is not None:
        state = model.step(state, ctrl.u_prev[0], delay)
    u_mean = ctrl.u_prev
    if shift_warm_start:
        u_mean = torch.cat([ctrl.u_prev[1:], ctrl.u_prev[-1:]], dim=0)

    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)

    if use_kernel:
        scal = pack_scalars(dt, cp, ref.yaw[0], model_params, sp.noise_beta, sp.lam)
        costs, u_num, norm = fused_sample_rollout_cost(
            u_mean, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state, scal,
            seed=ctrl.seed, step=ctrl.step, num_samples=cfg.num_samples,
            steer_off=cfg.steer_off, noise=noise,
        )
        u_opt = u_num / norm
        stats = {} if lean else softmax_weights(costs, sp.lam)[1]
    else:
        generator = None
        if noise is None:
            generator = cycle_generator(ctrl.seed, ctrl.step, state.device)
        u_samples = sample_controls(
            u_mean, sp, cfg.num_samples, steer_off=cfg.steer_off, noise=noise,
            generator=generator,
        )
        state0 = state.expand(cfg.num_samples, -1)
        states = rollout_closed_form(cfg.model, state0, u_samples, dt)
        aux = model.aux_from_rollout(states, u_samples, dt, model_params)
        costs = trajectory_costs(cfg.model, states, u_samples, aux, ref, cp)
        weights, stats = softmax_weights(costs, sp.lam)
        u_opt = weighted_update(weights, u_samples)

    next_ctrl = ControllerState(u_prev=u_opt, seed=ctrl.seed, step=ctrl.step + 1)
    if lean:
        return next_ctrl, StepResult(u_opt=u_opt, u0=u_opt[0], ref=None,
                                     opt_states=None, stats={})
    # planned-path re-roll of the optimal sequence (the reference's
    # publish_OptimalPath, src/diff_drive_mppi.cpp:295-312)
    opt_states = rollout_closed_form(cfg.model, state, u_opt, dt)
    return next_ctrl, StepResult(
        u_opt=u_opt, u0=u_opt[0], ref=ref, opt_states=opt_states, stats=stats
    )


class MPPISolver:
    """One configuration's control step: construct with a config, call
    :meth:`step` each control cycle with the measured state."""

    def __init__(self, cfg: SolverConfig, use_kernel: bool = False):
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.model = get_model(cfg.model)

    def init(self, seed: int = 0, dtype=torch.float32, device=None) -> ControllerState:
        return ControllerState.initial(
            seed, self.cfg.horizon, self.model.num_controls, dtype=dtype, device=device
        )

    def step(self, ctrl, state, path, dt, sp, cp, model_params=None):
        return mppi_step(
            self.cfg, ctrl, state, path, dt, sp, cp, model_params=model_params,
            use_kernel=self.use_kernel,
        )
