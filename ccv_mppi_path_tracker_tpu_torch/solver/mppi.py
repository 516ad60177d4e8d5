"""The MPPI control step (port of ``solver/mppi.py``).

One function runs the reference's per-cycle sampling -> predict_States ->
calc_Weights -> determine_OptimalSolution (src/diff_drive_mppi.cpp:332-369):

    sample K Gaussian sequences around the warm start   (ops/sampling.py)
    prefix-sum rollout of all K trajectories            (ops/rollout.py)
    [full body] vectorized ZMP chain                    (models/full_body.py)
    per-trajectory cost                                 (ops/costs.py)
    min-baseline softmax weights and weighted update    (ops/softmax_update.py)

or, with ``use_kernel=True``, all of it in the fused kernel
(kernels/rollout_cost.py); ``refine_steps`` then polishes the update through
the rollout (diff/gradients.py). Everything stays on the device of ``state``; the
step reads nothing back to the host (the cycle's seed and counter are host
integers in ControllerState). With ``group`` the same function is one shard of
a sample-sharded update (parallel/sharded.py): the reductions become
collectives over the shards.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.core.random import cycle_generator
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, StepResult
from ccv_mppi_path_tracker_tpu_torch.diff.gradients import gauss_newton_refine, gradient_refine
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost,
    pack_scalars,
    should_use_kernel,
)
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import (
    CLOSED_FORM_MODELS,
    rollout,
    rollout_closed_form,
)
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import STEER_DIM, sample_controls
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import (
    all_reduce,
    elite_threshold,
    softmax_weights,
    weighted_update,
)
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import capturable, graphed_call


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
    elite_frac: Optional[float] = None,
    elite_stale_thresh=None,
    adapt_sigma: bool = False,
    refine_steps: int = 0,
    refine_step_size: float = 0.02,
    refine_method: str = "gradient",
    lean: bool = False,
    debug_candidates: int = 0,
    group=None,
    num_samples: Optional[int] = None,
    first_sample: int = 0,
):
    """Run one MPPI control cycle. Returns (next ControllerState, StepResult).

    state: (S,) measured state. dt: control period (tensor or number).
    noise: optional injected standard normals (T-1, K, U) for parity tests;
        otherwise the eager path draws from a generator seeded by
        (ctrl.seed, ctrl.step) and the kernel from its Philox stream keyed
        by the same pair.
    use_kernel: run sample + rollout + cost + update in the fused kernel
        (float32 only, any K, the four built-in models).
    shift_warm_start: center sampling on the one-step-shifted previous
        optimum (last control repeated); the reference does not shift.
    delay: actuation-latency compensation in seconds: Euler-predict the
        state under the command in flight (ctrl.u_prev[0]) before solving.
    elite_frac: keep softmax weight only on the best ``elite_frac`` of the
        samples by cost rank (1.0 is vanilla MPPI). The kernel path runs it
        in two passes: a costs-only pass, the threshold, then a costs-in
        pass that regenerates the same samples and accumulates the masked
        update.
    elite_stale_thresh: the single-pass elite mode: a 0-d tensor threshold
        (normally the previous cycle's stats["elite_thresh"]; +inf for the
        first cycle) at which this cycle's weights are masked. Requires
        elite_frac, whose threshold of the current costs is reported for the
        next cycle. A cycle in which it masks every sample holds the
        sampling mean and sets stats["elite_stale_empty"].
    adapt_sigma: also compute stats["sigma_suggest"] (U,), the per-channel
        std of the weighted sample distribution around the update, averaged
        over the horizon (covariance-adaptive importance sampling; fed back
        into SolverParams.control_noise by runtime/loop.py ControlLoop). The
        kernel path takes the weighted sums of u^2 from the kernel's second
        moment. An empty stale-elite cycle suggests sp.control_noise.
    refine_steps: gradient-smoothed MPPI: polish the sampled update (from
        either path) with this many steps through the rollout
        (diff/gradients.py) before actuation; 0 is classic MPPI.
        refine_method "gradient" takes projected gradient steps of
        ``refine_step_size``; "gauss_newton" takes Levenberg-Marquardt
        guarded Gauss-Newton steps on the least-squares cost.
    lean: return only u_opt/u0 (ref/opt_states None; stats empty except
        elite_thresh and sigma_suggest, which a caller feeds back).
    debug_candidates: also return the xy paths of the first M sampled
        rollouts in stats["candidates"] (M, T, 2), the reference's candidate
        path display (src/diff_drive_mppi.cpp:265-294); the eager path only
        (the kernel keeps no rollout), and not with ``lean``.
    group: a ``torch.distributed`` process group over the sample shards
        (parallel/sharded.py). This call is one shard: it runs
        ``num_samples`` samples (the shard's K/N; default cfg.num_samples)
        starting at sample index ``first_sample``, and every reduction is a
        collective, so u_opt and the stats are those of all K samples and
        equal on every rank. The kernel draws samples first_sample ...
        first_sample + K/N - 1 of the unsharded Philox stream; the eager
        path draws from the generator of (seed, step, shard = this rank).
        ``noise`` is then this shard's (T-1, K/N, U).
    """
    if elite_stale_thresh is not None and elite_frac is None:
        raise ValueError("elite_stale_thresh requires elite_frac (for the next threshold)")
    if lean and debug_candidates:
        raise ValueError("lean drops the debug outputs: no debug_candidates with lean")
    k = cfg.num_samples if num_samples is None else num_samples
    model = get_model(cfg.model)
    if model_params is None and model.default_params is not None:
        model_params = model.default_params(device=state.device, dtype=state.dtype)
    if delay is not None:
        state = model.step(state, ctrl.u_prev[0], delay)
    u_mean = ctrl.u_prev
    if shift_warm_start:
        u_mean = torch.cat([ctrl.u_prev[1:], ctrl.u_prev[-1:]], dim=0)

    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)

    if use_kernel:
        two_pass = elite_frac is not None and elite_stale_thresh is None
        kargs = (u_mean, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state)
        kw = dict(seed=ctrl.seed, step=ctrl.step, num_samples=k, model=cfg.model,
                  steer_off=cfg.steer_off, noise=noise, second_moment=adapt_sigma,
                  first_sample=first_sample)
        scal = pack_scalars(dt, cp, ref.yaw[0], model_params, sp.noise_beta, sp.lam,
                            cost_thresh=elite_stale_thresh)
        costs, u_num, norm, *u2_num = fused_sample_rollout_cost(
            *kargs, scal, accumulate=not two_pass, **kw)
        if lean:
            stats = {}
            if elite_frac is not None:
                stats["elite_thresh"] = elite_threshold(costs, elite_frac, group)
        else:
            stats = softmax_weights(costs, sp.lam, elite_frac=elite_frac,
                                    elite_thresh=elite_stale_thresh, group=group)[1]
        if two_pass:
            scal = pack_scalars(dt, cp, ref.yaw[0], model_params, sp.noise_beta,
                                sp.lam, cost_thresh=stats["elite_thresh"])
            _, u_num, norm, *u2_num = fused_sample_rollout_cost(
                *kargs, scal, costs_in=costs, **kw)
        if group is not None:
            u_num, norm, u2_num = _sum_shards(costs, stats.get("min_cost"), sp.lam,
                                              u_num, norm, u2_num, group)
        safe_norm = norm
        if elite_stale_thresh is not None:
            empty = norm <= 0.0
            stats["elite_stale_empty"] = empty
            safe_norm = torch.where(empty, 1.0, norm)
            u_opt = torch.where(empty, u_mean, u_num / safe_norm)
        else:
            u_opt = u_num / norm
        if adapt_sigma:
            stats["sigma_suggest"] = _sigma_suggest(u2_num[0] / safe_norm, u_opt)
    else:
        generator = None
        if noise is None:
            shard = 0 if group is None else dist.get_rank(group)
            generator = cycle_generator(ctrl.seed, ctrl.step, state.device, shard=shard)
        u_samples = sample_controls(
            u_mean, sp, k, steer_off=cfg.steer_off, noise=noise, generator=generator,
        )
        state0 = state.expand(k, -1)
        if cfg.model in CLOSED_FORM_MODELS:
            states = rollout_closed_form(cfg.model, state0, u_samples, dt)
        else:
            states = rollout(model.step, state0, u_samples, dt)
        aux = {}
        if model.aux_from_rollout is not None:
            aux = model.aux_from_rollout(states, u_samples, dt, model_params)
        costs = trajectory_costs(cfg.model, states, u_samples, aux, ref, cp)
        weights, stats = softmax_weights(costs, sp.lam, elite_frac=elite_frac,
                                         elite_thresh=elite_stale_thresh, group=group)
        if debug_candidates:
            stats["candidates"] = states[:, :debug_candidates, :2].transpose(0, 1)
        u_opt = weighted_update(weights, u_samples, group)
        if elite_stale_thresh is not None:
            u_opt = torch.where(stats["elite_stale_empty"], u_mean, u_opt)
        if adapt_sigma:
            stats["sigma_suggest"] = _sigma_suggest(
                weighted_update(weights, u_samples * u_samples, group), u_opt)
    if adapt_sigma and elite_stale_thresh is not None:
        # an empty stale cycle carries no information: suggest the
        # configured sigma, not a value that would poison the feedback
        stats["sigma_suggest"] = torch.where(stats["elite_stale_empty"],
                                             sp.control_noise, stats["sigma_suggest"])
    if refine_steps:
        u_opt = _refine(cfg, u_opt, state, ref, dt, sp, cp, model_params, refine_steps,
                        refine_step_size, refine_method)

    next_ctrl = ControllerState(u_prev=u_opt, seed=ctrl.seed, step=ctrl.step + 1)
    if lean:
        # only what a caller feeds back survives
        keep = {k: stats[k] for k in ("sigma_suggest", "elite_thresh") if k in stats}
        return next_ctrl, StepResult(u_opt=u_opt, u0=u_opt[0], ref=None,
                                     opt_states=None, stats=keep)
    opt_states = _opt_rollout(cfg.model, model, state, u_opt, dt)
    return next_ctrl, StepResult(
        u_opt=u_opt, u0=u_opt[0], ref=ref, opt_states=opt_states, stats=stats
    )


def _sum_shards(costs, global_min, lam, u_num, norm, u2_num, group):
    """The kernel's update of one shard, finished under the shard's own
    minimum cost, rescaled to the global minimum by exp(-(min - global
    min)/lambda) and summed over the shards in one all-reduce (the JAX
    package's psums, solver/mppi.py:213-218). ``global_min`` None: found
    here by an all-reduce MIN. Returns (u_num, norm, [u2_num] or [])."""
    local_min = torch.amin(costs)
    if global_min is None:
        global_min = all_reduce(local_min, dist.ReduceOp.MIN, group)
    rescale = torch.exp(-(local_min - global_min) / lam)
    parts = [u_num, norm.reshape(1)] + list(u2_num)
    flat = all_reduce(torch.cat([p.reshape(-1) for p in parts]) * rescale,
                      dist.ReduceOp.SUM, group)
    nu = u_num.numel()
    u2 = [flat[nu + 1:].reshape(u_num.shape)] if u2_num else []
    return flat[:nu].reshape(u_num.shape), flat[nu], u2


def _sigma_suggest(m2, u_opt):
    """Per-channel std of the weighted sample distribution, averaged over t:
    sqrt(mean_t max(E_w[u^2] - u_opt^2, 0))."""
    var = torch.clamp(m2 - u_opt * u_opt, min=0.0)
    return torch.sqrt(torch.mean(var, dim=0))


def _refine(cfg, u_opt, state, ref, dt, sp, cp, model_params, steps, step_size, method):
    """The refine stage of ``mppi_step`` (diff/gradients.py). On the card,
    for a built-in model, it runs as a CUDA graph captured on its first
    call for these shapes and options (utils/cuda_graph.py): eagerly it is
    about 1700 small launches (Gauss-Newton, full_body), which the host
    takes far longer to issue than the card to run."""
    args = (u_opt, state, ref, dt, sp, cp, model_params)
    stage = functools.partial(refine_stage, cfg, steps=steps, step_size=step_size,
                              method=method)
    if cfg.model in CLOSED_FORM_MODELS and capturable(args):
        return graphed_call(("refine", cfg, steps, step_size, method), stage, args)
    return stage(*args)


def refine_stage(cfg, u_opt, state, ref, dt, sp, cp, model_params, steps, step_size, method):
    """The refine stage, eagerly: ``steps`` refinement steps of ``method``,
    the steer channel held at zero under ``cfg.steer_off``."""
    if method == "gauss_newton":
        u_opt = gauss_newton_refine(cfg, u_opt, state, ref, dt, sp, cp,
                                    model_params=model_params, num_steps=steps)
    elif method == "gradient":
        u_opt = gradient_refine(cfg, u_opt, state, ref, dt, sp, cp, model_params=model_params,
                                step_size=step_size, num_steps=steps)
    else:
        raise ValueError(f"refine_method must be 'gradient' or 'gauss_newton', "
                         f"got {method!r}")
    if cfg.steer_off and u_opt.shape[1] > STEER_DIM:
        # the gradient has no reason to keep the disabled channel at zero
        u_opt = u_opt.clone()
        u_opt[:, STEER_DIM] = 0.0
    return u_opt


def _opt_rollout(model_name, model, state, u_opt, dt):
    """Planned-path re-roll of the optimal sequence (the reference's
    publish_OptimalPath, src/diff_drive_mppi.cpp:295-312), in the closed
    form where the model has one."""
    if model_name in CLOSED_FORM_MODELS:
        return rollout_closed_form(model_name, state, u_opt, dt)
    return rollout(model.step, state, u_opt, dt)


class MPPISolver:
    """One configuration's control step: construct with a config, call
    :meth:`step` each control cycle with the measured state."""

    def __init__(self, cfg: SolverConfig, use_kernel=False, device=None):
        """use_kernel: False (the eager path), True (the fused kernel) or
        "auto", resolved here by :func:`kernels.rollout_cost.should_use_kernel`
        for ``device`` (None: the card): the kernel iff the device is CUDA
        and the model is a built-in one."""
        if use_kernel == "auto":
            use_kernel = should_use_kernel(cfg.model, resolve_device(device))
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.model = get_model(cfg.model)

    def init(self, seed: int = 0, dtype=torch.float32, device=None) -> ControllerState:
        """A zero warm start on ``device`` (None: the card)."""
        return ControllerState.initial(
            seed, self.cfg.horizon, self.model.num_controls, dtype=dtype, device=device
        )

    def step(self, ctrl, state, path, dt, sp, cp, model_params=None):
        return mppi_step(
            self.cfg, ctrl, state, path, dt, sp, cp, model_params=model_params,
            use_kernel=self.use_kernel,
        )
