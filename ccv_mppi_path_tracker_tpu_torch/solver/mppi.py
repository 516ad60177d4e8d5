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
integers in ControllerState, and its key their copy on the device). With
``group`` the same function is one shard of a sample-sharded update
(parallel/sharded.py): the reductions become collectives over the shards.

:func:`compile_step` is the counterpart of ``jax.jit`` of this function: on
the card it replays either path as a CUDA graph (utils/cuda_graph.py), the
sharded step's too where its group's collectives run over NCCL.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, StepResult
from ccv_mppi_path_tracker_tpu_torch.diff.gradients import gauss_newton_refine, gradient_refine
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    KERNEL_MODELS,
    fused_sample_rollout_cost,
    pack_scalars,
    should_use_kernel,
)
from ccv_mppi_path_tracker_tpu_torch.kernels.step_prologue import step_prologue
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import (
    CLOSED_FORM_MODELS,
    model_rollout,
    rollout_closed_form,
)
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import (
    STEER_DIM,
    draw_standard_normals,
    sample_controls,
)
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import (
    all_reduce,
    elite_threshold,
    softmax_weights,
    weighted_update,
)
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import (
    Graphed,
    capturable,
    collectives_capturable,
    scan,
)
from ccv_mppi_path_tracker_tpu_torch.utils.profiling import span, stage, tracing


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
        otherwise both paths draw the kernel's Philox stream keyed by
        (ctrl.seed, ctrl.step) (core/random.py): the kernel in its RNG mode,
        the eager path by ops/sampling.py draw_standard_normals, a CUDA
        kernel on the card, so the two sample the same controls. The key is
        read from ``ctrl.key`` on the device where the state has one (by
        value where it has none). The returned state's step and key are
        advanced by one. A model that samples its own transitions
        (``Model.stochastic``) draws them from the key whether or not
        ``noise`` is given.
    use_kernel: True runs sample + rollout + cost + update in the fused
        kernel (float32 only, any K, the four built-in models of
        ``KERNEL_MODELS``; another model raises), False the eager path. Only
        a bool: ``"auto"`` is resolved by :func:`compile_step`,
        :class:`MPPISolver` and the runtime's loops, and raises here.
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
        (the kernel keeps no rollout), not with ``lean``, and not for a model
        that samples its own transitions.
    group: a ``torch.distributed`` process group over the sample shards
        (parallel/sharded.py). This call is one shard: it runs
        ``num_samples`` samples (the shard's K/N; default cfg.num_samples)
        starting at sample index ``first_sample``, and every reduction is a
        collective, so u_opt and the stats are those of all K samples and
        equal on every rank. Either path draws samples first_sample ...
        first_sample + K/N - 1 of the unsharded Philox stream, so N shards
        draw the unsharded step's samples. ``noise`` is then this shard's
        (T-1, K/N, U).
    """
    if not isinstance(use_kernel, bool):
        raise ValueError(f"mppi_step takes use_kernel True or False, not {use_kernel!r}: "
                         "compile_step, MPPISolver and ControlLoop resolve \"auto\" "
                         "(kernels/rollout_cost.py should_use_kernel)")
    if use_kernel and cfg.model not in KERNEL_MODELS:
        raise ValueError(f"the fused kernel implements {KERNEL_MODELS}, not {cfg.model!r}: "
                         "run this model with use_kernel=False or \"auto\"")
    if elite_stale_thresh is not None and elite_frac is None:
        raise ValueError("elite_stale_thresh requires elite_frac (for the next threshold)")
    if lean and debug_candidates:
        raise ValueError("lean drops the debug outputs: no debug_candidates with lean")
    k = cfg.num_samples if num_samples is None else num_samples
    model = get_model(cfg.model)
    if model.stochastic and debug_candidates:
        raise ValueError(f"{cfg.model} samples its own transitions: no debug_candidates")
    # each block a stage of utils/profiling.py: op by op a span while a
    # profiler runs; in a captured graph the run of device nodes it launched
    with stage("prologue"):
        if delay is not None:
            state = model_rollout(model, state, ctrl.u_prev[:1], delay, model_params)[-1]
        u_mean = ctrl.u_prev
        if shift_warm_start:
            u_mean = torch.cat([ctrl.u_prev[1:], ctrl.u_prev[-1:]], dim=0)
        next_key = None
        if use_kernel:
            # the window, the scalars, the kernel's centred operands and
            # tickets, the default body parameters and the next key: one
            # launch on the card (kernels/step_prologue.py)
            pro = step_prologue(cfg, path, state, dt, sp, cp, model_params,
                                elite_stale_thresh, ctrl.key, num_samples=k)
            ref, model_params, next_key = pro.ref, pro.model_params, pro.next_key
        else:
            if model_params is None and model.default_params is not None:
                model_params = model.default_params(device=state.device, dtype=state.dtype)
            ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)

    if use_kernel:
        two_pass = elite_frac is not None and elite_stale_thresh is None
        kargs = (u_mean, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state)
        kw = dict(ctrl.rng(), num_samples=k, model=cfg.model, steer_off=cfg.steer_off,
                  noise=noise, second_moment=adapt_sigma, first_sample=first_sample,
                  prepared=pro.launch)
        with stage("rollout_cost"):
            costs, u_num, norm, *u2_num = fused_sample_rollout_cost(
                *kargs, pro.scal, accumulate=not two_pass, **kw)
        if two_pass:
            # the threshold of the first pass's costs, then the pass that
            # accumulates the masked update
            with stage("average"):
                stats = _kernel_stats(costs, sp.lam, elite_frac, elite_stale_thresh, lean,
                                      group)
            with stage("rollout_cost"):
                scal = pack_scalars(dt, cp, ref.yaw[0], model_params, sp.noise_beta,
                                    sp.lam, cost_thresh=stats["elite_thresh"])
                _, u_num, norm, *u2_num = fused_sample_rollout_cost(
                    *kargs, scal, costs_in=costs, **kw)
        with stage("average"):
            if not two_pass:
                stats = _kernel_stats(costs, sp.lam, elite_frac, elite_stale_thresh, lean,
                                      group)
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
        if noise is None:
            with stage("draw"):
                tm1, u_dim = u_mean.shape
                noise = draw_standard_normals(**ctrl.rng(), shape=(tm1, k, u_dim),
                                              first_sample=first_sample, dtype=u_mean.dtype,
                                              device=state.device)
        with stage("samples"):
            u_samples = sample_controls(u_mean, sp, k, steer_off=cfg.steer_off, noise=noise)
        with stage("rollout_cost"):
            state0 = state.expand(k, -1)
            if model.stochastic:
                # particles of each sequence, their transitions drawn from the
                # step's key at the shard's samples (Model.stochastic)
                costs = model.rollout_cost(state0, u_samples, dt, model_params, ref, cp,
                                           **ctrl.rng(), first_sample=first_sample)
            elif (model.rollout_cost is not None and not debug_candidates
                    and model.aux_from_rollout is None):
                # rollout and cost in one, no state kept (Model.rollout_cost)
                costs = model.rollout_cost(state0, u_samples, dt, model_params, ref, cp)
            else:
                if cfg.model in CLOSED_FORM_MODELS:
                    states = rollout_closed_form(cfg.model, state0, u_samples, dt)
                else:
                    states = model_rollout(model, state0, u_samples, dt, model_params)
                aux = {}
                if model.aux_from_rollout is not None:
                    aux = model.aux_from_rollout(states, u_samples, dt, model_params)
                costs = trajectory_costs(cfg.model, states, u_samples, aux, ref, cp)
        with stage("average"):
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
        with stage("average"):
            stats["sigma_suggest"] = torch.where(stats["elite_stale_empty"],
                                                 sp.control_noise, stats["sigma_suggest"])
    if refine_steps:
        with stage("refine"):
            u_opt = _refine(cfg, u_opt, state, ref, dt, sp, cp, model_params, refine_steps,
                            refine_step_size, refine_method)

    with stage("finish"):
        next_ctrl = ctrl.advanced(u_opt, next_key=next_key)
        if lean:
            # only what a caller feeds back survives
            keep = {k: stats[k] for k in ("sigma_suggest", "elite_thresh") if k in stats}
            return next_ctrl, StepResult(u_opt=u_opt, u0=u_opt[0], ref=None,
                                         opt_states=None, stats=keep)
        opt_states = _opt_rollout(cfg.model, model, state, u_opt, dt, model_params)
        return next_ctrl, StepResult(
            u_opt=u_opt, u0=u_opt[0], ref=ref, opt_states=opt_states, stats=stats
        )


class KeyedGraph:
    """``fn``, a function of a ControllerState, compiled by
    :class:`utils.cuda_graph.Graphed` with the state's host integers kept out
    of the graph: the counterpart of ``jax.jit`` (and, with :meth:`scan`, of
    ``lax.scan``) of a function of the JAX package's carried PRNG key.

    A call is ``fn(ctrl, path, dt, *args) -> (ctrl, out)``, the state
    advanced by ``steps`` cycles; :meth:`scan` runs ``fn((ctrl, *carry),
    path, dt, *args) -> ((ctrl, *carry), y)`` ``length`` times. With
    ``graph`` and a state on the card the call replays the graph of its
    shapes, captured by the first such call: the graph takes the state's warm
    start and key (seed and step 0, so that no host integer enters its cache
    key), the path with its count of valid points a tensor and dt a tensor,
    and the state it returns gets the caller's seed and step + ``steps``.
    Otherwise ``fn`` runs eagerly on the arguments as given.
    """

    def __init__(self, fn, max_graphs: Optional[int] = None):
        self.fn = fn
        self.graphed = Graphed(fn, max_graphs=max_graphs)

    @property
    def captures(self) -> int:
        """CUDA graphs captured so far: one per shape set seen."""
        return self.graphed.captures

    @staticmethod
    def _inputs(ctrl, path, dt):
        """The state, path and dt as the graph takes them."""
        like = ctrl.u_prev
        if not isinstance(dt, torch.Tensor):
            dt = torch.full((), float(dt), dtype=like.dtype, device=like.device)
        return ControllerState(like, 0, 0, ctrl.with_key().key), path.with_count_tensor(), dt

    @staticmethod
    def _graphed(ctrl, graph) -> bool:
        return graph and ctrl.u_prev.device.type == "cuda"

    def cache_key(self, first, path, dt, *args):
        """The key of the graph that a call (``first`` its state) or a scan
        (``first`` its carry) with these arguments would replay."""
        ctrl = first[0] if isinstance(first, tuple) else first
        bare, path, dt = self._inputs(ctrl, path, dt)
        if isinstance(first, tuple):
            bare = (bare,) + tuple(first[1:])
        return self.graphed.cache_key(bare, path, dt, *args)

    def __call__(self, ctrl, path, dt, *args, steps: int = 1, graph: bool = True):
        return self.call(ctrl, path, dt, args, steps, graph, tracing())

    def call(self, ctrl, path, dt, args: tuple, steps: int, graph: bool, traced: bool):
        """``self(ctrl, path, dt, *args, steps=steps, graph=graph)``, where the
        caller asked :func:`utils.profiling.tracing` at its own entry
        (``traced``): then the graph's arguments built (``compiled.wrap_in``)
        and the caller's seed and step put back (``compiled.wrap_out``) are
        spans, beside :meth:`utils.cuda_graph.Graphed.call`'s."""
        if not traced:
            if not self._graphed(ctrl, graph):
                return self.fn(ctrl, path, dt, *args)
            out_ctrl, out = self.graphed.call(self._inputs(ctrl, path, dt) + args, False)
            return _restored(ctrl, out_ctrl, steps), out
        with span("compiled.wrap_in", True):
            inputs = self._inputs(ctrl, path, dt) if self._graphed(ctrl, graph) else None
        if inputs is None:
            return self.fn(ctrl, path, dt, *args)
        out_ctrl, out = self.graphed.call(inputs + args, True)
        with span("compiled.wrap_out", True):
            return _restored(ctrl, out_ctrl, steps), out

    def scan(self, carry, path, dt, *args, length: int, graph: bool = True):
        ctrl = carry[0]
        if not self._graphed(ctrl, graph):
            return scan(self.fn, carry, path, dt, *args, length=length)
        bare, path, dt = self._inputs(ctrl, path, dt)
        (last, *rest), ys = self.graphed.scan((bare,) + tuple(carry[1:]), path, dt, *args,
                                              length=length)
        return (_restored(ctrl, last, length), *rest), ys


def _restored(ctrl, out_ctrl, steps):
    """``out_ctrl`` (a graph's, seed and step 0) with ``ctrl``'s seed and its
    step + ``steps``."""
    return dataclasses.replace(out_ctrl, seed=ctrl.seed, step=ctrl.step + steps)


class CompiledStep:
    """``mppi_step`` of one configuration and option set: the counterpart of
    ``jax.jit(functools.partial(mppi_step, cfg, **options))``. Made by
    :func:`compile_step`; call it as ``step(ctrl, state, path, dt, sp, cp,
    model_params=None, noise=None, elite_stale_thresh=None)``, with what
    ``mppi_step`` returns.

    - On the card, on either path: each call replays the CUDA graph of the
      update (:class:`KeyedGraph`), captured by the first call of its
      shapes, which returns the eager run's result. The graph reads the key
      (``ctrl.key``, made from seed and step where the state has none) and
      advances it on the device: the kernel draws from it, and so does the
      eager path's draw (ops/sampling.py draw_standard_normals). ``dt``, the parameters, the path, its count
      of valid points, ``model_params``, ``noise`` and ``elite_stale_thresh``
      are inputs of the graph, so a measured dt, retuned weights or another
      course of the same capacity replay the same graph. Retune a parameter
      by passing a new tensor or by a torch in-place op, not through
      ``.data`` (utils/cuda_graph.py :class:`Graphed`). With
      ``refine_steps`` the graph holds the refine stage. A call that cannot
      be captured (a tensor that requires grad, tensors of two devices)
      raises, and so does a first call that reads the card back to the host
      (a user-registered model whose step or cost does, utils/cuda_graph.py
      :func:`refuse_host_syncs`) or a capture that fails: no call runs op by
      op in a graph's place.
    - On the CPU, where the caller asked for it, each call is ``mppi_step``.

    ``group`` (one shard of the sample-sharded step, parallel/sharded.py):
    over NCCL the graph holds the collectives (the all-reduces MIN and SUM
    of the baseline, the normalizer and the update, the all-gather of the
    elite threshold), the counterpart of ``jax.jit`` of the JAX package's
    ``shard_map``; the group is a constant of the graph, by identity. Over
    gloo, whose collectives copy through the host, a call on the card
    raises; on the CPU it is ``mppi_step``, as without a group.
    """

    def __init__(self, cfg: SolverConfig, **options):
        group = options.get("group")
        self.cfg = cfg
        self.options = options
        self.graph = KeyedGraph(_graph_step)
        self._host_collectives = group is not None and not collectives_capturable(group)

    @property
    def captures(self) -> int:
        """CUDA graphs captured so far: one per shape set this step has seen."""
        return self.graph.captures

    def _args(self, ctrl, state, path, dt, sp, cp, model_params=None, noise=None,
              elite_stale_thresh=None):
        """The arguments of :func:`_graph_step` for this call: the options
        with the call's tensors (those given) beside them."""
        kw = dict(self.options)
        for name, value in (("model_params", model_params), ("noise", noise),
                            ("elite_stale_thresh", elite_stale_thresh)):
            if value is not None:
                kw[name] = value
        return ctrl, path, dt, state, sp, cp, self.cfg, kw

    def cache_key(self, *args, **kwargs):
        """The key of the graph that this call replays (``__call__``'s
        arguments); the configuration and options are part of it."""
        return self.graph.cache_key(*self._args(*args, **kwargs))

    def __call__(self, *args, **kwargs):
        traced = tracing()
        if traced:
            with span("compiled.wrap_in", True):
                args = self._args(*args, **kwargs)
        else:
            args = self._args(*args, **kwargs)
        if self._host_collectives and args[0].u_prev.device.type == "cuda":
            raise ValueError("compile_step over a process group whose collectives copy "
                             "through the host (gloo) cannot replay on the card: form the "
                             "group over NCCL (parallel/multihost.py initialize_multihost("
                             "backend='nccl')), or call mppi_step op by op")
        return self.graph.call(args[0], args[1], args[2], args[3:], 1, True, traced)


def compile_step(cfg: SolverConfig, **options) -> CompiledStep:
    """The compiled control step of ``cfg`` under ``options`` (the keyword
    options of :func:`mppi_step`): see :class:`CompiledStep`. ``use_kernel``
    may be ``"auto"``: the fused kernel where
    :func:`kernels.rollout_cost.should_use_kernel` takes the model on the
    device of the state a call gives, resolved where the step runs op by op
    or is captured (:func:`_graph_step`), never at a replay."""
    return CompiledStep(cfg, **options)


def _graph_step(ctrl, path, dt, state, sp, cp, cfg, kw):
    """The function a :class:`CompiledStep` captures: ``use_kernel="auto"``
    resolved here by :func:`kernels.rollout_cost.should_use_kernel` for the
    device of ``state``, so that a graph's replay, which runs no host code,
    pays nothing for it."""
    return mppi_step(cfg, ctrl, state, path, dt, sp, cp, **resolve_auto(cfg, kw, state.device))


def resolve_auto(cfg: SolverConfig, options: dict, device) -> dict:
    """``options`` (keyword options of :func:`mppi_step`) with
    ``use_kernel="auto"`` resolved by
    :func:`kernels.rollout_cost.should_use_kernel` for ``device``."""
    if options.get("use_kernel") == "auto":
        return dict(options, use_kernel=should_use_kernel(cfg.model, device))
    return options


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


def _kernel_stats(costs, lam, elite_frac, elite_stale_thresh, lean, group) -> dict:
    """The kernel path's stats of the sampled ``costs``: lean, only the elite
    threshold (where ``elite_frac`` asks for one); else softmax_weights'."""
    if not lean:
        return softmax_weights(costs, lam, elite_frac=elite_frac,
                               elite_thresh=elite_stale_thresh, group=group)[1]
    if elite_frac is None:
        return {}
    return {"elite_thresh": elite_threshold(costs, elite_frac, group)}


def _sigma_suggest(m2, u_opt):
    """Per-channel std of the weighted sample distribution, averaged over t:
    sqrt(mean_t max(E_w[u^2] - u_opt^2, 0))."""
    var = torch.clamp(m2 - u_opt * u_opt, min=0.0)
    return torch.sqrt(torch.mean(var, dim=0))


def _refine(cfg, u_opt, state, ref, dt, sp, cp, model_params, steps, step_size, method):
    """The refine stage of ``mppi_step`` (diff/gradients.py). On the card,
    for a built-in model, it runs as a CUDA graph captured on its first
    call for these shapes and options (:data:`REFINE_GRAPHS`): eagerly it is
    about 1700 small launches (Gauss-Newton, full_body), which the host
    takes far longer to enqueue than the card to run. Inside a capture (a
    compiled step's) it runs inline, so the outer graph holds it; with a
    tensor that requires grad, eagerly."""
    args = (cfg, u_opt, state, ref, dt, sp, cp, model_params, steps, step_size, method)
    if cfg.model in CLOSED_FORM_MODELS and capturable(args):
        return REFINE_GRAPHS(*args)
    return refine_stage(*args)


def refine_stage(cfg, u_opt, state, ref, dt, sp, cp, model_params, steps, step_size, method):
    """The refine stage, eagerly: ``steps`` refinement steps of ``method``,
    the steer channel held at zero under ``cfg.steer_off``. ``mppi_step``
    marks it as the stage ``refine`` (utils/profiling.py)."""
    if method == "gauss_newton":
        u_opt = gauss_newton_refine(cfg, u_opt, state, ref, dt, sp, cp,
                                    model_params=model_params, num_steps=steps)
    elif method == "gradient":
        u_opt = gradient_refine(cfg, u_opt, state, ref, dt, sp, cp,
                                model_params=model_params, step_size=step_size,
                                num_steps=steps)
    else:
        raise ValueError(f"refine_method must be 'gradient' or 'gauss_newton', "
                         f"got {method!r}")
    if cfg.steer_off and u_opt.shape[1] > STEER_DIM:
        # the gradient has no reason to keep the disabled channel at zero
        u_opt = u_opt.clone()
        u_opt[:, STEER_DIM] = 0.0
    return u_opt


# The refine stage's CUDA graphs: one per refine configuration and shapes a
# process runs (least recently used dropped first).
REFINE_GRAPHS = Graphed(refine_stage, max_graphs=16)


def _opt_rollout(model_name, model, state, u_opt, dt, model_params=None):
    """Planned-path re-roll of the optimal sequence (the reference's
    publish_OptimalPath, src/diff_drive_mppi.cpp:295-312), in the closed
    form where the model has one, else sequentially under ``model_params``."""
    if model_name in CLOSED_FORM_MODELS:
        return rollout_closed_form(model_name, state, u_opt, dt)
    return model_rollout(model, state, u_opt, dt, model_params)


class MPPISolver:
    """One configuration's control step: construct with a config, call
    :meth:`step` each control cycle with the measured state. The step is
    :func:`compile_step`'s (the JAX package's solver owns its jitted step):
    on the card, a CUDA graph's replay on either path, a user-registered
    model's eager path too."""

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
        self.compiled = compile_step(cfg, use_kernel=use_kernel)

    def init(self, seed: int = 0, dtype=torch.float32, device=None) -> ControllerState:
        """A zero warm start on ``device`` (None: the card)."""
        return ControllerState.initial(
            seed, self.cfg.horizon, self.model.num_controls, dtype=dtype, device=device
        )

    def step(self, ctrl, state, path, dt, sp, cp, model_params=None):
        return self.compiled(ctrl, state, path, dt, sp, cp, model_params=model_params)
