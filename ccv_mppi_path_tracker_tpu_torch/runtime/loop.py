"""Closed-loop receding-horizon drivers (port of ``runtime/loop.py``).

- :func:`simulate` is the counterpart of the JAX package's
  ``build_simulate_scan``: controller and plant alternate on the device for
  ``num_steps`` cycles, each cycle one call of :func:`cycle`. On the card
  with the fused kernel the cycle is one CUDA graph, replayed once a cycle
  with its carry (warm start, key, state, stale elite threshold) kept in the
  graph's buffers (utils/cuda_graph.py ``Graphed.scan``, the counterpart of
  ``lax.scan``); otherwise the same function runs eagerly. No cycle reads a
  value back to the host; the logs are stacked on the device.
- :class:`ControlLoop` is host-driven stepping for a live plant: the caller
  feeds the measured state each cycle (with a wall-clock-measured dt, as the
  reference's run loop, src/diff_drive_mppi.cpp:346-348) and reads back the
  command. Its step is :func:`solver.mppi.compile_step`'s, a CUDA graph's
  replay on the card with the kernel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, StepResult
from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.runtime.plant import Plant
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph, compile_step, mppi_step


def simulate(
    cfg: SolverConfig,
    ctrl: ControllerState,
    state0: torch.Tensor,
    path: PathBuffer,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    plant: Optional[Plant] = None,
    num_steps: int = 100,
    use_kernel: bool = False,
    solver_options: Optional[dict] = None,
    with_stats: bool = True,
    with_paths: bool = False,
):
    """Run ``num_steps`` control cycles against the plant.

    Each cycle runs ``mppi_step`` and applies u0 to the plant (:func:`cycle`);
    the plant's process noise (if any) is drawn from the cycle's device key
    (core/random.py plant_normals; a state without a key gets one made from
    its seed and step). Returns (final ctrl, logs) with logs "state"
    (N, S), "u0" (N, U) and, with ``with_stats``, every solver stat (N,):
    min_cost, mean_cost, ess, and elite_thresh or sigma_suggest where the
    options compute them; tensors on the device. ``with_stats=False`` runs
    the lean step (``mppi_step(..., lean=True)``) and logs the state and u0
    only; u0 is the same either way. ``with_paths`` also logs each cycle's
    planned path "opt_xy" (N, T, 2) and reference window "ref_xy" (N, T, 2);
    with ``solver_options={"debug_candidates": M}`` the stats add the
    sampled paths "candidates" (N, M, T, 2), what metrics/animate.py draws.

    solver_options: extra keyword options of every cycle's ``mppi_step``
    (shift_warm_start, delay, elite_frac, refine_steps, ...).
    ``"elite_stale": True`` (with elite_frac) runs single-pass elite: each
    cycle masks at the previous cycle's threshold, +inf on the first cycle.

    On the card with ``use_kernel`` the cycle is one CUDA graph (captured by
    the first run of its configuration and shapes, kept for later runs),
    replayed ``num_steps`` times with its carry in the graph's buffers:
    dt, the parameters and the path are its inputs, the key its carry, and
    the final state's step is set on the host. A sharded cycle (``group``
    among the options) runs eagerly: its collectives are not captured.
    """
    if plant is None:
        plant = Plant(model_name=cfg.model)
    model = get_model(cfg.model)
    if model_params is None and model.default_params is not None:
        model_params = model.default_params(device=state0.device, dtype=state0.dtype)
    opts = dict(solver_options or {})
    elite_stale = opts.pop("elite_stale", False)
    thresh = None
    if elite_stale:
        if opts.get("elite_frac") is None:
            raise ValueError("elite_stale requires elite_frac")
        thresh = torch.full((), torch.inf, dtype=state0.dtype, device=state0.device)
    opts.update(use_kernel=use_kernel, lean=not (with_stats or with_paths))
    (ctrl, _, _), logs = CYCLE.scan(
        (ctrl.with_key(), state0, thresh), path, dt, sp, cp, model_params, cfg, plant, opts,
        with_stats, with_paths, length=num_steps,
        graph=use_kernel and opts.get("group") is None)
    return ctrl, logs


def cycle(carry, path, dt, sp, cp, model_params, cfg, plant, options, with_stats,
          with_paths):
    """One closed-loop cycle, the function :func:`simulate` scans:
    ``carry`` is (ctrl, state, stale elite threshold or None), ctrl with its
    key; ``options`` the keyword options of ``mppi_step``. Returns (the next
    carry, the cycle's log row)."""
    ctrl, state, thresh = carry
    if thresh is not None:
        options = dict(options, elite_stale_thresh=thresh)
    next_ctrl, res = mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                               model_params=model_params, **options)
    if thresh is not None:
        thresh = res.stats["elite_thresh"]
    state = plant.step(state, res.u0, dt, key=ctrl.key)
    log = {"state": state, "u0": res.u0, **(res.stats if with_stats else {})}
    if with_paths:
        log.update(opt_xy=res.opt_states[:, :2], ref_xy=res.ref.xy)
    return (next_ctrl, state, thresh), log


# The closed-loop cycle, compiled: on the card one CUDA graph per
# configuration and shapes a process runs, kept across runs (least recently
# used dropped first).
CYCLE = KeyedGraph(cycle, max_graphs=16)


@dataclasses.dataclass
class ControlLoop:
    """Host-driven control loop for live plants.

    Mirrors the reference run() loop: dt is measured wall-clock between
    cycles (src/diff_drive_mppi.cpp:346-348). Every cycle runs the step of
    :func:`solver.mppi.compile_step` on the device of ``sp`` (``compiled``):
    on the card with ``use_kernel`` the replay of one CUDA graph, captured by
    the first cycle, whose inputs are the state, the measured dt, sigma, the
    stale elite threshold and the path; the only transfers are the measured
    state in and whatever the caller reads from the returned StepResult.
    Retune ``sp``, ``cp`` or ``model_params`` by new tensors or torch in-place
    ops: a replay does not see a write through ``.data`` (utils/cuda_graph.py
    ``Graphed``).

    sigma_adapt: covariance-adaptive importance sampling (PAPERS.md, "MPPI
        using Covariance Variable Importance Sampling"): the EMA coefficient
        a feeding the step's stats["sigma_suggest"] back into
        sp.control_noise each cycle, (1-a)*sigma + a*suggest clipped to
        [lo, hi] x the initial sigma (``sigma_bounds``). 0 keeps sigma fixed
        (the reference). The JAX loop does this float32 arithmetic in NumPy
        after reading the suggestion back; here the same float32 operations
        run as torch ops on the device, so the cycle makes no host sync.
    solver_options: extra keyword options of every cycle's mppi_step
        (use_kernel, elite_frac, noise, shift_warm_start, delay, lean, ...).
        ``"elite_stale": True`` (with elite_frac) holds the single-pass
        elite threshold between cycles, +inf on the first cycle and after
        :meth:`set_path`.
    """

    cfg: SolverConfig
    sp: SolverParams
    cp: CostParams
    path: PathBuffer
    model_params: object = None
    nominal_dt: float = 0.1
    sigma_adapt: float = 0.0
    sigma_bounds: tuple = (0.25, 4.0)  # clip range, x initial sigma
    solver_options: Optional[dict] = None

    def __post_init__(self):
        opts = dict(self.solver_options or {})
        self._elite_stale = opts.pop("elite_stale", False)
        if self._elite_stale and opts.get("elite_frac") is None:
            raise ValueError("elite_stale requires elite_frac")
        self.compiled = compile_step(self.cfg, adapt_sigma=self.sigma_adapt > 0, **opts)
        self._device, self._dtype = self.sp.lam.device, self.sp.lam.dtype
        self._reset_thresh()
        self._sigma0 = self.sp.control_noise
        self._last_time = None
        model = get_model(self.cfg.model)
        self.ctrl = ControllerState.initial(0, self.cfg.horizon, model.num_controls,
                                            dtype=self._dtype, device=self._device)

    def _reset_thresh(self):
        self._thresh = None
        if self._elite_stale:
            self._thresh = torch.full((), torch.inf, dtype=self._dtype,
                                      device=self._device)

    def set_path(self, path: PathBuffer):
        """Swap the reference course. The stale elite threshold belongs to
        the old course, so the next cycle runs unmasked, as a first cycle
        does. A course of the same capacity replays the same graph."""
        self.path = path
        self._reset_thresh()

    def measure_dt(self) -> float:
        now = time.monotonic()
        dt = self.nominal_dt if self._last_time is None else now - self._last_time
        self._last_time = now
        return dt

    def step(self, state, dt: Optional[float] = None) -> StepResult:
        """One control cycle: returns the StepResult for the measured state."""
        if dt is None:
            dt = self.measure_dt()
        state = torch.as_tensor(state, dtype=self._dtype, device=self._device)
        self.ctrl, res = self.compiled(
            self.ctrl, state, self.path,
            torch.full((), dt, dtype=self._dtype, device=self._device), self.sp,
            self.cp, model_params=self.model_params, elite_stale_thresh=self._thresh,
        )
        if self._elite_stale:
            self._thresh = res.stats["elite_thresh"]
        if self.sigma_adapt > 0:
            a = self.sigma_adapt
            sigma = (1 - a) * self.sp.control_noise + a * res.stats["sigma_suggest"]
            lo, hi = self.sigma_bounds
            sigma = torch.clamp(sigma, lo * self._sigma0, hi * self._sigma0)
            self.sp = dataclasses.replace(self.sp, control_noise=sigma)
        return res


def run_tracking_experiment(
    cfg: SolverConfig,
    sp: SolverParams,
    cp: CostParams,
    course: np.ndarray,
    num_steps: int = 200,
    dt: float = 0.1,
    plant: Optional[Plant] = None,
    model_params=None,
    seed: int = 0,
    start_on_course: bool = True,
    use_kernel: bool = False,
    resolution: Optional[float] = 0.1,
    ctrl: Optional[ControllerState] = None,
    state0=None,
    solver_options: Optional[dict] = None,
    with_paths: bool = False,
):
    """Run a tracking experiment on the device of ``sp``; return logs (the
    state, u0 and solver stats of every cycle, as NumPy arrays) and the
    calc_e_rmse metrics.

    The start pose is the first course point, aligned with the initial
    course heading (the reference spawns the robot on the course), or the
    origin with ``start_on_course=False``. ``resolution`` is the course
    generator's sample spacing (the reference's ``resolution`` param): it
    sets the reference-window stride, not the arc length; None infers the
    median segment length of the course's first points. ``ctrl`` and
    ``state0`` replace the fresh warm start and the start pose: pass a
    restored ControllerState (runtime/checkpoint.py) to resume a run.
    ``solver_options`` and ``with_paths`` go to :func:`simulate`.
    """
    device, dtype = sp.lam.device, sp.lam.dtype
    model = get_model(cfg.model)
    if resolution is None:
        resolution = _infer_resolution(course)
    path = PathBuffer.from_points(course, resolution, dtype=dtype, device=device)
    if state0 is None:
        state0 = np.zeros(model.num_states, np.float64)
        if start_on_course:
            state0[0], state0[1] = course[0]
            state0[2] = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    state0 = np.asarray(state0.cpu() if isinstance(state0, torch.Tensor) else state0,
                        np.float64)
    if ctrl is None:
        ctrl = ControllerState.initial(seed, cfg.horizon, model.num_controls,
                                       dtype=dtype, device=device)
    ctrl, logs = simulate(
        cfg, ctrl, torch.as_tensor(state0, dtype=dtype, device=device), path,
        torch.full((), dt, dtype=dtype, device=device), sp, cp,
        model_params=model_params, plant=plant, num_steps=num_steps,
        use_kernel=use_kernel, solver_options=solver_options, with_paths=with_paths,
    )
    logs = {k: v.cpu().numpy() for k, v in logs.items()}
    xy = np.concatenate([state0[None, :2], logs["state"][:, :2]], axis=0)
    metrics = tracking_metrics(xy, course, dt=dt)
    return {"logs": logs, "metrics": metrics, "course": course,
            "state0": state0, "ctrl": ctrl}


def _infer_resolution(course: np.ndarray) -> float:
    """Median segment length of the course's first 50 points."""
    seg = np.hypot(*np.diff(course[: min(len(course), 50)], axis=0).T)
    return float(np.median(seg))
