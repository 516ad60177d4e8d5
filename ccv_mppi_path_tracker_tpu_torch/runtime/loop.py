"""Closed-loop receding-horizon drivers (port of ``runtime/loop.py``).

- :func:`simulate` is the counterpart of the JAX package's
  ``build_simulate_scan``: controller and plant alternate on the device for
  ``num_steps`` cycles, here as a Python loop over cycles in place of
  ``lax.scan``. No cycle reads a value back to the host; the logs are
  stacked at the end.
- :class:`ControlLoop` is host-driven stepping for a live plant: the caller
  feeds the measured state each cycle (with a wall-clock-measured dt, as the
  reference's run loop, src/diff_drive_mppi.cpp:346-348) and reads back the
  command.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.random import cycle_generator
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, StepResult
from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.runtime.plant import Plant
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import mppi_step


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
):
    """Run ``num_steps`` control cycles against the plant.

    Each cycle runs ``mppi_step`` and applies u0 to the plant; the plant's
    process noise (if any) is drawn from the cycle's generator stream 1
    (core/random.py). Returns (final ctrl, logs) with logs "state" (N, S),
    "u0" (N, U) and, with ``with_stats``, every solver stat (N,): min_cost,
    mean_cost, ess, and elite_thresh or sigma_suggest where the options
    compute them; tensors on the device. ``with_stats=False`` runs the lean
    step (``mppi_step(..., lean=True)``) and logs the state and u0 only;
    u0 is the same either way.

    solver_options: extra keyword options of every cycle's ``mppi_step``
    (shift_warm_start, delay, elite_frac, refine_steps, ...).
    ``"elite_stale": True`` (with elite_frac) runs single-pass elite: each
    cycle masks at the previous cycle's threshold, +inf on the first cycle.
    """
    if plant is None:
        plant = Plant(model_name=cfg.model)
    model = get_model(cfg.model)
    if model_params is None and model.default_params is not None:
        model_params = model.default_params(device=state0.device, dtype=state0.dtype)
    opts = dict(solver_options or {})
    elite_stale = opts.pop("elite_stale", False)
    if elite_stale:
        if opts.get("elite_frac") is None:
            raise ValueError("elite_stale requires elite_frac")
        opts["elite_stale_thresh"] = torch.full((), torch.inf, dtype=state0.dtype,
                                                device=state0.device)
    state = state0
    logs = []
    for _ in range(num_steps):
        generator = None
        if plant.process_noise:
            generator = cycle_generator(ctrl.seed, ctrl.step, state.device, stream=1)
        ctrl, res = mppi_step(
            cfg, ctrl, state, path, dt, sp, cp, model_params=model_params,
            use_kernel=use_kernel, lean=not with_stats, **opts,
        )
        if elite_stale:
            opts["elite_stale_thresh"] = res.stats["elite_thresh"]
        state = plant.step(state, res.u0, dt, generator=generator)
        logs.append({"state": state, "u0": res.u0, **(res.stats if with_stats else {})})
    return ctrl, {k: torch.stack([log[k] for log in logs]) for k in logs[0]}


@dataclasses.dataclass
class ControlLoop:
    """Host-driven control loop for live plants.

    Mirrors the reference run() loop: dt is measured wall-clock between
    cycles (src/diff_drive_mppi.cpp:346-348). Every cycle runs
    :func:`mppi_step` on the device of ``sp``; the only transfers are the
    measured state in and whatever the caller reads from the returned
    StepResult.

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
        self._opts = opts
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
        does."""
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
        opts = dict(self._opts)
        if self._elite_stale:
            opts["elite_stale_thresh"] = self._thresh
        self.ctrl, res = mppi_step(
            self.cfg, self.ctrl, state, self.path,
            torch.full((), dt, dtype=self._dtype, device=self._device), self.sp,
            self.cp, model_params=self.model_params, adapt_sigma=self.sigma_adapt > 0,
            **opts,
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
    ``solver_options`` go to :func:`simulate`.
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
        use_kernel=use_kernel, solver_options=solver_options,
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
