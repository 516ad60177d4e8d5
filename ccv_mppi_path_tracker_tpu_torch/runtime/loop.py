"""Closed-loop receding-horizon driver (port of ``runtime/loop.py``).

:func:`simulate` is the counterpart of the JAX package's
``build_simulate_scan``: controller and plant alternate on the device for
``num_steps`` cycles, here as a Python loop over cycles in place of
``lax.scan``. No cycle reads a value back to the host; the logs are stacked
at the end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.random import cycle_generator
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
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
):
    """Run ``num_steps`` control cycles against the plant.

    Each cycle runs ``mppi_step(..., lean=True)`` and applies u0 to the
    plant; the plant's process noise (if any) is drawn from the cycle's
    generator stream 1 (core/random.py). Returns (final ctrl, logs) with
    logs "state" (N, S) and "u0" (N, U) tensors on the device.

    solver_options: extra keyword options of every cycle's ``mppi_step``
    (shift_warm_start, delay, elite_frac). ``"elite_stale": True`` (with
    elite_frac) runs single-pass elite: each cycle masks at the previous
    cycle's threshold, +inf on the first cycle.
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
    states, u0s = [], []
    for _ in range(num_steps):
        generator = None
        if plant.process_noise:
            generator = cycle_generator(ctrl.seed, ctrl.step, state.device, stream=1)
        ctrl, res = mppi_step(
            cfg, ctrl, state, path, dt, sp, cp, model_params=model_params,
            use_kernel=use_kernel, lean=True, **opts,
        )
        if elite_stale:
            opts["elite_stale_thresh"] = res.stats["elite_thresh"]
        state = plant.step(state, res.u0, dt, generator=generator)
        states.append(state)
        u0s.append(res.u0)
    return ctrl, {"state": torch.stack(states), "u0": torch.stack(u0s)}


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
    use_kernel: bool = False,
    resolution: float = 0.1,
    solver_options: Optional[dict] = None,
):
    """Run a tracking experiment on the device of ``sp``; return logs and
    the calc_e_rmse metrics.

    The start pose is the first course point, aligned with the initial
    course heading (the reference spawns the robot on the course).
    ``resolution`` is the course generator's sample spacing (the reference's
    ``resolution`` param): it sets the reference-window stride.
    ``solver_options`` go to :func:`simulate`.
    """
    device, dtype = sp.lam.device, sp.lam.dtype
    model = get_model(cfg.model)
    path = PathBuffer.from_points(course, resolution, dtype=dtype, device=device)
    state0 = np.zeros(model.num_states, np.float64)
    state0[0], state0[1] = course[0]
    state0[2] = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
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
