"""Real-time host execution: native scheduler + gate + recorder + the solver
on the card (port of ``runtime/realtime.py``).

The production-shaped equivalent of the reference's node main loop
(ros::Rate(10) + spinOnce + publish, src/diff_drive_mppi.cpp:332-369): the
native absolute-deadline RateExecutor paces the cycle, the InputGate makes
the stale-input policy explicit, the control update produces the command,
the command geometry maps it to actuators, and the native background-thread
CSV recorder logs without blocking the control path. Deadline-miss and
jitter statistics come back with the results; the reference silently slips.

- :func:`run_realtime_experiment`: one update a cycle through
  :class:`ControlLoop` (the fused kernel with ``use_kernel``, else the eager
  path; on the card either is a CUDA graph's replay) and a plant on the device, with one device->host read
  a cycle.
- :func:`run_pipelined_experiment`: cycle n dispatches the update of cycle
  n+1 before it fetches cycle n's command, with a host plant, optionally M
  cycles per dispatch; on the card a dispatch is the replay of one CUDA
  graph, on either path (the JAX package's jitted step and its jitted scan of an
  M-cycle window).

The gate, the command geometry and the host plant stay outside the compiled
step, as in the JAX package.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.metrics.recorder import COLUMNS
from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
from ccv_mppi_path_tracker_tpu_torch.models.rate_limited_steering import RATE_MAX, STEER_MAX
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.runtime.gating import InputGate
from ccv_mppi_path_tracker_tpu_torch.runtime.loop import ControlLoop
from ccv_mppi_path_tracker_tpu_torch.runtime.native import NativeCsvRecorder, RateExecutor
from ccv_mppi_path_tracker_tpu_torch.solver.command import (
    MODE_NO_NEED,
    command_from_solution,
    steering_mode,
)
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import (
    KeyedGraph,
    compile_step,
    mppi_step,
    resolve_auto,
)


def _start_pose(course, num_states):
    """The first course point, aligned with the initial course heading."""
    slope = math.atan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    return [float(course[0, 0]), float(course[0, 1]), slope] + [0.0] * (num_states - 3)


def run_realtime_experiment(
    cfg: SolverConfig,
    sp: SolverParams,
    cp: CostParams,
    course: np.ndarray,
    hz: float = 10.0,
    num_cycles: int = 100,
    record_path: Optional[str] = None,
    model_params=None,
    resolution: float = 0.1,
    lean: bool = True,
    use_kernel: bool = False,
):
    """Track ``course`` at a fixed wall-clock rate with an in-process plant,
    on the device of ``sp``.

    Each cycle: ``rate.sleep()`` -> the gate takes the pose -> one update
    (ControlLoop, ``lean`` by default, the fused kernel with ``use_kernel``)
    -> ``command_from_solution`` -> the gate's stale policy -> the steering
    mode -> the plant steps with the measured dt (as the real robot
    integrates in real time) -> the state, the command and the mode stacked
    into one tensor and read back to the host in one copy -> the recorder
    row. A warm-up cycle runs the whole cycle through to that host read
    before the schedule starts; the controller is then reset, so the first
    timed cycle starts on time and from a clean warm start.

    Returns {"metrics", "rate_stats", "logs", "stale_cycles",
    "invalid_steer_cycles"}.
    """
    device, dtype = sp.lam.device, sp.lam.dtype
    path = PathBuffer.from_points(course, resolution, dtype=dtype, device=device)
    opts = {"lean": True} if lean else {}
    if use_kernel:
        opts["use_kernel"] = use_kernel
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path, model_params=model_params,
                       nominal_dt=1.0 / hz, solver_options=opts or None)
    model = get_model(cfg.model)
    gate = InputGate(stale_policy="hold")
    gate.add_channel("pose", max_age=3.0 / hz)
    start = torch.tensor(_start_pose(course, model.num_states), dtype=dtype, device=device)

    def cycle(state, dt, last_cmd):
        """One cycle on the device; returns (state, command, the host row
        [state..., v, w, steer_r, steer_l, roll, mode])."""
        gate.update("pose", state)
        res = loop.step(gate.get("pose"), dt=dt)
        cmd = command_from_solution(cfg.model, res.u0, dt)
        cmd = gate.resolve_command(cmd, cmd if last_cmd is None else last_cmd)
        # the reference flags opposite-sign steer angles on every joint-state
        # message (src/steering_diff_drive_mppi.cpp:75-76)
        mode = steering_mode(cmd.steer_r, cmd.steer_l)
        state = model.step(state, res.u0, dt)
        row = torch.cat([state, torch.stack([cmd.v, cmd.w, cmd.steer_r, cmd.steer_l,
                                             cmd.roll, mode.to(dtype)])])
        return state, cmd, row.cpu().numpy()

    cycle(start, 1.0 / hz, None)  # warm-up, through to the host read
    loop.ctrl = ControllerState.initial(0, cfg.horizon, model.num_controls, dtype=dtype,
                                        device=device)
    loop._last_time = None
    gate.stale_cycles = 0

    rec = None if record_path is None else NativeCsvRecorder(record_path, COLUMNS)
    s_dim = model.num_states
    rate = RateExecutor(hz)
    state, last_cmd = start, None
    traj = [np.asarray(_start_pose(course, s_dim), np.float32)]
    t = 0.0
    invalid_steer_cycles = 0
    for _ in range(num_cycles):
        dt = rate.sleep()
        state, last_cmd, row = cycle(state, dt, last_cmd)
        s = row[:s_dim]
        v, w, steer_r, steer_l, roll, mode = row[s_dim:]
        traj.append(s)
        invalid_steer_cycles += int(mode) == MODE_NO_NEED
        t += dt
        if rec is not None:
            rec.row([t, s[0], s[1], w, s[2], s[0], s[1], v, v, steer_r, steer_l, roll,
                     0.0, 0.0, np.nan, np.nan])
    if rec is not None:
        rec.close()
    traj = np.stack(traj).astype(np.float64)
    return {
        "metrics": tracking_metrics(traj[:, :2], course, dt=1.0 / hz),
        "rate_stats": rate.stats(),
        "logs": {"state": traj},
        "stale_cycles": gate.stale_cycles,
        "invalid_steer_cycles": invalid_steer_cycles,
    }


_PLANT_NP_MODELS = ("unicycle", "steering_unicycle", "full_body", "rate_limited_steering")


def _plant_step_np(model_name: str, state, u, dt: float):
    """One host-side Euler plant step (NumPy float64; the kinematics of the
    models and of the C++ oracle): the pipelined loop's robot integrates in
    real time on the host while updates are in flight on the device.
    Built-in families only: a user-registered model's kinematics are not
    knowable here, and integrating it wrong silently is refused."""
    if model_name not in _PLANT_NP_MODELS:
        raise ValueError(
            f"run_pipelined_experiment's host plant supports the built-in "
            f"model families {_PLANT_NP_MODELS}; got {model_name!r}. "
            f"Drive custom models with run_realtime_experiment (device plant) "
            f"or run_tracking_experiment."
        )
    s = np.array(state, dtype=np.float64)
    if model_name == "unicycle":
        heading = s[2]
    elif model_name == "rate_limited_steering":
        # u[2] is the steering rate; position integrates with the current
        # steering-angle state (ops/rollout.py semantics)
        heading = s[2] + s[3]
    else:
        heading = s[2] + float(u[2])
    s[0] += float(u[0]) * math.cos(heading) * dt
    s[1] += float(u[0]) * math.sin(heading) * dt
    s[2] += float(u[1]) * dt
    if model_name == "full_body":
        s[3] += float(u[3]) * dt
        s[4] += float(u[4]) * dt
    elif model_name == "rate_limited_steering":
        rate = min(max(float(u[2]), -RATE_MAX), RATE_MAX)
        s[3] = min(max(s[3] + rate * dt, -STEER_MAX), STEER_MAX)
    return s


def window(ctrl, path, dt, state, sp, cp, cfg, micro_batch, plant_dt, step_kw):
    """``micro_batch`` cycles of the lean update (``mppi_step`` with
    ``step_kw``) and the model plant (a step of ``plant_dt``) back to back on
    the device: (the last ctrl, the commands u0 (M, U))."""
    model = get_model(cfg.model)
    u0s = []
    for _ in range(micro_batch):
        ctrl, res = mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                              **resolve_auto(cfg, step_kw, state.device))
        state = model.step(state, res.u0, plant_dt)
        u0s.append(res.u0)
    return ctrl, torch.stack(u0s)


def _ms_stats(seconds):
    """Mean, p95 and max, in ms, of host-clock durations in seconds (zeros
    for none: a one-window run dispatches nothing after its first window)."""
    x = np.asarray(seconds or [0.0]) * 1e3
    return {"mean": float(x.mean()), "p95": float(np.percentile(x, 95)), "max": float(x.max())}


class _Fetch:
    """A device->host copy of one window's commands: started without
    blocking into a pinned host buffer and marked by a CUDA event, which the
    fetch waits on. On a CPU tensor the copy is a plain one."""

    def __init__(self, shape, device):
        self.cuda = device.type == "cuda"
        self.host = torch.empty(shape, dtype=torch.float32, pin_memory=self.cuda)
        self.event = torch.cuda.Event() if self.cuda else None

    def start(self, u):
        self.host.copy_(u, non_blocking=self.cuda)
        if self.cuda:
            self.event.record()

    def wait(self) -> np.ndarray:
        if self.cuda:
            self.event.synchronize()
        return self.host.numpy().copy()


def run_pipelined_experiment(
    cfg: SolverConfig,
    sp: SolverParams,
    cp: CostParams,
    course: np.ndarray,
    hz: float = 25.0,
    num_cycles: int = 250,
    model_params=None,
    resolution: float = 0.1,
    use_kernel: bool = False,
    micro_batch: int = 1,
    delay_compensation: bool = True,
    seed: int = 0,
):
    """Asynchronous pipelined serving loop, on the device of ``sp``: window
    n dispatches the update(s) of window n+1 before it fetches window n's
    commands, so the host never blocks on an update in flight and a fetch
    of up to one control period is hidden. The one-window actuation lag this
    introduces is compensated, with ``delay_compensation``:

    - micro_batch = 1: one ``mppi_step(lean=True, delay=1/hz)`` a dispatch
      (``compile_step``'s: on the card, a graph's replay);
      the step plans from the state Euler-predicted one period ahead under
      the command in flight (solver/mppi.py).
    - micro_batch = M > 1: M cycles of ``mppi_step`` + ``model.step`` on the
      device with no host read between them (:func:`window`; on the card
      one CUDA graph of the whole window, the JAX package's jitted scan);
      within the window the controller advances on its own model plant,
      and the next window is dispatched from the state the host plant will
      reach after this window's M commands.

    Each window's commands come back through one non-blocking copy into a
    pinned host buffer, marked by a CUDA event that the fetch waits on. The
    plant is a host NumPy integrator of the same kinematics (the robot
    integrates in real time whatever the host does). The solver's rollout
    step stays at the course's 0.1 s grid whatever the control rate.
    ``num_cycles`` runs in whole windows: ``(num_cycles // M) * M`` paced
    cycles. The last window dispatches nothing after it, so the updates run
    are the cycles plus the warm-up window's M.

    Returns {"metrics", "rate_stats", "miss_rate", "fetch_ms" and
    "dispatch_ms" (mean, p95, max: the host's wait for a window's commands,
    and its time to enqueue the next window), "feedback_latency_cycles",
    "delay_compensation", "micro_batch", "logs"}.
    """
    if micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
    device, dtype = sp.lam.device, sp.lam.dtype
    model = get_model(cfg.model)
    path = PathBuffer.from_points(course, resolution, dtype=dtype, device=device)
    nominal_dt = 1.0 / hz
    # the plan is consumed one cycle (or one window) late
    delay = nominal_dt if delay_compensation else None
    state_h = np.array(_start_pose(course, model.num_states), dtype=np.float64)
    dt_solve = torch.full((), 0.1, dtype=dtype, device=device)
    fetch = _Fetch((micro_batch, model.num_controls), device)
    # the state goes to the device from a pinned buffer without blocking; it
    # is rewritten only after the fetch that follows its copy
    state_host = torch.empty(model.num_states, dtype=dtype, pin_memory=fetch.cuda)
    step_kw = dict(model_params=model_params, use_kernel=use_kernel, lean=True)
    step = compile_step(cfg, delay=delay, use_kernel=use_kernel, lean=True)
    windows = KeyedGraph(window)

    def dispatch(ctrl, s_np):
        state_host.copy_(torch.from_numpy(s_np))
        state = state_host.to(device, non_blocking=fetch.cuda)
        if micro_batch == 1:
            ctrl, res = step(ctrl, state, path, dt_solve, sp, cp, model_params=model_params)
            u = res.u0[None]
        else:
            ctrl, u = windows(ctrl, path, dt_solve, state, sp, cp, cfg, micro_batch,
                              nominal_dt, step_kw, steps=micro_batch)
        fetch.start(u)
        return ctrl

    def fresh_ctrl():
        return ControllerState.initial(seed, cfg.horizon, model.num_controls, dtype=dtype,
                                       device=device)

    # warm-up: the whole first window through to a host fetch
    dispatch(fresh_ctrl(), state_h)
    fetch.wait()

    num_batches = max(1, num_cycles // micro_batch)
    traj = [state_h.copy()]
    fetch_s, dispatch_s = [], []
    rate = RateExecutor(hz)
    ctrl = dispatch(fresh_ctrl(), state_h)  # the plan of the first window
    for b in range(num_batches):
        # the commands planned in the previous window, in flight for a whole
        # window: the fetch is hidden unless it takes longer than the window
        t0 = time.perf_counter()
        u_win = fetch.wait()
        fetch_s.append(time.perf_counter() - t0)
        # micro_batch 1 compensates in the solver (delay=1/hz predicts from
        # ctrl.u_prev[0], the command being actuated now); a window hands off
        # the state the plant reaches after this window's M commands
        s_dispatch = state_h
        if micro_batch > 1 and delay_compensation:
            for m in range(micro_batch):
                s_dispatch = _plant_step_np(cfg.model, s_dispatch, u_win[m], nominal_dt)
        # dispatch the next window before actuating this one, so the update
        # and its fetch overlap the whole actuation window
        if b + 1 < num_batches:
            t0 = time.perf_counter()
            ctrl = dispatch(ctrl, s_dispatch)
            dispatch_s.append(time.perf_counter() - t0)
        for m in range(micro_batch):
            dt = rate.sleep()
            state_h = _plant_step_np(cfg.model, state_h, u_win[m], dt)
            traj.append(state_h.copy())

    traj = np.stack(traj)
    rs = rate.stats()
    return {
        "metrics": tracking_metrics(traj[:, :2], course, dt=nominal_dt),
        "rate_stats": rs,
        "miss_rate": rs["deadline_misses"] / max(rs["cycles"], 1),
        "fetch_ms": _ms_stats(fetch_s),
        "dispatch_ms": _ms_stats(dispatch_s),
        "feedback_latency_cycles": micro_batch,
        "delay_compensation": delay_compensation,
        "micro_batch": micro_batch,
        "logs": {"state": traj},
    }
