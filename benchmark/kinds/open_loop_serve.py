"""Traffic kind ``open_loop_serve``: one live robot served at ``hz``. Pose
messages are due on an absolute schedule, every 1/hz seconds, whether or not
the previous cycle has finished (an open loop). Each cycle is composed as
``runtime/realtime.py`` composes it: the pose copied from the host, the
``InputGate`` update and get, ``ControlLoop.step(pose, dt=solver_dt)``,
``command_from_solution``, ``resolve_command``, ``steering_mode``, and one
device-to-host read of u0, the command and the mode. The plant is the world:
the reference module's NumPy model equations step 1/hz seconds on the u0
read, after the read and outside the latency; the robot starts its lap again
within ``respawn_before_end_m`` of the course's end.

The solver's dt is the configuration's horizon step (solver_dt), not the
measured period, so that the horizon covers what it is configured to and a
run is reproducible from the seed.

Set-up: ``warmup_units`` cycles unpaced (on the card the first captures the
update's CUDA graph), then a fresh controller state from the seed and the
start pose. The window holds round(seconds * hz) cycles. A cycle's latency
runs from its pose's due time to its command on the host, so a late cycle
counts the wait too; the generator's own lateness (start after due) is
reported on standard error. End-to-end metrics: ``cycle_ms_p95`` and
``cycle_ms_mean`` over every cycle of the window.

Kept for the check: the first cycle, a sample of ``check_sample`` cycles
drawn from the seed, and the last. With ``--trace 1`` the window also records
spans ``call.serve`` (the ControlLoop.step call) and ``glue`` (the copy in,
the gate, the command geometry, the stale policy, the mode and the read's
stacking, without the read's wait), and ``trace_units`` further cycles run
under the profiler, each inside one range from its due time to its read.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness, timing, trace

FIELDS = ("v", "w", "steer_l", "steer_r", "roll")


def wait_until(due: float):
    """Spin until ``due``: the cycle then starts on a core that stayed awake,
    so the host's sleep and wake-up times stay out of the latency."""
    while time.perf_counter() < due:
        pass


def run(ctx: harness.Context) -> harness.Outcome:
    prog, dev, conf, tr = ctx.program, ctx.device, ctx.config, ctx.traffic
    period, solver_dt = 1.0 / tr["hz"], tr["solver_dt"]
    course = ctx.course
    start = harness.start_pose(course, ctx.reference.num_states(conf), ctx.rng,
                               tr["pose_sigma"])[None]
    path = prog.path(course)
    loop = prog.control_loop(path, ctx.seed)
    gate = prog.gate()
    gate.add_channel("pose", max_age=tr["stale_periods"] * period)
    u_dim = len(conf["solver"]["u_min"])
    spans = {"call.serve": [], "glue": []}
    last_cmd = None

    def cycle(pose_np, record):
        """One cycle; returns (the read row, the result, the state going in,
        whether the gate held the last command)."""
        nonlocal last_cmd
        t0 = time.perf_counter()
        pose = torch.from_numpy(pose_np[0]).to(dev)
        gate.update("pose", pose)
        given = gate.get("pose")
        ctrl_in = loop.ctrl
        t1 = time.perf_counter()
        res = loop.step(given, dt=solver_dt)
        t2 = time.perf_counter()
        stale_before = gate.stale_cycles
        cmd = prog.command(res.u0, solver_dt)
        cmd = gate.resolve_command(cmd, cmd if last_cmd is None else last_cmd)
        mode = prog.mode(cmd)
        row = torch.cat([res.u0, torch.stack([getattr(cmd, f) for f in FIELDS]
                                             + [mode.to(res.u0.dtype)])])
        t3 = time.perf_counter()
        host = row.cpu().numpy()
        last_cmd = cmd
        if record:
            spans["call.serve"].append(t2 - t1)
            spans["glue"].append((t1 - t0) + (t3 - t2))
        return host, res, ctrl_in, gate.stale_cycles > stale_before

    def plant(pose_np, host):
        moved = ctx.reference.plant(conf, pose_np, host[None, :u_dim], period)
        return harness.respawn(moved, start, course, tr["respawn_before_end_m"])

    pose = start
    for _ in range(tr["warmup_units"]):
        host, _, _, _ = cycle(pose, False)
        pose = plant(pose, host)
    loop.ctrl = prog.initial(ctx.seed)
    pose, last_cmd = start, None
    timing.settle(dev)

    def answer(n, ctrl_in, prev, res, pose_np, host, stale):
        read = None
        if not stale:
            read = dict(zip(FIELDS, (float(x) for x in host[u_dim:u_dim + 5])),
                        u0=host[:u_dim].copy(), mode=int(host[-1]), dt=solver_dt)
        return harness.Answer(n, ctrl_in.u_prev[None], prev[None], ctrl_in.step,
                              ctrl_in.key, res.u_opt[None], pose_np, read)

    cycles = int(round(ctx.seconds * tr["hz"]))
    sample = harness.Sample(ctx.seed, tr["check_sample"])
    kept, answers = [None] * tr["check_sample"], []
    latency, late = [], []
    prev = None
    t_start = time.perf_counter() + 0.002
    for i in range(cycles):
        due = t_start + i * period
        wait_until(due)
        late.append(time.perf_counter() - due)
        host, res, ctrl_in, stale = cycle(pose, ctx.trace)
        latency.append(time.perf_counter() - due)
        rec = (i, ctrl_in, torch.zeros_like(res.u_opt) if prev is None else prev, res,
               pose, host, stale)
        if i == 0:
            answers.append(answer(*rec))
        slot = sample.offer(i)
        if slot is not None:
            kept[slot] = rec
        prev = res.u_opt
        pose = plant(pose, host)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    answers += [answer(*k) for k in kept if k is not None] + [answer(*rec)]
    print(f"generator lateness: mean {float(np.mean(late)) * 1e3!r} ms, max "
          f"{float(np.max(late)) * 1e3!r} ms over {cycles} cycles", file=sys.stderr)

    traces, units = {}, {}
    if ctx.trace:
        def window():
            nonlocal pose
            t0 = time.perf_counter() + 0.002
            for i in range(tr["trace_units"]):
                wait_until(t0 + i * period)
                with record_function(harness.MARK):
                    host, _, _, _ = cycle(pose, False)
                pose = plant(pose, host)
        events = trace.traced(window, dev)
        if events is not None:
            traces["cycle"] = trace.breakdown(events, harness.MARK)
            units["cycle"] = trace.unit_ops(events, harness.MARK)
    lat_ms = [x * 1e3 for x in latency]
    return harness.Outcome(
        metrics={"cycle_ms_p95": timing.percentile(lat_ms, 95.0),
                 "cycle_ms_mean": float(np.mean(lat_ms))},
        attempted=cycles, setup_end=t_start, answers=answers, memory_peak=peak,
        spans=spans if ctx.trace else {}, traces=traces, units=units)
