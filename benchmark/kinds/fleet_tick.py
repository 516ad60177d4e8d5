"""Traffic kind ``fleet_tick``: a fleet operator serving ``robots`` robots on
one shared seeded course from one card. Each tick copies the fleet's poses
from the host, runs one tick of the configuration's fleet step, reads the
robots' commands (u0) back in one copy and steps the reference module's
NumPy plant by the solver's dt; a robot within ``respawn_before_end_m`` of
the course's end starts its lap again from its start pose. Ticks are chained
for the window.

Set-up: the first tick from zero warm starts (on the card it captures the
CUDA graph), then ``warmup_units`` more. The window starts at the next tick
and ends at the first tick that begins ``seconds`` after it, on CUDA events
(each tick ends in its read, so they agree with the host clock). End-to-end
metric: ``robot_updates_per_s`` = robots * ticks / window seconds.

Kept for the check: the first tick, a sample of ``check_sample`` ticks drawn
from the seed, and the last, every robot of each. With ``--trace 1`` the
window also records the host time of each tick call (span ``call.tick``),
and ``trace_units`` further ticks run under the profiler.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness, timing, trace


def run(ctx: harness.Context) -> harness.Outcome:
    prog, dev, conf, tr = ctx.program, ctx.device, ctx.config, ctx.traffic
    b = tr["robots"]
    course, dt_host = ctx.course, conf["dt"]
    heading = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    starts = np.zeros((b, ctx.reference.num_states(conf)), np.float32)
    starts[:, 0] = course[0, 0] + ctx.rng.uniform(*tr["spawn_dx_m"], b)
    starts[:, 1] = course[0, 1] + ctx.rng.uniform(*tr["spawn_dy_m"], b)
    starts[:, 2] = heading
    path = prog.path(course)
    dt = torch.full((), dt_host, dtype=torch.float32, device=dev)
    step = prog.fleet_step()
    before_end = tr["respawn_before_end_m"]
    plant = ctx.reference.plant

    def tick(ctrls, poses):
        states = torch.from_numpy(poses).to(dev)
        t0 = time.perf_counter()
        nxt, out, u0 = step(ctrls, states, path, dt)
        t1 = time.perf_counter()
        u0 = u0.cpu().numpy()
        moved = harness.respawn(plant(conf, poses, u0, dt_host), starts, course, before_end)
        return nxt, out, moved, t1 - t0

    def answer(n, ctrls, prev, out, poses):
        return harness.Answer(n, ctrls.u_prev, prev, ctrls.step, ctrls.key, out, poses)

    ctrls, poses = prog.init_fleet(b, ctx.seed), starts
    nxt, out, moved, _ = tick(ctrls, poses)
    answers = [answer(0, ctrls, torch.zeros_like(out), out, poses)]
    ctrls, prev, poses, n = nxt, out, moved, 1
    for _ in range(tr["warmup_units"]):
        ctrls, prev, poses, _ = tick(ctrls, poses)
        n += 1
    timing.settle(dev)

    sample = harness.Sample(ctx.seed, tr["check_sample"])
    kept = [None] * tr["check_sample"]
    spans = []
    count = 0
    clock = timing.DeviceWindow(dev)
    setup_end = time.perf_counter()
    clock.start()
    end = setup_end + ctx.seconds
    while True:
        if time.perf_counter() >= end and count:
            break
        ctrls_in, poses_in = ctrls, poses
        ctrls, out, poses, call = tick(ctrls_in, poses_in)
        if ctx.trace:
            spans.append(call)
        last = (n, ctrls_in, prev, out, poses_in)
        slot = sample.offer(count)
        if slot is not None:
            kept[slot] = last
        prev, n, count = out, n + 1, count + 1
    seconds = clock.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    answers += [answer(*k) for k in kept if k is not None] + [answer(*last)]

    traces, units = {}, {}
    if ctx.trace:
        def window():
            nonlocal ctrls, poses
            for _ in range(tr["trace_units"]):
                with record_function(harness.MARK):
                    ctrls, _, poses, _ = tick(ctrls, poses)
        events = trace.traced(window, dev)
        if events is not None:
            traces["tick"] = trace.breakdown(events, harness.MARK)
            units["tick"] = trace.unit_ops(events, harness.MARK)
    return harness.Outcome(
        metrics={"robot_updates_per_s": b * count / seconds},
        attempted=b * count, setup_end=setup_end, answers=answers, memory_peak=peak,
        spans={"call.tick": spans} if ctx.trace else {}, traces=traces, units=units)
