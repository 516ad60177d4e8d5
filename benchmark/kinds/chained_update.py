"""Traffic kind ``chained_update``: one robot at a fixed seeded pose on a
seeded course, the configuration's compiled update chained for the whole
window, each update taking the previous controller state.

Set-up: the first update from the zero warm start (on the card it captures
the CUDA graph), then ``warmup_units`` more. The window starts at the next
call and ends at the first call that begins ``seconds`` after it; its length
is read by CUDA events, the last one waited for. End-to-end metric:
``propagations_per_s`` = K * (T-1) * updates / window seconds.

Kept for the check: the first update (from the zero warm start), a sample of
``check_sample`` of the window's updates drawn from the seed, and its last.
With ``--trace 1`` the window also records the host time of each call
(span ``call.update``), and ``trace_units`` further updates run under the
profiler.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchmark import harness, timing, trace


def run(ctx: harness.Context) -> harness.Outcome:
    prog, dev, conf, tr = ctx.program, ctx.device, ctx.config, ctx.traffic
    pose = harness.start_pose(ctx.course, ctx.reference.num_states(conf), ctx.rng,
                              tr["pose_sigma"])
    poses = pose[None]
    path = prog.path(ctx.course)
    state = torch.from_numpy(pose).to(dev)
    dt = torch.full((), conf["dt"], dtype=torch.float32, device=dev)
    step = prog.update_step()

    def answer(n, ctrl, prev, out):
        return harness.Answer(n, ctrl.u_prev[None], prev[None], ctrl.step, ctrl.key,
                              out[None], poses)

    ctrl = prog.initial(ctx.seed)
    nxt, out = step(ctrl, state, path, dt)
    answers = [answer(0, ctrl, torch.zeros_like(out), out)]
    ctrl, prev, n = nxt, out, 1
    for _ in range(tr["warmup_units"]):
        ctrl, prev = step(ctrl, state, path, dt)
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
        t0 = time.perf_counter()
        if t0 >= end and count:
            break
        ctrl_in = ctrl
        ctrl, out = step(ctrl_in, state, path, dt)
        if ctx.trace:
            spans.append(time.perf_counter() - t0)
        last = (n, ctrl_in, prev, out)
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
            nonlocal ctrl
            for _ in range(tr["trace_units"]):
                with record_function(harness.MARK):
                    ctrl, _ = step(ctrl, state, path, dt)
        events = trace.traced(window, dev)
        if events is not None:
            traces["update"] = trace.breakdown(events, harness.MARK)
            units["update"] = trace.unit_ops(events, harness.MARK)
    k, t = conf["num_samples"], conf["horizon"]
    return harness.Outcome(
        metrics={"propagations_per_s": k * (t - 1) * count / seconds},
        attempted=count, setup_end=setup_end, answers=answers, memory_peak=peak,
        spans={"call.update": spans} if ctx.trace else {}, traces=traces, units=units)
