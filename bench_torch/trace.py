"""The traced run and the ladder: the twin of ``scripts/profile_step.py`` and
``scripts/xla_breakdown.py``.

:func:`traced` runs a steady window of updates (cycles, ticks) under
``torch.profiler`` with CPU and CUDA activity, apart from the timing run,
which stays untraced; :func:`breakdown` reads the window's Chrome trace:

- the device's busy and idle share of the window (from the first update's
  start on the host to the last device activity);
- device launches (kernels, copies, fills) an update;
- the device operations that took the most time, by name;
- the longest idle gaps on the device, each named by the host operation
  that overlapped it the most (``python`` where no recorded operation did:
  the interpreter between torch calls), with the part of the gap that any
  recorded host operation covers (the rest is the interpreter's).

The window is marked by one ``record_function`` range an update, opened by
the harness around its own call into the package (:data:`MARK`); nothing
inside the package is instrumented.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import torch

MARK = "bench_torch.update"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
KERNEL_NAME = "rollout_cost_kernel"


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def breakdown(events, units=None, top=8):
    """Per-update numbers of a window from Chrome-trace ``events`` (dicts
    with "ph", "cat", "name", "ts", "dur" in microseconds). The window holds
    the MARK ranges on the host, one an update unless ``units`` says how
    many updates (cycles) they hold in all."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in complete if e["name"] == MARK and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"no {MARK} range in the trace")
    n = len(marks) if units is None else units
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS]
    host = [e for e in complete if e.get("cat") in HOST_CATS and e["name"] != MARK]
    t0 = min(e["ts"] for e in marks)
    t1 = max([e["ts"] + e["dur"] for e in marks + dev])
    dev = [e for e in dev if e["ts"] + e["dur"] > t0 and e["ts"] < t1]
    busy = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for e in dev:
        name = e["name"]
        cur = by_name.setdefault(name, [0.0, 0])
        cur[0] += e["dur"]
        cur[1] += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    gaps = []
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        best, best_us, spans = "python", 0.0, []
        for e in host:
            lo, hi = max(a, e["ts"]), min(b, e["ts"] + e["dur"])
            if hi > lo:
                spans.append((lo, hi))
                if hi - lo > best_us:
                    best, best_us = e["name"], hi - lo
        named.append({"us": b - a, "at_us": a - t0, "host_op": best,
                      "host_op_overlap_us": best_us,
                      "host_ops_cover_us": sum(y - x for x, y in _merge(spans))})
    window = t1 - t0
    kernel_us = sum(v[0] for k, v in by_name.items() if KERNEL_NAME in k)
    return {
        "updates": n,
        "window_us": window,
        "device_busy_share": busy_us / window if window > 0 else None,
        "device_idle_share": 1.0 - busy_us / window if window > 0 else None,
        "launches_per_update": len(dev) / n,
        "kernel_ms": kernel_us / n / 1e3,
        "kernel_launches_per_update": sum(v[1] for k, v in by_name.items()
                                          if KERNEL_NAME in k) / n,
        "device_ms_per_update": sum(v[0] for v in by_name.values()) / n / 1e3,
        "top_device_ops": [{"name": k, "us_per_update": v[0] / n, "calls_per_update": v[1] / n}
                           for k, v in ops[:top]],
        "longest_idle_gaps": named,
    }


def traced(window, n, device, units=None):
    """Run ``window(mark)`` under torch.profiler: it runs n updates, each
    inside ``with mark():`` (or, with ``units``, ranges that hold ``units``
    updates in all). Returns :func:`breakdown` of the trace, or None on the
    CPU (no device activity to read)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    if device.type != "cuda":
        window(lambda: record_function(MARK))
        return None
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(lambda: record_function(MARK))
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = breakdown(events, units)
    if units is None and out["updates"] != n:
        raise RuntimeError(f"traced {out['updates']} updates, not {n}")
    return out


# --- the ladder -----------------------------------------------------------------

RUNGS = ("full", "lean", "kernel_only", "floor")


def ladder(seed, device, reps=10, length=50, profile_calls=200, top=12):
    """A diagnostic, not a cell: the flagship full_body update's rungs timed
    in turns (CUDA events, and the host's perf_counter around each call):

    - ``full``: ``mppi_step(use_kernel=True, lean=False)``, chained;
    - ``lean``: ``mppi_step(use_kernel=True, lean=True)``, chained;
    - ``kernel_only``: the kernel's wrapper ``fused_sample_rollout_cost`` on
      operands held fixed (the update's reference window and scalars);
    - ``floor``: a trivial chained add, the cost of one launch.

    Each rung's ``ms`` is its chains' time over their calls, ``host_us`` the
    host's mean time a call.

    Then cProfile over ``profile_calls`` calls of the wrapper: the host's
    time in it by function, which says where the wrapper's time goes.
    """
    import cProfile
    import pstats

    from bench_torch import cells, timing
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
        pack_scalars,
    )
    from ccv_mppi_path_tracker_tpu_torch.paths import resample_reference

    cell = cells.CELLS["full_body-K102400-T30"]
    x = cells.inputs(cell, seed, device)
    cfg, sp, cp, state, dt = x["cfg"], x["sp"], x["cp"], x["state"], x["dt"]
    mp = x["model"].default_params(device=device)
    ref = resample_reference(x["path"], state[:2], cp.v_ref, dt, cfg.horizon)
    u0 = torch.zeros((cfg.horizon - 1, x["model"].num_controls), device=device)
    kargs = (u0, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state,
             pack_scalars(dt, cp, ref.yaw[0], mp, sp.noise_beta, sp.lam))
    kw = dict(seed=seed, step=0, num_samples=cfg.num_samples, model=cfg.model,
              steer_off=cfg.steer_off)
    arms = cells._update_arms(dataclasses.replace(cell, arms=("kernel_full", "kernel_lean"),
                                                  chain=length), x, device)
    arms = {"full": arms["kernel_full"], "lean": arms["kernel_lean"],
            "kernel_only": timing.Chain(lambda: None,
                                        lambda c: fused_sample_rollout_cost(*kargs, **kw),
                                        length),
            "floor": timing.Chain(lambda: torch.zeros((), device=device),
                                  lambda c: c + 1.0, length)}
    times = timing.interleaved(arms, reps, device)
    out = {"rungs": {}}
    for name in RUNGS:
        s = timing.summary(times[name])
        host = arms[name].host
        on_card = device.type == "cuda"
        out["rungs"][name] = {
            "ms": s["mean"] if on_card else None,
            "median_ms": s["median"] if on_card else None,
            "host_us": float(sum(host) / len(host)) * 1e6 if host else None,
            "samples": s["n"]}
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(profile_calls):
        fused_sample_rollout_cost(*kargs, **kw)
    prof.disable()
    timing.sync(device)
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    out["wrapper_by_function"] = [
        {"function": f"{fn[0].rsplit('/', 2)[-1]}:{fn[1]}({fn[2]})",
         "tottime_us_per_call": v[2] / profile_calls * 1e6,
         "calls_per_call": v[1] / profile_calls}
        for fn, v in rows]
    out["note"] = ("host_us under cProfile is inflated by the profiler; compare "
                   "functions with each other, and the rungs' host_us for totals")
    return out
