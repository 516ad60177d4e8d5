"""The traced window and its reduction.

:func:`breakdown` is a frozen copy of ``bench_torch/trace.py breakdown``
(PR 8), with the mark's name a parameter: from a Chrome trace of a window of
units (updates, ticks, cycles), each inside one ``record_function`` range the
harness opens around its own call into the program, it gives

- the device's busy and idle share of the window (from the first unit's start
  on the host to the last device activity);
- the fused kernel's device time a unit;
- the device operations that took the most time, by name;
- the longest idle gaps on the device, each named by the host operation that
  overlapped it the most (``python`` where no recorded operation did: the
  interpreter between torch calls).

:func:`inside_marks` adds the busy share inside the units' ranges only, for a
paced loop whose units are apart. :func:`unit_ops` keeps every device
operation of every unit, compactly, for readers that split a unit's device
time their own way. Nothing inside the program is instrumented.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import numpy as np
import torch

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


def _marks(complete, mark):
    return [e for e in complete if e["name"] == mark and e.get("cat") == "user_annotation"]


def breakdown(events, mark, top=10):
    """Per-unit numbers of the window of ``mark`` ranges in the Chrome-trace
    ``events`` (dicts with "ph", "cat", "name", "ts", "dur" in microseconds)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = _marks(complete, mark)
    if not marks:
        raise ValueError(f"no {mark} range in the trace")
    n = len(marks)
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS]
    host = [e for e in complete if e.get("cat") in HOST_CATS and e["name"] != mark]
    t0 = min(e["ts"] for e in marks)
    t1 = max([e["ts"] + e["dur"] for e in marks + dev])
    dev = [e for e in dev if e["ts"] + e["dur"] > t0 and e["ts"] < t1]
    busy = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    gaps = []
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        best, best_us = "python", 0.0
        for e in host:
            lo, hi = max(a, e["ts"]), min(b, e["ts"] + e["dur"])
            if hi - lo > best_us:
                best, best_us = e["name"], hi - lo
        named.append({"us": b - a, "at_us": a - t0, "host_op": best})
    window = t1 - t0
    kernel_us = sum(v for k, v in by_name.items() if KERNEL_NAME in k)
    return {
        "units": n,
        "window_us": window,
        "busy_us": busy_us,
        "device_idle_share": 1.0 - busy_us / window if window > 0 else None,
        "inside_idle_share": inside_marks(marks, busy),
        "kernel_ms": kernel_us / n / 1e3,
        "top_device_ops": [{"name": k, "us": v} for k, v in ops[:top]],
        "longest_idle_gaps": named,
    }


def inside_marks(marks, busy):
    """The idle share of the time inside the ``marks`` ranges (merged busy
    intervals ``busy``): the device's idleness while a unit was open."""
    spans = _merge([(e["ts"], e["ts"] + e["dur"]) for e in marks])
    total = sum(b - a for a, b in spans)
    covered, j = 0.0, 0
    for a, b in spans:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        i = j
        while i < len(busy) and busy[i][0] < b:
            covered += min(b, busy[i][1]) - max(a, busy[i][0])
            i += 1
    return 1.0 - covered / total if total > 0 else None


def unit_ops(events, mark):
    """Every device operation (kernel, copy, set) of each unit of the window
    of ``mark`` ranges in the Chrome-trace ``events``, as arrays:

    - ``names``: the operations' distinct names (a list of str);
    - ``unit_us``: (n,) each unit's range on the host, in microseconds;
    - ``unit``, ``name``: (m,) int32, the unit and the index into ``names``
      of each operation;
    - ``start_us``, ``dur_us``: (m,) float64, its start on the device from
      its unit's start on the host, and its length.

    An operation belongs to the unit inside whose range the host launched
    it (its runtime call, by the trace's ``correlation``; a CUDA graph's
    kernels carry their ``cudaGraphLaunch``'s). One with no launch in the
    trace belongs to the last unit that started before it. The rows are
    sorted by unit, then start."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = sorted(_marks(complete, mark), key=lambda e: e["ts"])
    starts = [e["ts"] for e in marks]
    ends = [e["ts"] + e["dur"] for e in marks]
    launched = {}
    for e in complete:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launched[corr] = e["ts"]
    index, rows = {}, []
    for e in complete:
        if e.get("cat") not in DEVICE_CATS:
            continue
        host = launched.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, e["ts"] if host is None else host) - 1
        if i < 0 or (host is not None and host > ends[i]):
            continue
        rows.append((i, e["ts"] - starts[i], e["dur"], index.setdefault(e["name"], len(index))))
    rows.sort()
    cols = list(zip(*rows)) or [(), (), (), ()]
    return {"names": list(index),
            "unit_us": np.array([e["dur"] for e in marks], dtype=np.float64),
            "unit": np.array(cols[0], dtype=np.int32),
            "name": np.array(cols[3], dtype=np.int32),
            "start_us": np.array(cols[1], dtype=np.float64),
            "dur_us": np.array(cols[2], dtype=np.float64)}


def traced(window, device):
    """Run ``window()`` under torch.profiler (CPU and CUDA activity) and
    return the trace's events; None off the card (nothing to read)."""
    if device.type != "cuda":
        window()
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
