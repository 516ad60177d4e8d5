"""Tracing and profiling (port of ``utils/profiling.py``).

The reference's only observability is std::cout dt prints
(src/steering_diff_drive_mppi.cpp:382). Here: a ``torch.profiler`` trace of
control cycles (host and CUDA activity, written as a Chrome trace), and a
per-phase wall-clock timer that waits for the device where asked.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write it as a Chrome trace,
    ``log_dir/trace.json`` (open in Perfetto or chrome://tracing). Yields
    the profiler; its ``key_averages()`` summarizes the trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _wait_for(tensors):
    """Wait until every CUDA tensor among ``tensors`` (a tensor, or a list,
    tuple or dict of them) is computed: its device's current stream is
    synchronized."""
    if isinstance(tensors, torch.Tensor):
        if tensors.is_cuda:
            torch.cuda.current_stream(tensors.device).synchronize()
    elif isinstance(tensors, dict):
        for t in tensors.values():
            _wait_for(t)
    elif isinstance(tensors, (list, tuple)):
        for t in tensors:
            _wait_for(t)


class PhaseTimer:
    """Accumulating wall-clock timer: ``with timer.phase("rollout"): ...``.

    ``phase(name, block_on=tensors)`` waits for ``tensors`` before it stops
    the clock, so asynchronous CUDA launches do not hide device time.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait_for(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }
