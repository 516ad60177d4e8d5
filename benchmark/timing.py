"""Clocks of the measured window.

:func:`percentile` is the nearest-rank arithmetic of ``bench_torch/timing.py
summary`` (PR 8), frozen here; the cells fix their percentile (the 95th)
rather than take the highest with ten samples beyond it.

:class:`DeviceWindow` is ``bench_torch/timing.py Chain``'s clock: CUDA events
around a chain of calls, the last one waited for by a synchronize, so its
length is all the device time of all the work enqueued in it. On the CPU (the
tests) it reads the host clock, which is no device time.
"""

from __future__ import annotations

import gc
import time

import torch

def percentile(samples, p: float):
    """The nearest-rank ``p`` th percentile of ``samples``: the smallest
    sample with p % of them at or below it."""
    xs = sorted(samples)
    rank = max(1, -(-int(round(p * len(xs))) // 100))
    return xs[rank - 1]


class DeviceWindow:
    """Seconds from :meth:`start` to :meth:`stop` on the device's clock: an
    event recorded before the first call and one after the last, waited for."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def start(self):
        if self.cuda:
            self.events[0].record()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.events[1].record()
            self.events[1].synchronize()
            return self.events[0].elapsed_time(self.events[1]) / 1e3
        return time.perf_counter() - self.t0


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def settle(device):
    """The end of set-up: the device idle, and the objects set-up made
    collected once and moved out of the collector's generations, so that no
    collection of them falls into the window."""
    sync(device)
    gc.collect()
    gc.freeze()
