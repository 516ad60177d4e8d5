"""Tracing and profiling (port of ``utils/profiling.py``).

The reference's only observability is std::cout dt prints
(src/steering_diff_drive_mppi.cpp:382). Here: a ``torch.profiler`` trace of
control cycles (host and CUDA activity, written as a Chrome trace), and one
process-wide registry of spans and counters that the program records into.

- A span is a named block of host time on ``time.perf_counter_ns``: the
  registry keeps, per name, how many ran and their total (:func:`spans`).
  While a ``torch.profiler`` runs, a span is also a ``record_function``
  range of the same name, so it sits in the profiler's Chrome trace on the
  device trace's clock.
- A counter adds whole numbers under a name (:func:`counters`).
- Hot spans and counters, those of every compiled call
  (utils/cuda_graph.py, solver/mppi.py, solver/batch.py), record only while
  a profiler runs: the call asks :func:`tracing` once at its entry and takes
  its plain path when it is off, so that tracing costs a call that one check.
  Cold spans (a graph's capture, a kernel library's load) run once a process
  and record always, as do :class:`PhaseTimer`'s phases.

``cli profile`` prints the registry; the benchmark's readers
(``benchmark/metrics/``) read it after a traced window.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# Whether a torch.profiler is recording: the one check a compiled call makes
# (bound here, so that a call pays no attribute lookup for it).
tracing = torch.autograd._profiler_enabled

# name -> [count, total nanoseconds]; name -> count
_SPANS: dict = {}
_COUNTERS: dict = {}


def record(name: str, ns: int, count: int = 1, table: dict = _SPANS):
    """Add ``count`` spans of ``ns`` nanoseconds in all under ``name``."""
    entry = table.get(name)
    if entry is None:
        table[name] = [count, ns]
    else:
        entry[0] += count
        entry[1] += ns


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def _summary(table: dict) -> dict:
    return {name: {"count": c, "total_s": ns / 1e9} for name, (c, ns) in table.items()}


def spans() -> dict:
    """{name: {"count", "total_s"}} of every span recorded since :func:`reset`."""
    return _summary(_SPANS)


def counters() -> dict:
    """{name: total} of every counter since :func:`reset`."""
    return dict(_COUNTERS)


def reset():
    """Empty the spans and the counters."""
    _SPANS.clear()
    _COUNTERS.clear()


class span:
    """``with span(name): ...`` records the block as a span ``name``, a
    ``record_function`` range too while a profiler runs (``ranged``: whether
    one does, where the caller already asked :func:`tracing`). The time
    includes the range's own cost, so that spans laid end to end cover their
    caller. ``table``: a second table that the span is added to
    (:class:`PhaseTimer`'s own)."""

    __slots__ = ("name", "ranged", "table", "range", "t0")

    def __init__(self, name: str, ranged=None, table=None):
        self.name, self.ranged, self.table = name, ranged, table

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        ranged = tracing() if self.ranged is None else self.ranged
        self.range = torch.autograd.profiler.record_function(self.name) if ranged else None
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        ns = time.perf_counter_ns() - self.t0
        record(self.name, ns)
        if self.table is not None:
            record(self.name, ns, table=self.table)
        return False


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

    Each phase is a :class:`span` of the registry, which records always,
    and is kept in the timer's own table for :meth:`summary`.
    ``phase(name, block_on=tensors)`` waits for ``tensors`` before it stops
    the clock, so asynchronous CUDA launches do not hide device time.
    """

    def __init__(self):
        self.table: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        with span(name, table=self.table):
            try:
                yield
            finally:
                if block_on is not None:
                    _wait_for(block_on)

    def summary(self) -> dict:
        return {
            name: {
                "total_s": ns / 1e9,
                "count": c,
                "mean_ms": 1e3 * (ns / 1e9) / max(c, 1),
            }
            for name, (c, ns) in self.table.items()
        }
