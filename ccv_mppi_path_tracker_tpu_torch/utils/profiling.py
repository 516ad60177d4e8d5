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
- A device counter (:func:`count_on_device`) is a 0-d int64 tensor on a
  device, one a name and device, allocated once and added to in place, so
  that a CUDA graph captured around the addition keeps adding to the same
  memory at every replay, where no host code runs. The counters added to at
  one site are the elements of one tensor, so that one launch adds to them
  all; a kernel may add to that tensor itself (:func:`device_group`). Adding
  reads nothing back; :func:`counters` reads each device's
  counters once, and :func:`reset` zeroes them in place.
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
# (names, device) -> an int64 tensor of one counter a name; (value, dtype,
# device) -> a constant
_DEVICE_COUNTERS: dict = {}
_DEVICE_CONSTANTS: dict = {}


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


def device_counting(*tensors) -> bool:
    """Whether device counters may be added to here: no ``torch.func``
    transform is active, nothing is being compiled or exported, and none of
    ``tensors`` requires grad (the counters stay out of autograd's graph)."""
    return (torch._C._functorch.maybe_current_level() is None
            and not torch.compiler.is_compiling()
            and not any(t.requires_grad for t in tensors))


def _made_once(table: dict, key, make):
    """``table[key]``, made by ``make()`` where it is missing; None where it
    is missing under a CUDA graph's capture, which would allocate it from the
    graph's pool and capture its fill into every replay."""
    t = table.get(key)
    if t is None:
        if key[-1].type == "cuda" and torch.cuda.is_current_stream_capturing():
            return None
        # a plain tensor even under inference mode: a later call outside it adds
        with torch.inference_mode(False):
            t = table[key] = make()
    return t


def device_constant(value, dtype, device):
    """A 0-d tensor holding ``value`` on ``device``, made once (None where it
    would first be made under a capture)."""
    device = torch.device(device)
    return _made_once(_DEVICE_CONSTANTS, (value, dtype, device),
                      lambda: torch.full((), value, dtype=dtype, device=device))


def device_group(names: tuple, device):
    """The int64 tensor of the device counters ``names`` on ``device``, one
    element a name, made once as zeros, for a kernel that adds to it in place;
    None where it would first be made under a capture (a graph's first run,
    outside the capture, makes it)."""
    device = torch.device(device)
    return _made_once(_DEVICE_COUNTERS, (tuple(names), device),
                      lambda: torch.zeros(len(names), dtype=torch.int64, device=device))


def count_on_device(names: tuple, increments) -> bool:
    """Add ``increments``, a (len(names),) tensor of whole numbers on one
    device, to the device counters ``names`` there, in one launch: the
    counters of one tuple of names are the elements of one int64 tensor, each
    name's counter a 0-d view of it. Under a CUDA graph's capture the add is
    captured and a replay makes it again. Counts nothing, and returns False,
    where the counters would first be made under a capture (a graph's first
    run, outside the capture, makes them)."""
    group = device_group(names, increments.device)
    if group is None:
        return False
    group.add_(increments)
    return True


def _summary(table: dict) -> dict:
    return {name: {"count": c, "total_s": ns / 1e9} for name, (c, ns) in table.items()}


def spans() -> dict:
    """{name: {"count", "total_s"}} of every span recorded since :func:`reset`."""
    return _summary(_SPANS)


def counters() -> dict:
    """{name: total} of every counter since :func:`reset`: the host's, and
    each device counter that is not 0 added to its name's, read with one
    copy a device at this call."""
    out = dict(_COUNTERS)
    by_device: dict = {}
    for (names, device), group in _DEVICE_COUNTERS.items():
        by_device.setdefault(device, []).append((names, group))
    for groups in by_device.values():
        values = torch.cat([g for _, g in groups]).tolist()
        for name, v in zip([n for names, _ in groups for n in names], values):
            if v:
                out[name] = out.get(name, 0) + v
    return out


def reset():
    """Empty the spans and the counters; the device counters are zeroed in
    place, so that a captured graph keeps adding to them."""
    _SPANS.clear()
    _COUNTERS.clear()
    for t in _DEVICE_COUNTERS.values():
        t.zero_()


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


# Small device ops that the profiler's discarded warm-up cycle runs (device_profile).
WARMUP_OPS = 64


@contextlib.contextmanager
def device_profile():
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    where a card is present), whose window opens after a warm-up cycle that
    it discards: a profiler started in a process that ran others before
    loses the first device records after its start (on an H100, the first
    5 to ~26 kernels: a CUDA graph's first replay then shows fewer kernels
    than it ran). So WARMUP_OPS small device ops, waited for, run first and
    are left out. Yields the profiler; after the block its ``events()`` and
    ``key_averages()`` hold the block's activity."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    warm_first = torch.profiler.schedule(wait=0, warmup=1, active=1)
    with torch.profiler.profile(activities=activities, schedule=warm_first) as prof:
        if cuda:
            x = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_OPS):
                x.add_(1.0)
            torch.cuda.synchronize()
        prof.step()
        yield prof


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with :func:`device_profile` and write it as a Chrome
    trace, ``log_dir/trace.json`` (open in Perfetto or chrome://tracing).
    Yields the profiler; its ``key_averages()`` summarizes the trace."""
    os.makedirs(log_dir, exist_ok=True)
    with device_profile() as prof:
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
