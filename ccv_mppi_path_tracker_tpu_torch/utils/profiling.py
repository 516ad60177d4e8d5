"""Tracing and profiling (port of ``utils/profiling.py``).

The reference's only observability is std::cout dt prints
(src/steering_diff_drive_mppi.cpp:382). Here: a ``torch.profiler`` trace of
control cycles (host and CUDA activity, written as a Chrome trace), and one
process-wide registry of spans and counters that the program records into.

- A span is a named block of host time on ``time.perf_counter_ns``: the
  registry keeps, per name, how many ran and their total (:func:`spans`).
  While a ``torch.profiler`` runs, a span is also a range of the same name,
  so it sits in the profiler's Chrome trace on the device trace's clock.
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
  and record always, as do :class:`PhaseTimer`'s phases. A span's range is
  torch's fast range (``_RecordFunctionFast``, a ``cpu_op`` of the trace,
  ~1 us on the CPU, where ``record_function`` takes ~9 us).
- A stage (:class:`stage`) marks a block of the control step (solver/mppi.py
  ``mppi_step``: prologue, draw, samples, rollout_cost, average, refine,
  finish). Op by op it is the span ``stage.<name>`` while a profiler runs;
  under the capture of a CUDA graph (utils/cuda_graph.py) it records which of
  the graph's device nodes the block captured, into the capture's
  :class:`StageTable` (:func:`stage_tables`), read through libcuda; a
  replay runs no host code, and its device operations fall into stages by
  their place in the graph.

``cli profile`` prints the registry; the benchmark's readers
(``benchmark/metrics/``) read it after a traced window.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time
from typing import NamedTuple, Optional

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
    """``with span(name): ...`` records the block as a span ``name``, a range
    of the profiler's trace too while a profiler runs (torch's fast range,
    a ``cpu_op``; ``ranged``: whether one does, where the caller already asked
    :func:`tracing`). The time includes the range's own cost, so that spans
    laid end to end cover their caller. ``table``: a second table that the
    span is added to (:class:`PhaseTimer`'s own)."""

    __slots__ = ("name", "ranged", "table", "range", "t0")

    def __init__(self, name: str, ranged=None, table=None):
        self.name, self.ranged, self.table = name, ranged, table

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        ranged = tracing() if self.ranged is None else self.ranged
        self.range = torch._C._profiler._RecordFunctionFast(self.name) if ranged else None
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


# --- stages -------------------------------------------------------------------------------

class StageTable(NamedTuple):
    """The stages of one captured CUDA graph. ``stages``: (name, first,
    count) in node order, the run of the graph's device nodes that one
    stage block captured (``first`` the index of its first device node; a
    stage may appear twice, as the two-pass elite update's do). ``kinds``:
    one letter a device node, in capture order: K a kernel, C a copy, S a
    set, the nodes a profiler shows as device operations of a replay (event
    and empty nodes are left out). Nodes in no stage are the graph's own."""

    stages: tuple
    kinds: str


# cuGraphNodeType of the device nodes -> their letter in StageTable.kinds
_DEVICE_NODES = {0: "K", 1: "C", 2: "S"}
_CAPTURE_ACTIVE = 1           # CU_STREAM_CAPTURE_STATUS_ACTIVE
# the tables of the process's captures that marked stages, newest last
_TABLES: collections.deque = collections.deque(maxlen=64)
# thread id -> the _Capture in progress on that thread
_CAPTURES: dict = {}
# .name: the stage open on this thread while a profiler runs
_OPEN = threading.local()
# libcuda's graph calls (_LibCuda), None before the first capture, False
# where they cannot be had
_LIBCUDA = None


class _LibCuda:
    """The stream-capture and graph queries of libcuda (the library torch
    already loaded), through ctypes."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        ptr, size, enum = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        # (stream, status*, id*, graph*, dependencies*, count*)
        info = lib.cuStreamGetCaptureInfo_v2
        info.argtypes = [ptr, ctypes.POINTER(enum), ptr, ctypes.POINTER(ptr), ptr, ptr]
        info.restype = enum
        lib.cuGraphGetNodes.argtypes = [ptr, ptr, ctypes.POINTER(size)]
        lib.cuGraphGetNodes.restype = enum
        lib.cuGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(enum)]
        lib.cuGraphNodeGetType.restype = enum
        self.info, self.get_nodes, self.get_type = info, lib.cuGraphGetNodes, lib.cuGraphNodeGetType

    def kinds(self, stream: int, cache: dict) -> Optional[str]:
        """The letters of the device nodes of the graph being captured on
        ``stream``, in libcuda's node order; None where the stream is not
        capturing or a call fails. ``cache``: node -> letter ("" for another
        node), kept by the caller for one capture."""
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        if (self.info(stream, ctypes.byref(status), None, ctypes.byref(graph), None, None)
                or status.value != _CAPTURE_ACTIVE):
            return None
        n = ctypes.c_size_t()
        if self.get_nodes(graph, None, ctypes.byref(n)):
            return None
        if not n.value:
            return ""
        nodes = (ctypes.c_void_p * n.value)()
        if self.get_nodes(graph, nodes, ctypes.byref(n)):
            return None
        kind, letters = ctypes.c_int(), []
        for node in nodes[:n.value]:
            letter = cache.get(node)
            if letter is None:
                if self.get_type(node, ctypes.byref(kind)):
                    return None
                letter = cache[node] = _DEVICE_NODES.get(kind.value, "")
            letters.append(letter)
        return "".join(letters)


def _capture_kinds(stream: int, cache: dict) -> Optional[str]:
    """:meth:`_LibCuda.kinds` of the process's libcuda, loaded at the first
    call; None where it cannot be loaded."""
    global _LIBCUDA
    if _LIBCUDA is None:
        try:
            _LIBCUDA = _LibCuda()
        except (OSError, AttributeError):
            _LIBCUDA = False
    return _LIBCUDA.kinds(stream, cache) if _LIBCUDA else None


class _Capture:
    """The stage marks of one CUDA graph's capture on ``stream``: each mark
    reads the graph's device nodes (:func:`_capture_kinds`) at its entry and
    its exit. ``kinds``: the last read, None once one failed (the capture
    then records nothing); ``table``: the graph's StageTable after
    :func:`capturing_stages`, None where no stage was marked; ``ns``: the
    time the reads took."""

    def __init__(self, stream: int):
        self.stream, self.cache, self.ns = stream, {}, 0
        self.stages, self.open, self.table = [], None, None
        self.kinds = ""
        self.read()

    def read(self) -> int:
        """Read the graph's device nodes anew; their count (0 once a read
        failed)."""
        if self.kinds is not None:
            t0 = time.perf_counter_ns()
            self.kinds = _capture_kinds(self.stream, self.cache)
            self.ns += time.perf_counter_ns() - t0
        return len(self.kinds or "")

    def enter(self, name: str):
        _refuse_nesting(name, self.open[0] if self.open else None)
        self.open = (name, self.read())

    def exit(self, ok: bool):
        (name, first), self.open = self.open, None
        last = self.read()
        if ok and self.kinds is not None:
            self.stages.append((name, first, last - first))

    def finish(self):
        self.read()
        if self.kinds is None:
            return
        if self.stages:
            self.table = StageTable(tuple(self.stages), self.kinds)
            _TABLES.append(self.table)
        record("graphed.stage_reads", self.ns)


def _refuse_nesting(name: str, open_name):
    if open_name is not None:
        raise RuntimeError(f"stage {name!r} opened inside stage {open_name!r}: stages "
                           "do not nest")


@contextlib.contextmanager
def capturing_stages(stream: Optional[int] = None):
    """Around the body of a CUDA graph's capture on ``stream`` (a CUDA
    stream handle; None: this thread's current stream), as utils/cuda_graph.py
    ``_Graph`` captures: the :class:`stage` blocks run inside record the
    device nodes they capture. Yields the :class:`_Capture`, whose ``table``
    is set after a block that ends without an error, and which records the
    span ``graphed.stage_reads``, the reads' time. Where libcuda cannot
    read the graph (no capture on the stream, no libcuda) the stages record
    nothing."""
    if stream is None:
        stream = torch.cuda.current_stream().cuda_stream
    capture = _Capture(stream)
    me = threading.get_ident()
    if capture.kinds is not None:
        _CAPTURES[me] = capture
    try:
        yield capture
    finally:
        _CAPTURES.pop(me, None)
    if capture.kinds is not None:
        capture.finish()


def stage_tables() -> list:
    """The :class:`StageTable` of each of the process's recent captures that
    marked stages, newest last."""
    return list(_TABLES)


class stage:
    """``with stage(name): ...`` marks the block as the control step's stage
    ``name``; no stage opens inside another (RuntimeError). Under the capture
    of a CUDA graph (:func:`capturing_stages`) it records the block's device
    nodes into the graph's table; op by op, while a profiler runs, it is the
    span ``stage.<name>``, and while none runs it costs one :func:`tracing`
    check. A replay of the graph runs none of it."""

    __slots__ = ("name", "capture", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.span = None
        self.capture = _CAPTURES.get(threading.get_ident()) if _CAPTURES else None
        if self.capture is not None:
            self.capture.enter(self.name)
        elif tracing():
            _refuse_nesting(self.name, getattr(_OPEN, "name", None))
            _OPEN.name = self.name
            self.span = span("stage." + self.name, True).__enter__()
        return self

    def __exit__(self, *exc):
        if self.capture is not None:
            self.capture.exit(exc[0] is None)
        elif self.span is not None:
            _OPEN.name = None
            self.span.__exit__(*exc)
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
