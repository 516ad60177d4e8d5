"""CUDA-graph replay of device functions that read nothing back to the host:
the port's counterpart of ``jax.jit`` and, with :meth:`Graphed.scan`, of
``lax.scan``.

A function made of tens or hundreds of small tensor ops is bound by the host
that enqueues them, not by the card: a kernel-lean control update is about 40
launches around a 0.03-0.16 ms kernel, which the host takes 0.6-1.2 ms to
enqueue, and the refine stage of ``mppi_step`` is about 1700 launches. Here
such a function is captured once per argument structure as a CUDA graph and
replayed after that: a call is one grouped copy of its tensor arguments
(those changed since the last call, :class:`Graphed`) into the graph's own
input buffers, one replay and one grouped copy of the outputs.

:class:`Graphed` owns its graphs, one per argument structure, so that two
compiled functions of one process (a ``ControlLoop``, a loop, a fleet, the
refine stage) never evict each other. :meth:`Graphed.scan` keeps a carry in
the graph's own buffers between replays, as ``lax.scan`` carries its state.

The arguments are split into tensors and a template (:func:`split_tensors`).
Everything that is not a tensor (numbers, None, strings, the fields of a
frozen config) is fixed at capture and part of the cache key, with each
tensor's shape, dtype and device; tensors are inputs. So a value that varies
between calls must reach the function as a tensor.

The first call of a structure runs the function eagerly, on a side stream
(which creates the libraries' handles and workspaces before the capture),
and returns that result; it then captures the function on the same stream,
which launches nothing. Replays run on the caller's current stream. A launch
counter registered with :func:`count_launches` counts a captured launch once
a replay: the capture's own increments are undone.

The function must be free of host syncs: its first run is made under
torch's sync debug mode "error", so a host sync (``.item()``, a Python branch
on a tensor, a data-dependent shape) raises there, before any capture, with
its site in the traceback (:func:`refuse_host_syncs`); no call then runs op
by op in the graph's place. Under a capture already in progress, or inside
a graphed function's first run or capture, a graphed function runs inline,
so the outer graph holds it.

A graph may hold the collectives of a ``torch.distributed`` group whose
backend is NCCL (:func:`collectives_capturable`; the group is a constant of
the cache key, by identity): the sample-sharded step, loop and fits. Their
communicator exists before the capture (parallel/multihost.py makes it with
the group). The capture keeps torch's default mode, "global": the events
that ProcessGroupNCCL's watchdog thread queries while a capture runs do not
invalidate it (chip_smoke.py phase 34 holds a capture open after eager
collectives to check this). Such a graph must not outlive its group:
:func:`forget_group_graphs` drops the graphs that hold a group
(``parallel.multihost.shutdown_multihost`` calls it before it destroys the
group, and so does the interpreter's exit), and the replay of a graph whose
group was destroyed raises.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import threading
import weakref
from collections import OrderedDict
from typing import Optional

import torch
import torch.distributed as dist

# Functions whose ``launches`` attribute counts their kernel's launches.
_COUNTED = []

_LOCAL = threading.local()


def count_launches(fn):
    """Register ``fn``, whose ``launches`` attribute counts its kernel's
    launches: a graph adds the launches it captured from ``fn`` to it at
    every replay."""
    _COUNTED.append(fn)
    return fn


@contextlib.contextmanager
def _tracing():
    """Inside a graphed function's first run and capture."""
    _LOCAL.tracing = getattr(_LOCAL, "tracing", 0) + 1
    try:
        yield
    finally:
        _LOCAL.tracing -= 1


def _inline() -> bool:
    """Whether a graphed function runs inline here: under a capture in
    progress, or inside another graphed function's first run or capture."""
    return bool(getattr(_LOCAL, "tracing", 0)) or torch.cuda.is_current_stream_capturing()


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Where the i-th tensor argument goes when the arguments are rebuilt."""

    index: int


# dataclass -> the names of its fields
_FIELDS: dict = {}


def _field_names(cls):
    names = _FIELDS.get(cls)
    if names is None:
        names = _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls))
    return names


def _flatten(obj, leaves: list):
    """The key of ``obj`` (see :func:`split_tensors`), its tensors appended
    to ``leaves``: the walk every call makes, which builds no template."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    cls = type(obj)
    if cls is tuple or cls is list:
        return (cls, tuple(_flatten(o, leaves) for o in obj))
    if cls is dict:
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    if hasattr(cls, "__dataclass_fields__"):
        return (cls, tuple((n, _flatten(getattr(obj, n), leaves)) for n in _field_names(cls)))
    return ("const", obj)


def _template(obj, count: list):
    """``obj`` with its tensors replaced by slots numbered from count[0]."""
    if isinstance(obj, torch.Tensor):
        count[0] += 1
        return _Slot(count[0] - 1)
    cls = type(obj)
    if cls is tuple or cls is list:
        return cls(_template(o, count) for o in obj)
    if cls is dict:
        return {k: _template(v, count) for k, v in obj.items()}
    if hasattr(cls, "__dataclass_fields__"):
        return dataclasses.replace(obj, **{n: _template(getattr(obj, n), count)
                                           for n in _field_names(cls)})
    return obj


def split_tensors(obj, leaves: list):
    """``obj`` (a tensor, a dataclass, a dict, a tuple or list of them, or a
    constant) with each tensor replaced by a :class:`_Slot` and appended to
    ``leaves``. Returns (template, key): the key describes the structure,
    the constants and each tensor's shape, dtype and device, and is
    hashable."""
    count = [len(leaves)]
    key = _flatten(obj, leaves)
    return _template(obj, count), key


def fill_tensors(template, tensors):
    """The inverse of :func:`split_tensors`: ``template`` with each slot
    replaced by its tensor."""
    cls = type(template)
    if cls is _Slot:
        return tensors[template.index]
    if cls is tuple or cls is list:
        return cls(fill_tensors(t, tensors) for t in template)
    if cls is dict:
        return {k: fill_tensors(v, tensors) for k, v in template.items()}
    if hasattr(cls, "__dataclass_fields__"):
        return dataclasses.replace(template, **{
            n: fill_tensors(getattr(template, n), tensors) for n in _field_names(cls)})
    return template


def refusal(leaves) -> Optional[str]:
    """Why tensors ``leaves`` cannot be a graph's inputs, or None: they must
    lie on one CUDA device and require no gradient (a replay records no
    autograd graph)."""
    devices = {t.device for t in leaves}
    if not devices:
        return "no tensor among the arguments"
    if any(t.requires_grad for t in leaves):
        return "a tensor requires grad: a replay records no autograd graph"
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        return f"tensors on {sorted(map(str, devices))}: a CUDA graph needs one CUDA device"
    return None


def collectives_capturable(group) -> bool:
    """Whether a CUDA graph can hold the collectives of ``group``, a
    ``torch.distributed`` process group: yes where NCCL serves its CUDA
    tensors (NCCL launches its collectives on the card, and torch captures
    them); no for gloo, whose collectives copy through the host, and for no
    group (None)."""
    if group is None:
        return False
    backend = str(dist.get_backend(group)).lower()
    return backend == "nccl" or "cuda:nccl" in backend


def _groups_in(key) -> tuple:
    """The process groups among the constants of a cache key."""
    if isinstance(key, dist.ProcessGroup):
        return (key,)
    if isinstance(key, tuple):
        return tuple(g for part in key for g in _groups_in(part))
    return ()


def _destroyed(group) -> bool:
    """Whether ``group`` was destroyed (torch no longer knows it)."""
    try:
        dist.get_backend(group)
    except (ValueError, RuntimeError):
        return True
    return False


def capturable(args: tuple) -> bool:
    """Whether a :class:`Graphed` call would capture or replay ``args``:
    :func:`refusal` finds nothing, and no capture is in progress (a nested
    one runs inline)."""
    return refusal(_leaves(args)) is None and not _inline()


# torch's message at a host sync in sync debug mode "error"
SYNC_ERROR = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def refuse_host_syncs(what: str):
    """Run the block with torch's sync debug mode at "error" (the mode it
    had is restored after), and turn a host sync inside it into a
    ValueError that names ``what`` and why a CUDA graph cannot hold it: the
    refusal of a function that reads the card back to the host, such as a
    user-registered model whose step or cost calls ``.item()``. Any other
    error passes unchanged."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        if SYNC_ERROR not in str(e):
            raise
        raise ValueError(f"no CUDA graph of {what}: it reads the card back to the host "
                         f"({e}), which a graph cannot replay; remove the read (keep the "
                         "value a tensor, branch with torch.where), or call the function "
                         "op by op") from e
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _clone_all(tensors):
    """Copies of ``tensors`` (a tensor that appears twice is copied once)."""
    copies = {}
    for t in tensors:
        if id(t) not in copies:
            copies[id(t)] = t.clone()
    return [copies[id(t)] for t in tensors]


class _Graph:
    """One captured call: the first run's result, the static input buffers,
    the graph and its outputs. ``carry``: the first argument is a carry that
    the function returns first; the graph ends by copying it into its own
    input buffers, so that the next replay continues from it."""

    def __init__(self, fn, template, leaves, carry=False, groups=()):
        self.groups = groups
        # plain tensors even under inference mode: a later call outside it
        # writes them
        with torch.inference_mode(False):
            self.inputs = [t.clone() for t in leaves]
        self._loaded = _marks(leaves)
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with _tracing(), torch.cuda.stream(side):
            with refuse_host_syncs(getattr(fn, "__qualname__", repr(fn))):
                first = fn(*fill_tensors(template, leaves))
            before = [f.launches for f in _COUNTED]
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin()
            try:
                args = fill_tensors(template, self.inputs)
                output = fn(*args)
                if carry:
                    self.carry = self._carry_buffers(args[0], output[0])
                    torch._foreach_copy_(self.carry, _leaves(output[0]))
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            finally:
                self.captured = [f.launches - b for f, b in zip(_COUNTED, before)]
                for f, b in zip(_COUNTED, before):
                    f.launches = b
            self.graph.capture_end()
        current.wait_stream(side)
        for t in _leaves(first):
            t.record_stream(current)
        self.first = first
        self.outputs = []
        self.out_template, _ = split_tensors(output, self.outputs)

    def _carry_buffers(self, carry_in, carry_out):
        """The input buffers of the carry, checked against the carry out:
        tensors of the same shapes and dtypes, in the same order (the
        constants may differ: a replay does not read them)."""
        buffers = _leaves(carry_in)
        spec_in = [(t.shape, t.dtype) for t in buffers]
        spec_out = [(t.shape, t.dtype) for t in _leaves(carry_out)]
        if spec_in != spec_out:
            raise ValueError("a scanned function must return a carry of the tensors "
                             f"it takes: {spec_out} for {spec_in}")
        return buffers

    def forget(self, count: int):
        """The first ``count`` buffers (a scan's carry) hold what the graph
        wrote: load them anew at the next call."""
        self._loaded[:count] = [(None, None)] * count

    def replay(self):
        if any(_destroyed(g) for g in self.groups):
            raise RuntimeError("this CUDA graph holds the collectives of a process group "
                               "that was destroyed; forget such graphs before the group "
                               "goes (utils/cuda_graph.py forget_group_graphs)")
        self.graph.replay()
        for f, n in zip(_COUNTED, self.captured):
            f.launches += n

    def load(self, leaves):
        """Copy ``leaves`` into the input buffers, in one grouped copy, but
        for each tensor whose buffer already holds it (:func:`stale`)."""
        changed = stale(leaves, self._loaded)
        if changed:
            torch._foreach_copy_([self.inputs[i] for i in changed],
                                 [leaves[i] for i in changed])
        self._loaded = _marks(leaves)

    def __call__(self, leaves):
        self.load(leaves)
        self.replay()
        return fill_tensors(self.out_template, _clone_all(self.outputs))


def _leaves(obj):
    out = []
    _flatten(obj, out)
    return out


def _marks(leaves):
    """(tensor, version counter) of each of ``leaves``; None for an
    inference tensor, which has no version counter."""
    return [(t, None if t.is_inference() else t._version) for t in leaves]


def stale(leaves, marks) -> list:
    """The indices of ``leaves`` to copy into the buffers last loaded from
    the tensors of ``marks`` (:func:`_marks`): every one but the tensor
    objects of the last load whose version counter has not moved since, so
    that no torch in-place op has written them. An inference tensor has no
    counter and is always copied."""
    return [i for i, (t, (last, version)) in enumerate(zip(leaves, marks))
            if t is not last or version is None or t._version != version]


class Graphed:
    """``fn`` compiled: each call with CUDA tensors runs as a replay of the
    CUDA graph of its argument structure (:func:`split_tensors`), captured on
    the first call of that structure, which returns the eager run's result.

    The graphs belong to this object (``max_graphs``: keep at most that
    many, least recently used dropped first; None keeps every one);
    :attr:`captures` counts the captures made. A call that cannot be
    captured raises and says why (:func:`refusal`): CPU tensors, tensors of
    two devices, a tensor that requires grad; so does a first run that makes
    a host sync (:func:`refuse_host_syncs`), and a capture that fails.

    A call copies into the graph's buffers only the tensors that changed
    since the last call (:func:`stale`): another tensor object, or the same
    one written by a torch in-place op (``p.fill_(v)``, ``p.copy_(q)``,
    ``p += d``), which moves its version counter. A write that torch does
    not count, through ``p.data`` or through a raw pointer (ctypes, DLPack),
    is not seen: change an argument through torch ops or pass a new tensor.
    Inference tensors have no counter and are copied at every call.
    """

    def __init__(self, fn, max_graphs: Optional[int] = None):
        self.fn = fn
        self.max_graphs = max_graphs
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.captures = 0
        _GRAPHED.add(self)

    def cache_key(self, *args):
        """The key of the graph that ``args`` replay."""
        return _flatten(args, [])

    def _graph(self, args, carry):
        """(graph, leaves, first): the graph of ``args``' structure, and the
        first run's result where this call captured it (else None); (None,
        leaves, None) where the call runs inline (:func:`_inline`)."""
        leaves = []
        key = _flatten(args, leaves)
        why = refusal(leaves)
        if why is not None:
            raise ValueError(f"no CUDA graph of this call: {why}")
        if _inline():
            return None, leaves, None
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            return graph, leaves, None
        with torch.cuda.device(leaves[0].device):
            graph = _Graph(self.fn, _template(args, [0]), leaves, carry, _groups_in(key))
        self.graphs[key] = graph
        self.captures += 1
        if self.max_graphs is not None and len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)
        first, graph.first = graph.first, None
        return graph, leaves, first

    def __call__(self, *args):
        graph, leaves, first = self._graph(args, carry=False)
        if graph is None:
            return self.fn(*args)
        return first if first is not None else graph(leaves)

    def scan(self, carry, *args, length: int):
        """``lax.scan`` of ``fn(carry, *args) -> (carry, y)`` over ``length``
        steps: (the last carry, the ys stacked along a new leading axis).
        The carry stays in the graph's buffers from one replay to the next;
        each step's y is copied into the stacked outputs in one grouped copy.
        :func:`scan` is the same loop run eagerly."""
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        graph, leaves, first = self._graph((carry,) + args, carry=True)
        if graph is None:
            return scan(self.fn, carry, *args, length=length)
        y_template, y_leaves = _y_parts(graph)
        ys = [torch.empty((length,) + tuple(t.shape), dtype=t.dtype, device=t.device)
              for t in y_leaves]
        start = 0
        if first is not None:
            carry1, y1 = first
            torch._foreach_copy_(graph.carry, _leaves(carry1))
            torch._foreach_copy_([y[0] for y in ys], _leaves(y1))
            start = 1
        else:
            graph.load(leaves)
        graph.forget(len(_leaves(carry)))
        for i in range(start, length):
            graph.replay()
            torch._foreach_copy_([y[i] for y in ys], y_leaves)
        carry_out = fill_tensors(graph.out_template[0], _clone_all(graph.outputs))
        return carry_out, fill_tensors(y_template, ys)


# every Graphed of the process, for forget_group_graphs
_GRAPHED = weakref.WeakSet()


def forget_group_graphs(group=None) -> int:
    """Drop, from every :class:`Graphed`, the graphs that hold the
    collectives of ``group`` (None: of any group), and return how many.
    Call it before the group is destroyed: a graph holds the group's NCCL
    communicator, which must outlive it."""
    dropped = 0
    for graphed in list(_GRAPHED):
        for key in [k for k, g in graphed.graphs.items()
                    if any(group is None or x is group for x in g.groups)]:
            del graphed.graphs[key]
            dropped += 1
    return dropped


# at exit, before torch's process groups go with the interpreter
atexit.register(forget_group_graphs)


def _y_parts(graph):
    """(template of y with slots over its own leaves, the graph's y output
    tensors)."""
    y = fill_tensors(graph.out_template[1], graph.outputs)
    return _template(y, [0]), _leaves(y)


def scan(fn, carry, *args, length: int):
    """``fn(carry, *args) -> (carry, y)`` run ``length`` times eagerly:
    (the last carry, the ys stacked along a new leading axis)."""
    if length < 1:
        raise ValueError(f"length must be >= 1, got {length}")
    ys = []
    for _ in range(length):
        carry, y = fn(carry, *args)
        ys.append(y)
    return carry, stack(ys)


def stack(trees):
    """Trees of one structure stacked leaf by leaf along a new leading axis."""
    template, leaves = _template(trees[0], [0]), _leaves(trees[0])
    columns = [[] for _ in leaves]
    for tree in trees:
        for col, t in zip(columns, _leaves(tree)):
            col.append(t)
    return fill_tensors(template, [torch.stack(col) for col in columns])
