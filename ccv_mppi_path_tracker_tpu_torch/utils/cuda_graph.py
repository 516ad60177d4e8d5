"""CUDA-graph replay of a device function that reads nothing back to the host.

A function made of hundreds of small tensor ops is bound by the host that
issues them, not by the card: the refine stage of ``mppi_step`` is about
1700 launches and 3 ms of device work, which an eager call takes 50-100 ms
to enqueue. :func:`graphed_call` captures such a function once per shape
and option set as a CUDA graph and replays it after that: a call is one
grouped copy of its inputs into the graph's own buffers, one replay and
one copy of the output.

The function must be free of host syncs (a capture fails on one) and its
output one tensor. Everything that is not a tensor among the arguments
(numbers, None, the fields of a frozen config) is fixed at capture and
part of the cache key, with each tensor's shape, dtype and device.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

# Captured graphs kept at once (least recently used dropped first): one per
# refine configuration a process runs.
MAX_GRAPHS = 16

_GRAPHS: "OrderedDict[tuple, _Graph]" = OrderedDict()


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Where the i-th tensor argument goes when the arguments are rebuilt."""

    index: int


def split_tensors(obj, leaves: list):
    """``obj`` (a tensor, a dataclass, a tuple or list of them, or a
    constant) with each tensor replaced by a :class:`_Slot` and appended to
    ``leaves``. Returns (template, key): the key describes the structure,
    the constants and each tensor's shape, dtype and device, and is
    hashable."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _Slot(len(leaves) - 1), ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields, keys = {}, []
        for f in dataclasses.fields(obj):
            fields[f.name], key = split_tensors(getattr(obj, f.name), leaves)
            keys.append((f.name, key))
        return dataclasses.replace(obj, **fields), (type(obj), tuple(keys))
    if isinstance(obj, (tuple, list)):
        parts = [split_tensors(o, leaves) for o in obj]
        return type(obj)(p[0] for p in parts), (type(obj), tuple(p[1] for p in parts))
    return obj, ("const", obj)


def fill_tensors(template, tensors):
    """The inverse of :func:`split_tensors`: ``template`` with each slot
    replaced by its tensor."""
    if isinstance(template, _Slot):
        return tensors[template.index]
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: fill_tensors(getattr(template, f.name), tensors)
            for f in dataclasses.fields(template)})
    if isinstance(template, (tuple, list)):
        return type(template)(fill_tensors(t, tensors) for t in template)
    return template


class _Graph:
    """One captured call: static input buffers, the graph, its output."""

    def __init__(self, fn, template, leaves):
        self.inputs = [t.detach().clone() for t in leaves]
        args = fill_tensors(template, self.inputs)
        # one eager run on a side stream first, so that the libraries'
        # handles and workspaces (cuBLAS, cuSOLVER) exist before the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.output = fn(*args)

    def __call__(self, leaves):
        torch._foreach_copy_(self.inputs, leaves)
        self.graph.replay()
        return self.output.clone()


def capturable(args: tuple) -> bool:
    """Whether :func:`graphed_call` takes ``args``: every tensor among them
    on one CUDA device, none requiring a gradient (a replay records no
    autograd graph), and no capture of the caller's own in progress."""
    leaves = []
    split_tensors(args, leaves)
    devices = {t.device for t in leaves}
    return (len(devices) == 1 and next(iter(devices)).type == "cuda"
            and not any(t.requires_grad for t in leaves)
            and not torch.cuda.is_current_stream_capturing())


def graphed_call(key, fn, args: tuple):
    """``fn(*args)`` on the card, run as a replay of its CUDA graph.

    ``key`` names ``fn`` and whatever it closes over (hashable). The graph
    is captured on the first call for ``key`` and the arguments' structure,
    which synchronizes the device once; replays read nothing back to the
    host. ``args`` must be :func:`capturable`."""
    if not capturable(args):
        raise ValueError("graphed_call needs tensors of one CUDA device that require no grad")
    leaves = []
    template, arg_key = split_tensors(args, leaves)
    full_key = (key, arg_key)
    graph = _GRAPHS.get(full_key)
    with torch.cuda.device(leaves[0].device):
        if graph is None:
            graph = _GRAPHS[full_key] = _Graph(fn, template, leaves)
            if len(_GRAPHS) > MAX_GRAPHS:
                _GRAPHS.popitem(last=False)
        _GRAPHS.move_to_end(full_key)
        return graph(leaves)
