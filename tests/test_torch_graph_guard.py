"""The compiled call's guard, its stale check and its rebuild
(utils/cuda_graph.py ``_guard``, ``_Graph.load``, ``_rebuilder``) on the CPU.

A guard is generated once for a graph's argument structure. It must accept
exactly the arguments whose cache key (``_flatten``) equals the graph's and
whose tensors require no grad, return their tensors in ``_flatten``'s order,
and name the tensors to copy as ``stale`` does. Each check here holds the
guard against that full path, on the arguments of the port's compiled update
and fleet tick and on random nested trees, through in-place and rebinding
mutations. The CPU has no CUDA graph: a call through ``Graphed`` replays the
stand-in of tests/test_torch_tracing.py.
"""

import dataclasses
import math
import random

import pytest
import torch

from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.solver import compile_step, init_fleet
from ccv_mppi_path_tracker_tpu_torch.solver.batch import _tick
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph, _graph_step
from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph, profiling
from test_torch_tracing import cpu_graph


def full_path(args, key):
    """(leaves, accepted) as the full path decides: the key equal to the
    graph's and no tensor that requires grad."""
    leaves = []
    same = cuda_graph._flatten(args, leaves) == key
    return leaves, same and not any(t.requires_grad for t in leaves)


def check(guard, args, key, marks) -> bool:
    """The guard's answer on ``args`` against the full path's; returns
    whether it accepted."""
    leaves, accepted = full_path(args, key)
    hit = guard(args, marks)
    assert (hit is not None) == accepted
    if accepted:
        got, changed = hit
        assert len(got) == len(leaves) and all(a is b for a, b in zip(got, leaves))
        assert changed == cuda_graph.stale(leaves, marks)
    return accepted


# --- the port's own arguments -------------------------------------------------------

TREES = ["diff_drive.lean", "diff_drive.full", "full_body.lean", "full_body.full", "fleet"]


def real_args(tree):
    """The arguments a compiled update (``<preset>.<lean|full>``) or the
    fleet tick hands its ``Graphed``, at a tiny size; full_body's update
    takes its model parameters."""
    preset = "diff_drive" if tree == "fleet" else tree.split(".")[0]
    cfg, sp, cp, course = PRESETS[preset](num_samples=32, horizon=6, device="cpu")
    model = get_model(cfg.model)
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    dt = torch.tensor(0.1)
    pose = torch.zeros(model.num_states)
    if tree == "fleet":
        ctrls = init_fleet(cfg, 3, seed=7, device="cpu")
        return KeyedGraph._inputs(ctrls, path, dt) + (pose.repeat(3, 1), sp, cp, None, None,
                                                      cfg, True)
    step = compile_step(cfg, use_kernel=True, lean=tree.endswith("lean"))
    ctrl = ControllerState.initial(7, 6, model.num_controls, device="cpu")
    mp = model.default_params(device="cpu") if model.default_params else None
    args = step._args(ctrl, pose, path, dt, sp, cp, model_params=mp)
    return step.graph._inputs(*args[:3]) + args[3:]


def _config(args):
    return next(i for i, a in enumerate(args) if type(a).__name__ == "SolverConfig")


def _replace_config(args, **change):
    i = _config(args)
    return args[:i] + (dataclasses.replace(args[i], **change),) + args[i + 1:]


def _none_tensor(args):
    """A tensor argument made None, or a None one a tensor."""
    if isinstance(args[-1], dict):   # the update: its model parameters dropped
        args[-1]["model_params"] = None
        return args
    return args[:6] + (torch.zeros(3),) + args[7:]   # the fleet's model parameters


def _rebind(obj, name, value):
    setattr(obj, name, value)


def _then(_, args):
    return args


# name -> (mutation of the arguments, accepted, the leaves it makes stale)
MUTATIONS = {
    "same": (lambda a: a, True, []),
    "new_tensor_same_shape": (lambda a: _rebind(a[0], "u_prev", a[0].u_prev.clone()) or a,
                              True, [0]),
    "in_place_write": (lambda a: _then(a[4].lam.add_(0.5), a), True, [8]),
    "data_swap_shape": (lambda a: _rebind(a[3], "data", torch.zeros(7)) or a, False, None),
    "data_swap_dtype": (lambda a: _rebind(a[3], "data", a[3].double()) or a, False, None),
    # torch refuses a .data swap between the CPU and another device type,
    # so the other device's tensor takes the pose's place
    "device_type": (lambda a: a[:3] + (a[3].to("meta"),) + a[4:], False, None),
    "requires_grad": (lambda a: _then(a[4].lam.requires_grad_(), a), False, None),
    "solver_params_field": (lambda a: _rebind(a[4], "lam", a[4].lam.clone()) or a, True, [8]),
    "solver_params_field_shape": (lambda a: _rebind(a[4], "lam", torch.ones(2)) or a,
                                  False, None),
    "cost_params_field": (lambda a: _rebind(a[5], "v_ref", 1.0) or a, False, None),
    "path_field": (lambda a: _rebind(a[1], "xy", torch.zeros(a[1].xy.shape[0] + 1, 2)) or a,
                   False, None),
    "config_replaced_same": (lambda a: _replace_config(a), True, []),
    "config_replaced_other": (lambda a: _replace_config(a, num_samples=64), False, None),
    "none_tensor": (_none_tensor, False, None),
    "dict_key_added": (lambda a: a[-1].update(extra=1) or a, False, None),
    "dict_key_renamed": (lambda a: a[:-1] + ({("x" + k if k == "lean" else k): v
                                               for k, v in a[-1].items()},), False, None),
    "dict_reordered": (lambda a: a[:-1] + (dict(reversed(a[-1].items())),), False, None),
    "list_length": (lambda a: a + ([a[2]],), False, None),
    "constant_changed": (lambda a: _rebind(a[0], "seed", 1) or a, False, None),
    "constant_equal_other_type": (lambda a: _rebind(a[0], "seed", 0.0) or a, True, []),
}
APPLIES = {"none_tensor": lambda tree: tree.startswith("full_body") or tree == "fleet",
           "dict_key_added": lambda tree: tree != "fleet",
           "dict_key_renamed": lambda tree: tree != "fleet",
           "dict_reordered": lambda tree: tree != "fleet"}


@pytest.mark.parametrize("tree,mutation", [
    (t, m) for t in TREES for m in MUTATIONS if APPLIES.get(m, lambda _: True)(t)])
def test_guard_on_the_ports_arguments(tree, mutation):
    """The guard of a compiled update's (or the fleet tick's) arguments
    accepts them again, and after each mutation agrees with the full path,
    its stale check with ``stale``."""
    args = real_args(tree)
    leaves = []
    key = cuda_graph._flatten(args, leaves)
    guard = cuda_graph._guard(args)
    marks = cuda_graph._marks(leaves)
    assert check(guard, args, key, marks)
    mutate, accepted, changed = MUTATIONS[mutation]
    args = mutate(args)
    assert check(guard, args, key, marks) is accepted
    if accepted:
        assert guard(args, marks)[1] == changed


@pytest.mark.parametrize("tree", TREES)
def test_folded_stale_check_over_a_sequence(tree):
    """Over a sequence of calls that keep the structure, each loaded as
    ``_Graph.load`` loads it, the guard names the tensors ``stale`` would
    copy: a new tensor, an in-place write, a rebound field, an inference
    tensor (copied at every call), and a scan's carry after ``forget``."""
    args = real_args(tree)
    leaves = []
    key = cuda_graph._flatten(args, leaves)
    guard = cuda_graph._guard(args)
    g = object.__new__(cuda_graph._Graph)
    g.inputs, g._loaded = [t.clone() for t in leaves], cuda_graph._marks(leaves)
    with torch.inference_mode():
        frozen = args[4].lam.clone()
    steps = [lambda: None,
             lambda: _rebind(args[0], "u_prev", args[0].u_prev.clone()),
             lambda: args[0].key.add_(1),
             lambda: _rebind(args[5], "v_ref", args[5].v_ref.clone()),
             lambda: _rebind(args[4], "lam", frozen),
             lambda: None,
             lambda: g.forget(2),
             lambda: None]
    copied = []
    for step in steps:
        step()
        assert check(guard, args, key, g._loaded)
        hit, changed = guard(args, g._loaded)
        want = cuda_graph.stale(hit, g._loaded)
        assert g.load(hit, changed) == len(want)
        assert all(torch.equal(b, t) for b, t in zip(g.inputs, hit))
        assert g._loaded == cuda_graph._marks(hit)
        copied.append(changed)
    assert copied == [[], [0], [1], [12], [8], [8], [0, 1, 8], [8]]


@pytest.mark.parametrize("tree", ["diff_drive.lean", "diff_drive.full", "full_body.lean",
                                  "fleet"])
def test_rebuild_equals_fill_tensors(tree):
    """The generated rebuild gives what ``fill_tensors(template,
    _clone_all(outputs))`` gives: the same structure and constants, fresh
    containers and clones, and a tensor that appears twice cloned once."""
    args = real_args(tree)
    fn = _tick if tree == "fleet" else _graph_step
    outputs = []
    template, key = cuda_graph.split_tensors(fn(*args), outputs)
    rebuild = cuda_graph._rebuilder(template, outputs)
    got, want = rebuild(outputs), cuda_graph.fill_tensors(template,
                                                          cuda_graph._clone_all(outputs))
    got_leaves, want_leaves = [], []
    assert cuda_graph._flatten(got, got_leaves) == cuda_graph._flatten(want, want_leaves) == key
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, want_leaves))
    assert not {id(t) for t in got_leaves} & {id(t) for t in outputs}

    def shared(ts):
        return [[a is b for b in ts] for a in ts]
    assert shared(got_leaves) == shared(want_leaves) == shared(outputs)
    if tree.endswith("lean"):   # the next warm start is the update's u_opt
        assert len({id(t) for t in outputs}) < len(outputs)
    again = []
    cuda_graph._flatten(rebuild(outputs), again)
    assert not {id(t) for t in again} & {id(t) for t in got_leaves}


# --- random trees --------------------------------------------------------------------


@dataclasses.dataclass
class Loose:
    a: object
    b: object = None


@dataclasses.dataclass(frozen=True)
class Fixed:
    a: object
    b: object = None


CONSTANTS = [0, 1, 1.0, True, 0.5, "s", None, math.nan, (), "t"]
SHAPES = [(), (3,), (2, 3), (1,)]


def random_tensor(rng):
    t = torch.full(rng.choice(SHAPES), rng.random(),
                   dtype=rng.choice([torch.float32, torch.float64]))
    return t.long() if rng.random() < 0.2 else t


def random_tree(rng, depth=0):
    r = rng.random()
    if depth >= 3 or r < 0.3:
        return random_tensor(rng) if rng.random() < 0.6 else rng.choice(CONSTANTS)
    items = [random_tree(rng, depth + 1) for _ in range(rng.randrange(4))]
    kind = rng.choice(["tuple", "list", "dict", "loose", "fixed"])
    if kind == "tuple":
        return tuple(items)
    if kind == "list":
        return items
    if kind == "dict":
        return {f"k{i}": v for i, v in enumerate(items)}
    cls = Loose if kind == "loose" else Fixed
    return cls(*items[:2]) if items else cls(None)


def mutate(obj, rng):
    """``obj`` changed somewhere: in place where it can be (a tensor's data,
    version or grad flag, a list, a dict, a loose dataclass's field), else
    a new object. Returns the object that takes its place."""
    if isinstance(obj, torch.Tensor):
        op = rng.randrange(8)
        plain = obj.device.type == "cpu" and not obj.is_inference()
        if op == 0:
            return obj.clone()
        if op == 1 and plain:
            with torch.no_grad():
                obj.add_(1)
            return obj
        if op == 2 and plain and obj.is_floating_point():
            obj.data = torch.zeros(rng.choice(SHAPES), dtype=obj.dtype)
            return obj
        if op == 3 and plain and obj.is_floating_point():
            other = torch.float32 if obj.dtype == torch.float64 else torch.float64
            obj.data = obj.data.to(other)
            return obj
        if op == 4:
            return obj.detach().to("meta")
        if op == 5 and obj.is_leaf and obj.is_floating_point():
            return obj.requires_grad_(not obj.requires_grad)
        if op == 6:
            with torch.inference_mode():
                return obj.clone()
        return rng.choice(CONSTANTS)
    cls = type(obj)
    descend = rng.random() < 0.6
    if cls is list:
        if descend and obj:
            i = rng.randrange(len(obj))
            obj[i] = mutate(obj[i], rng)
        elif rng.random() < 0.5:
            obj.append(random_tree(rng, 2))
        elif obj:
            obj.pop()
        else:
            return tuple(obj)
        return obj
    if cls is tuple:
        if descend and obj:
            i = rng.randrange(len(obj))
            return obj[:i] + (mutate(obj[i], rng),) + obj[i + 1:]
        return list(obj) if rng.random() < 0.5 else obj + (random_tree(rng, 2),)
    if cls is dict:
        if descend and obj:
            k = rng.choice(list(obj))
            obj[k] = mutate(obj[k], rng)
        elif rng.random() < 0.3:
            obj[f"n{len(obj)}"] = random_tree(rng, 2)
        elif rng.random() < 0.3 and obj:
            k = rng.choice(list(obj))
            obj[k + "r"] = obj.pop(k)
        elif rng.random() < 0.5 and obj:
            del obj[rng.choice(list(obj))]
        else:
            return dict(reversed(obj.items()))
        return obj
    if cls in (Loose, Fixed):
        name = rng.choice("ab")
        if descend:
            value = mutate(getattr(obj, name), rng)
            if cls is Loose:
                setattr(obj, name, value)
                return obj
            return dataclasses.replace(obj, **{name: value})
        if rng.random() < 0.5:
            return dataclasses.replace(obj)
        return (Fixed if cls is Loose else Loose)(obj.a, obj.b)
    if rng.random() < 0.3:
        return random_tensor(rng)
    return rng.choice(CONSTANTS)


@pytest.mark.parametrize("seed", range(24))
def test_guard_on_random_trees(seed):
    """Random trees of tuples, lists, dicts, dataclasses (frozen and not),
    constants (some equal across types: 1, 1.0, True) and tensors, mutated
    call after call: the guard agrees with the full path at every call, its
    stale check with ``stale`` (the marks loaded as a replay loads them, a
    scan's carry forgotten now and then)."""
    rng = random.Random(seed)

    def fresh():
        return (random_tree(random.Random(seed)), random_tree(random.Random(seed + 100)),
                torch.zeros(2))

    base = fresh()
    leaves = []
    key = cuda_graph._flatten(base, leaves)
    guard = cuda_graph._guard(base)
    marks = cuda_graph._marks(leaves)
    args, outcomes = base, []
    for _ in range(60):
        r = rng.random()
        if r < 0.15:
            args = fresh()
        elif r < 0.25:
            k = rng.randrange(len(marks) + 1)
            marks[:k] = [(None, None)] * k
        elif r > 0.4:
            args = mutate(args, rng)
        accepted = check(guard, args, key, marks)
        if accepted:
            marks = cuda_graph._marks(guard(args, marks)[0])
        outcomes.append(accepted)
    assert True in outcomes and False in outcomes


@pytest.mark.parametrize("value,other,same", [
    (1, 1.0, True), (1, True, True), (0.5, 0.5, True), ("s", "s", True),
    (math.nan, math.nan, True), (math.nan, float("nan"), False), ((), (), True),
    ([1], (1,), False), (None, 0, False), ((1, 2), Fixed(1, 2), False),
    (torch.Size([2]), (2,), False), ((2,), torch.Size([2]), False),
    (torch.Size([2]), torch.Size([2]), True)])
def test_constant_compares_as_the_key(value, other, same):
    """A constant is accepted where the key's tuple compare finds it equal:
    the same object, or an equal constant of another type; never a
    container in a constant's place, nor a constant in a container's."""
    base = (torch.zeros(1), value)
    key = cuda_graph._flatten(base, [])
    guard = cuda_graph._guard(base)
    args = (torch.zeros(1), other)
    assert (cuda_graph._flatten(args, []) == key) is same
    assert check(guard, args, key, [(None, None)]) is same


# --- through Graphed ---------------------------------------------------------------


@pytest.fixture
def no_capture_in_progress(monkeypatch):
    """The CPU build has no capture to ask about: none is in progress."""
    monkeypatch.setattr(cuda_graph, "_inline", lambda: False)


@pytest.fixture
def on_the_cpu(monkeypatch, no_capture_in_progress):
    """The full path takes CPU tensors too: the refusal lifted."""
    monkeypatch.setattr(cuda_graph, "refusal", lambda leaves: None)


def captured(graphed, args):
    """``graphed`` with the stand-in graph of ``args`` cached as after its
    first replay: its guard built and the graph the one used last."""
    key = graphed.cache_key(*args)
    graph = cpu_graph(graphed.fn, args)
    graph.key, graph.guard = key, cuda_graph._guard(args)
    graphed.graphs[key] = graph
    graphed._last = graph
    return graph


def _scaled(x, w, opts):
    return {"y": x * w.a, "w": w, "n": opts["n"]}


def test_calls_take_the_guard_and_give_what_the_full_path_gives(on_the_cpu, monkeypatch):
    """Calls of one structure take the guard (no walk); another structure
    misses it and the full path finds its own graph, whose guard then takes
    the calls; a graph dropped from the cache is not replayed."""
    graphed = cuda_graph.Graphed(_scaled)
    x, w = torch.arange(3.0), Loose(torch.tensor(2.0))
    a = captured(graphed, (x, w, {"n": 1}))
    b = captured(graphed, (x[:2], w, {"n": 1}))
    walks = []   # the full path's refusal checks, one a walk
    monkeypatch.setattr(cuda_graph, "refusal", lambda leaves: walks.append(1))
    out = graphed(x, w, {"n": 1})   # b is the one used last: a miss
    assert torch.equal(out["y"], x * 2) and out["n"] == 1 and len(walks) == 1
    assert graphed._last is a and a.key is next(reversed(graphed.graphs))
    w.a.add_(1.0)
    out = graphed(x.clone(), w, {"n": 1})   # a hit
    assert torch.equal(out["y"], x * 3) and out["w"].a is not w.a and len(walks) == 1
    out = graphed(x[:2], w, {"n": 1})   # a miss, then b's guard
    out = graphed(x[:2], w, {"n": 1})
    assert torch.equal(out["y"], x[:2] * 3) and len(walks) == 2
    assert list(graphed.graphs.values()) == [a, b]
    graphed.graphs.clear()
    assert graphed._find((x[:2], w, {"n": 1}))[2] is None and len(walks) == 3
    assert graphed._last is None


@pytest.mark.parametrize("change,message", [
    (lambda x, w: (x.requires_grad_(), w), "a tensor requires grad: a replay records no "
                                           "autograd graph"),
    (lambda x, w: (torch.zeros(4), w), "tensors on ['cpu']: a CUDA graph needs one CUDA "
                                       "device"),
    (lambda x, w: (torch.zeros(3, device="meta"), w), "tensors on ['cpu', 'meta']: a CUDA "
                                                      "graph needs one CUDA device"),
    (lambda x, w: (1.0, Loose(2.0)), "no tensor among the arguments"),
])
def test_a_miss_refuses_as_before(change, message, no_capture_in_progress):
    """Arguments the guard refuses take the full path, which refuses them
    with :func:`refusal`'s own messages."""
    graphed = cuda_graph.Graphed(_scaled)
    x, w = torch.arange(3.0), Loose(torch.tensor(2.0))
    captured(graphed, (x, w, {"n": 1}))
    graphed(x, w, {"n": 1})
    with pytest.raises(ValueError) as e:
        graphed(*change(x, w), {"n": 1})
    assert str(e.value) == f"no CUDA graph of this call: {message}"


def test_guard_counters_record_under_the_profiler(on_the_cpu):
    """Traced calls count the guard's hits and misses; the plain ones
    count nothing."""
    graphed = cuda_graph.Graphed(_scaled)
    x, w = torch.arange(3.0), Loose(torch.tensor(2.0))
    captured(graphed, (x, w, {"n": 1}))
    captured(graphed, (x[:2], w, {"n": 1}))
    profiling.reset()
    try:
        graphed(x, w, {"n": 1})
        assert profiling.counters() == {}
        for args in [(x, w), (x, w), (x[:2], w), (x, w), (x, w)]:
            graphed.call(args + ({"n": 1},), True)
        assert {k: v for k, v in profiling.counters().items() if "guard" in k} == {
            "graphed.guard_hits": 3, "graphed.guard_misses": 2}
    finally:
        profiling.reset()


def test_guard_hit_reader_is_silent_on_a_port_without_the_guard():
    """A registry with the call's spans but no guard counters (a port that
    has no guard) reads None."""
    from benchmark import harness

    profiling.reset()
    try:
        profiling.record("graphed.walk", 1000)
        profiling.count("graphed.inputs_copied", 2)
        for cell in ("update", "node", "tick"):
            assert harness.reader(f"graph_guard_hit.{cell}")({}) is None
    finally:
        profiling.reset()
