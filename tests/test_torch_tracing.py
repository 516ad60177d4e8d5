"""The port's spans and counters (utils/profiling.py) on the CPU: a compiled
call's hot spans record only while torch.profiler runs, and then sit in its
Chrome trace as ranges; cold spans record always; counters add up; and the
benchmark's readers of them (benchmark/metrics/) read what was recorded.

The CPU has no CUDA graph, so a compiled call here replays a stand-in
(:func:`cpu_graph`): the graph's input buffers, loads and output copies are
the port's own, and its "replay" runs the function on the buffers.
"""

import ctypes.util
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.kernels import build
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, compile_step, init_fleet
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph
from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph, profiling
from ccv_mppi_path_tracker_tpu_torch.utils.profiling import PhaseTimer, span

PARTS = ("graphed.walk", "graphed.load", "graphed.replay", "graphed.outputs",
         "compiled.wrap_out")


@pytest.fixture(autouse=True)
def empty_registry():
    """Each test starts and ends with an empty registry: the process is
    shared with other test files."""
    profiling.reset()
    yield
    profiling.reset()


def cpu_graph(fn, args):
    """A ``_Graph`` of ``fn`` at ``args`` whose replay runs ``fn`` on its
    input buffers and copies the result into its outputs."""
    g = object.__new__(cuda_graph._Graph)
    leaves = []
    template, _ = cuda_graph.split_tensors(args, leaves)
    g.groups, g.captured = (), [0] * len(cuda_graph._COUNTED)
    g.inputs = [t.clone() for t in leaves]
    g._loaded = cuda_graph._marks(leaves)
    g.outputs = []
    g.out_template, _ = cuda_graph.split_tensors(fn(*cuda_graph.fill_tensors(template,
                                                                            g.inputs)),
                                                 g.outputs)

    def replay():
        out = []
        cuda_graph.split_tensors(fn(*cuda_graph.fill_tensors(template, g.inputs)), out)
        torch._foreach_copy_(g.outputs, out)

    g.graph = type("Replay", (), {"replay": staticmethod(replay)})
    return g


@pytest.fixture
def on_the_cpu(monkeypatch):
    """Compiled calls replay on the CPU: a CUDA graph's refusal of CPU
    tensors, the capture check and KeyedGraph's card check lifted."""
    monkeypatch.setattr(cuda_graph, "refusal", lambda leaves: None)
    monkeypatch.setattr(cuda_graph, "_inline", lambda: False)
    monkeypatch.setattr(KeyedGraph, "_graphed", staticmethod(lambda ctrl, graph: graph))


def install(keyed, ctrl, path, dt, *rest):
    """The stand-in graph of ``keyed`` at these arguments, in its cache."""
    args = keyed._inputs(ctrl, path, dt) + rest
    keyed.graphed.graphs[keyed.graphed.cache_key(*args)] = cpu_graph(keyed.fn, args)


def program(kind):
    """(call(ctrl) -> (ctrl, u_opt), the first state, the tensors copied in
    a call): the chained update of the benchmark's update cells, or the
    fleet tick, whose poses are a new tensor every tick, at a tiny size."""
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=32, horizon=6, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    dt = torch.tensor(0.1)
    pose = torch.tensor([0.0, float(course[0, 1]), 0.0])
    if kind == "update":
        step = compile_step(cfg, use_kernel=True, lean=True)
        ctrl = ControllerState.initial(7, 6, 2, device="cpu")
        install(step.graph, ctrl, path, dt, *step._args(ctrl, pose, path, dt, sp, cp)[3:])

        def call(c):
            c, res = step(c, pose, path, dt, sp, cp)
            return c, res.u_opt
        return call, ctrl, 2
    tick = build_fleet_step(cfg, use_kernel=True)
    ctrl = init_fleet(cfg, 3, seed=7, device="cpu")
    poses = pose.repeat(3, 1)
    install(tick.graphed, ctrl, path, dt, poses, sp, cp, None, None, cfg, True)

    def call(c):
        c, res = tick(c, poses.clone(), path, dt, sp, cp)
        return c, res.u_opt
    return call, ctrl, 3


@pytest.mark.parametrize("kind", ["update", "fleet"])
def test_hot_spans_record_only_under_the_profiler(kind, on_the_cpu, tmp_path):
    """Off the profiler a compiled call records nothing; under it each call
    records each part once (the update's wrap-in twice: its options and the
    graph's arguments), the inputs copied and the guard's hits are counted
    (the plain call before took the full path and built the guard of the
    graph put in by hand), and the parts are ranges of the Chrome trace. The traced calls compute what the plain
    ones do."""
    call, ctrl, copied = program(kind)
    plain, _, _ = program(kind)
    c_traced, c_plain = call(ctrl)[0], plain(ctrl)[0]
    assert profiling.spans() == {} and profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            c_traced, u_traced = call(c_traced)
    for _ in range(3):
        c_plain, u_plain = plain(c_plain)
    assert torch.equal(u_traced, u_plain) and c_traced.step == c_plain.step == 4
    spans = profiling.spans()
    assert {n: s["count"] for n, s in spans.items()} == dict(
        {"compiled.wrap_in": 6 if kind == "update" else 3}, **{n: 3 for n in PARTS})
    assert all(s["total_s"] > 0 for s in spans.values())
    assert profiling.counters() == {"graphed.inputs_copied": 3 * copied,
                                    "graphed.guard_hits": 3}
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert {n: ranges.count(n) for n in spans} == {n: s["count"] for n, s in spans.items()}


def test_cold_spans_record_either_way(monkeypatch, tmp_path):
    """A cold span records with and without the profiler, and is a range of
    the trace under it; so is the kernel library's load, once a library."""
    lib = ctypes.util.find_library("c")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build", lambda name: (lib, 0.0, None))
    with span("cold"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("cold"):
            pass
        assert build.load_library("libc") is build.load_library("libc")
    spans = profiling.spans()
    assert spans["cold"]["count"] == 2 and spans["kernel.load"]["count"] == 1
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {"cold", "kernel.load"} <= {e["name"] for e in events
                                       if e.get("cat") == "user_annotation"}


def test_phases_are_spans_of_the_registry():
    timer = PhaseTimer()
    with timer.phase("a"):
        pass
    with pytest.raises(KeyError):
        with timer.phase("a"):
            raise KeyError
    assert timer.summary()["a"]["count"] == 2
    assert profiling.spans()["a"] == {"count": 2, "total_s": timer.summary()["a"]["total_s"]}
    assert PhaseTimer().summary() == {}


def test_counters_add_up_and_reset_empties_both():
    profiling.count("c")
    profiling.count("c", 4)
    profiling.record("s", 1500, count=3)
    profiling.record("s", 500)
    assert profiling.counters() == {"c": 5}
    assert profiling.spans() == {"s": {"count": 4, "total_s": 2e-6}}
    profiling.reset()
    assert profiling.spans() == {} and profiling.counters() == {}


# four calls, each of its parts in nanoseconds; 10 tensors copied; the guard
# accepting three of the four calls; set-up once
HAND = {"compiled.wrap_in": (8, 80_000), "compiled.wrap_out": (4, 20_000),
        "graphed.walk": (4, 160_000), "graphed.load": (4, 60_000),
        "graphed.replay": (4, 80_000), "graphed.outputs": (4, 200_000),
        "graphed.capture": (1, 3_000_000_000), "kernel.load": (1, 500_000_000)}
READS = {"call_wrap_us": 25.0, "graph_walk_us": 40.0, "graph_load_us": 15.0,
         "graph_replay_us": 20.0, "graph_outputs_us": 50.0, "graph_inputs_copied": 2.5,
         "graph_guard_hit": 75.0}
WANT = dict({f"{m}.{x}": v for m, v in READS.items() for x in ("update", "node", "tick")},
            setup_capture_s=2.5, setup_kernel_load_s=0.5)
CELL = {"update": "full_body.update", "node": "diff_drive.update",
        "tick": "diff_drive.fleet-B256"}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_reader(metric, monkeypatch):
    """Each reader of the registry: None on an empty one and on a port
    without one, its value on one filled by hand; its entry lists its
    cells."""
    read = harness.reader(metric)
    assert read({}) is None
    for name, (n, ns) in HAND.items():
        profiling.record(name, ns, count=n)
    profiling.count("graphed.inputs_copied", 10)
    profiling.count("graphed.guard_hits", 3)
    profiling.count("graphed.guard_misses", 1)
    assert read({}) == pytest.approx(WANT[metric], rel=1e-12)
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None
    (entry,) = [m for m in harness.load_benchmark()["per_layer"] if m["name"] == metric]
    suffix = metric.split(".")[-1]
    assert entry["workloads"] == ([CELL[suffix]] if suffix in CELL else
                                  ["full_body.update", "diff_drive.fleet-B256",
                                   "diff_drive.update"])


# --- the refine stage's readers (the cell full_body_gn.update) --------------------------------

GN_CELL = "full_body_gn.update"
GN_READERS = ("refine_device_us.gn", "refine_ops.gn", "refine_roofline.gn",
              "refine_accepted.gn")


def gn_window(monkeypatch):
    """The obs of a traced in-process window of the refined cell at K=64,
    T=10, and its line. On the CPU the trace holds no device operation, so
    ``units`` is empty."""
    import time

    seen = []
    real = harness.reader
    monkeypatch.setattr(harness, "reader", lambda name: lambda obs: (seen.append(obs),
                                                                    real(name)(obs))[1])
    line, _ = harness.run(GN_CELL, 2**31 + 3, 0.0, True, torch.device("cpu"),
                          time.perf_counter(), config_overrides={"num_samples": 64, "horizon": 10},
                          traffic_overrides={"warmup_units": 1, "trace_units": 2,
                                             "check_sample": 1})
    monkeypatch.setattr(harness, "reader", real)
    return seen[0], line


def gn_units():
    """Two refined units as the card's trace gives them: the fused kernel,
    then the stage's launches (two and three of them), by correlation."""
    from benchmark import trace

    k = "void rollout_cost_kernel<3, false, true>(float*)"
    x = lambda name, cat, ts, dur, corr=None: dict(  # noqa: E731
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur},
        **({"args": {"correlation": corr}} if corr is not None else {}))
    events = [x(harness.MARK, "user_annotation", 0, 100),
              x(harness.MARK, "user_annotation", 400, 100),
              x("cudaGraphLaunch", "cuda_runtime", 10, 5, 1),
              x("cudaGraphLaunch", "cuda_runtime", 410, 5, 2),
              x("fill", "kernel", 20, 2, 1), x(k, "kernel", 30, 150, 1),
              x("cholesky", "kernel", 181, 40, 1), x("solve", "kernel", 230, 20, 1),
              x(k, "kernel", 420, 150, 2), x("gemm", "kernel", 571, 10, 2),
              x("cholesky", "kernel", 590, 40, 2), x("where", "kernel", 640, 6, 2)]
    return trace.unit_ops(events, harness.MARK)


def test_refine_readers_read_a_traced_window(monkeypatch):
    """The accepted share from the counters the window's updates added; the
    stage's time, launches and roofline share from its units (here the
    card's trace given by hand): 60 and 56 us, 2 and 3 launches."""
    from benchmark import work_refine

    obs, line = gn_window(monkeypatch)
    counted = profiling.counters()
    assert counted["refine.lm_steps"] % 3 == 0 and counted["refine.lm_steps"] >= 3 * 4
    share = line["metrics"]["refine_accepted.gn"]["value"]
    assert share == 100.0 * counted.get("refine.lm_accepted", 0) / counted["refine.lm_steps"]
    assert 0.0 < share <= 100.0
    assert set(line["metrics"]) == {"refine_accepted.gn"}     # no device trace on the CPU
    obs = dict(obs, units={"update": gn_units()})
    got = {name: harness.reader(name)(obs) for name in GN_READERS}
    assert got["refine_device_us.gn"] == 58.0 and got["refine_ops.gn"] == 2.5
    assert got["refine_roofline.gn"] == pytest.approx(
        100.0 * work_refine.bound_us(10, 5, 3) / 58.0, rel=1e-12)
    assert got["refine_accepted.gn"] == share
    entries = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    assert all(entries[n]["workloads"] == [GN_CELL] and entries[n]["layer"] == "refine stage"
               for n in GN_READERS)


def test_refine_readers_are_silent_without_what_they_read(monkeypatch):
    """A port without the device counters (it counts nothing) reads no
    accepted share; no traced unit, or none with the fused kernel, reads no
    stage time."""
    monkeypatch.setattr(profiling, "count_on_device", lambda increments, device: False)
    obs, line = gn_window(monkeypatch)
    assert profiling.counters() == {} and line["metrics"] == {}
    assert all(harness.reader(name)(obs) is None for name in GN_READERS)
    units = gn_units()
    units["names"] = ["other" if "rollout_cost" in n else n for n in units["names"]]
    assert harness.reader("refine_device_us.gn")(dict(obs, units={"update": units})) is None
    monkeypatch.delattr(profiling, "counters")
    assert harness.reader("refine_accepted.gn")(obs) is None
