"""The control step's stages (utils/profiling.py ``stage``) and the
benchmark's readers of them (``benchmark/stages.py``, the ``stage_us.*``
metrics), on the CPU.

Op by op a stage is the span ``stage.<name>`` while a profiler runs and
records nothing while none does; under a CUDA graph's capture it records
the device nodes it captured, which the CPU cannot show: here libcuda's
node reader (``profiling._capture_kinds``) is replaced by a list the test
fills. A replay runs no stage code. The readers lay a stage table over
traced units given by hand, as the card's trace gives them.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, stages, trace
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS, autorally_nn_launch, pets_pe_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.solver import compile_step, mppi_step
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph
from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph, profiling

K, T = 32, 6
CELLS = ("full_body.update", "full_body_gn.update", "autorally_nn.update", "pets_pe.update")
EAGER_CELLS = ("autorally_nn.update", "pets_pe.update")
READERS = {"prologue": CELLS, "draw": EAGER_CELLS, "samples": EAGER_CELLS,
           "rollout_cost": CELLS, "average": CELLS, "refine": ("full_body_gn.update",),
           "finish": EAGER_CELLS, "outside": CELLS}


@pytest.fixture(autouse=True)
def empty_registry(monkeypatch):
    """An empty registry and no stage table of another test's."""
    monkeypatch.setattr(profiling, "_TABLES", type(profiling._TABLES)(maxlen=64))
    profiling.reset()
    yield
    profiling.reset()


# --- op by op -------------------------------------------------------------------------

def case(launch):
    """(cfg, sp, cp, path, pose, ctrl) of ``launch`` at K, T in float32 (the kernel
    path takes float32 only)."""
    cfg, sp, cp, course = launch(num_samples=K, horizon=T, dtype=torch.float32, device="cpu")
    path = PathBuffer.from_points(course, 0.1, dtype=torch.float32, device="cpu")
    model = get_model(cfg.model)
    pose = torch.zeros(len(model.state_names))
    pose[:2] = torch.as_tensor(course[0, :2])
    ctrl = ControllerState.initial(3, T, model.num_controls, dtype=torch.float32, device="cpu")
    return cfg, sp, cp, path, pose, ctrl


# path -> (preset, mppi_step's options, the stages one step enters and how often)
PATHS = {
    "kernel-lean": (PRESETS["full_body"], dict(use_kernel=True, lean=True),
                    {"prologue": 1, "rollout_cost": 1, "average": 1, "finish": 1}),
    "two-pass elite": (PRESETS["full_body"], dict(use_kernel=True, elite_frac=0.25),
                       {"prologue": 1, "rollout_cost": 2, "average": 2, "finish": 1}),
    "eager network": (autorally_nn_launch, dict(lean=True),
                      {"prologue": 1, "draw": 1, "samples": 1, "rollout_cost": 1,
                       "average": 1, "finish": 1}),
    "eager ensemble": (pets_pe_launch, dict(lean=True),
                       {"prologue": 1, "draw": 1, "samples": 1, "rollout_cost": 1,
                        "average": 1, "finish": 1}),
    "refined": (PRESETS["full_body"],
                dict(use_kernel=True, lean=True, refine_steps=2, refine_method="gauss_newton"),
                {"prologue": 1, "rollout_cost": 1, "average": 1, "refine": 1, "finish": 1}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_step_records_its_stages_under_the_profiler(path):
    """Under the profiler one op-by-op step records each of its path's
    stages as a span (two passes for the two-pass elite update), each a
    range of the trace; without one it records nothing; both compute the
    same update bit for bit."""
    launch, options, want = PATHS[path]
    cfg, sp, cp, path_buf, pose, ctrl = case(launch)
    plain = mppi_step(cfg, ctrl, pose, path_buf, 0.1, sp, cp, **options)[1].u_opt
    assert profiling.spans() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = mppi_step(cfg, ctrl, pose, path_buf, 0.1, sp, cp, **options)[1].u_opt
    assert torch.equal(plain, traced)
    spans = profiling.spans()
    assert {n: s["count"] for n, s in spans.items()} == {f"stage.{n}": c for n, c in want.items()}
    assert all(s["total_s"] > 0 for s in spans.values())
    names = [e.name for e in prof.events()]
    assert all(names.count(f"stage.{n}") == c for n, c in want.items())


def test_the_removed_spans_are_gone():
    """The eager models' rollouts and the refine stage record no span of
    their own: their time is the stages ``rollout_cost`` and ``refine``."""
    for path in ("eager network", "eager ensemble", "refined"):
        launch, options, _ = PATHS[path]
        cfg, sp, cp, path_buf, pose, ctrl = case(launch)
        with profile(activities=[ProfilerActivity.CPU]):
            mppi_step(cfg, ctrl, pose, path_buf, 0.1, sp, cp, **dict(options, lean=False))
        mppi_step(cfg, ctrl, pose, path_buf, 0.1, sp, cp, **dict(options, lean=False))
    assert not {"model.nn_rollout", "model.pe_rollout", "refine.stage"} & set(profiling.spans())
    assert all(n.startswith("stage.") for n in profiling.spans())


def test_a_nested_mark_raises(fake_graph):
    """A stage opened inside another raises, under the profiler and under a
    capture, and leaves nothing open behind it."""
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="do not nest"):
            with profiling.stage("average"):
                with profiling.stage("refine"):
                    pass
        with profiling.stage("refine"):      # the failed mark left nothing open
            pass
    assert profiling.spans()["stage.average"]["count"] == 1
    with pytest.raises(RuntimeError, match="do not nest"):
        with profiling.capturing_stages(stream=0):
            with profiling.stage("average"):
                with profiling.stage("refine"):
                    pass
    assert profiling.stage_tables() == [] and profiling._CAPTURES == {}


def test_off_the_profiler_a_stage_records_nothing():
    with profiling.stage("prologue"):
        with profiling.stage("draw"):        # no check while nothing records
            pass
    assert profiling.spans() == {} and profiling.stage_tables() == []


# --- under a capture ------------------------------------------------------------------

class FakeGraph:
    """A graph being captured, as libcuda's node reader sees it: ``nodes``
    holds one letter a node ("" for an event or empty node)."""

    def __init__(self):
        self.nodes, self.reads = [], 0

    def launch(self, letters: str):
        self.nodes.extend("" if c == "-" else c for c in letters)

    def kinds(self, stream, cache):
        self.reads += 1
        return "".join(self.nodes)


@pytest.fixture
def fake_graph(monkeypatch):
    """libcuda's node reader replaced by a FakeGraph's."""
    graph = FakeGraph()
    monkeypatch.setattr(profiling, "_capture_kinds", graph.kinds)
    return graph


def test_the_table_holds_each_stage_run_of_device_nodes(fake_graph):
    """Each stage's (first device node, count) from the reads at its entry
    and exit: event and empty nodes are not counted, an unmarked node lies
    between stages, a stage may appear twice and may capture nothing; the
    table is the graph's and the process's, and the reads are a span."""
    graph = fake_graph
    with profiling.capturing_stages(stream=0) as capture:
        graph.launch("C")                     # unmarked: the graph's own
        with profiling.stage("prologue"):
            graph.launch("K-K")
        with profiling.stage("rollout_cost"):
            graph.launch("K")
        with profiling.stage("average"):
            graph.launch("-")
        with profiling.stage("rollout_cost"):
            graph.launch("KSK")
        with profiling.stage("finish"):
            pass
        graph.launch("KC")
    want = profiling.StageTable(
        (("prologue", 1, 2), ("rollout_cost", 3, 1), ("average", 4, 0),
         ("rollout_cost", 4, 3), ("finish", 7, 0)), "CKKKKSKKC")
    assert capture.table == want and profiling.stage_tables() == [want]
    assert graph.reads == 1 + 2 * 5 + 1      # the start, each mark's two, the end
    assert profiling.spans()["graphed.stage_reads"]["count"] == 1


def test_a_capture_without_marks_or_with_a_failed_read_keeps_no_table(fake_graph,
                                                                      monkeypatch):
    with profiling.capturing_stages(stream=0) as capture:
        fake_graph.launch("KK")
    assert capture.table is None and profiling.stage_tables() == []
    with pytest.raises(ValueError):
        with profiling.capturing_stages(stream=0) as capture:
            with profiling.stage("prologue"):
                raise ValueError
    assert capture.table is None and profiling._CAPTURES == {}
    with profiling.capturing_stages(stream=0) as capture:
        with profiling.stage("prologue"):
            fake_graph.launch("K")
            monkeypatch.setattr(profiling, "_capture_kinds", lambda stream, cache: None)
        with profiling.stage("average"):
            pass
    assert capture.table is None and profiling.stage_tables() == []


def test_no_libcuda_no_table(monkeypatch):
    """Where libcuda cannot be loaded, a capture records nothing and its
    stages fall back to what they do op by op."""
    monkeypatch.setattr(profiling, "_LIBCUDA", False)
    with profiling.capturing_stages(stream=0) as capture:
        with profiling.stage("prologue"):
            pass
    assert capture.table is None and profiling._CAPTURES == {} and profiling.spans() == {}


# --- a replay --------------------------------------------------------------------------

def replay_only_graph(keyed, args):
    """A ``_Graph`` of ``keyed``'s function at ``args`` whose replay runs no
    host code, as a CUDA graph's does: its outputs were computed once, at
    the stand-in's capture."""
    g = object.__new__(cuda_graph._Graph)
    leaves = []
    template, _ = cuda_graph.split_tensors(args, leaves)
    g.groups, g.captured = (), [0] * len(cuda_graph._COUNTED)
    g.inputs = [t.clone() for t in leaves]
    g._loaded = cuda_graph._marks(leaves)
    g.outputs = []
    g.out_template, _ = cuda_graph.split_tensors(
        keyed.fn(*cuda_graph.fill_tensors(template, g.inputs)), g.outputs)
    g.graph = type("Replay", (), {"replay": staticmethod(lambda: None)})
    return g


@pytest.mark.parametrize("traced", [False, True])
def test_a_replay_calls_no_stage_code(traced, monkeypatch):
    """A compiled update's call that replays its graph, with and without
    the profiler, enters no stage, reads no node and leaves the process's
    stage tables as they were."""
    monkeypatch.setattr(cuda_graph, "refusal", lambda leaves: None)
    monkeypatch.setattr(cuda_graph, "_inline", lambda: False)
    monkeypatch.setattr(KeyedGraph, "_graphed", staticmethod(lambda ctrl, graph: graph))
    cfg, sp, cp, path_buf, pose, ctrl = case(PRESETS["full_body"])
    dt = torch.tensor(0.1)
    step = compile_step(cfg, use_kernel=True, lean=True)
    args = step.graph._inputs(ctrl, path_buf, dt) + step._args(ctrl, pose, path_buf, dt,
                                                                sp, cp)[3:]
    graph = replay_only_graph(step.graph, args)
    step.graph.graphed.graphs[step.graph.graphed.cache_key(*args)] = graph
    profiling._TABLES.append(TABLE)

    def refuse(*a, **k):
        raise AssertionError("a replay ran stage code")

    monkeypatch.setattr(profiling.stage, "__enter__", refuse)
    monkeypatch.setattr(profiling, "_capture_kinds", refuse)
    with profile(activities=[ProfilerActivity.CPU]) if traced else _nothing():
        for _ in range(3):
            ctrl, res = step(ctrl, pose, path_buf, dt, sp, cp)
    assert ctrl.step == 3 and res.u_opt.shape == (T - 1, 5)
    assert profiling.stage_tables() == [TABLE]
    assert not any(n.startswith("stage.") for n in profiling.spans())


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# --- the readers ---------------------------------------------------------------------

COPY = "Memcpy DtoD (Device -> Device)"
SET = "Memset (Device)"
# a graph of six device nodes: the prologue's kernel, the rollout's kernel and
# a set, the average's kernel, an unmarked copy, the finish's kernel
TABLE = profiling.StageTable((("prologue", 0, 1), ("rollout_cost", 1, 2), ("average", 3, 1),
                              ("finish", 5, 1)), "KKSKCK")
REPLAY = [("prologue_kernel", 4.0), ("rollout_cost_kernel", 150.0), (SET, 1.0),
          ("div", 2.0), (COPY, 1.5), ("advance", 0.5)]
WANT = {"prologue": 4.0, "rollout_cost": 151.0, "average": 2.0, "finish": 0.5,
        "outside": 2.0 + 1.5 + 3.0}      # the copies in and out, the unmarked copy


def units(replays):
    """trace.unit_ops of units that each copy two inputs in (1 us each),
    replay ``replays[i]`` (ops as REPLAY) and clone three outputs (1 us
    each), the replay's ops carrying the graph launch's correlation."""
    x = lambda name, cat, ts, dur, corr: dict(  # noqa: E731
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}})
    events, corr = [], 0
    for i, replay in enumerate(replays):
        t = 1000.0 * i
        events.append({"ph": "X", "cat": "user_annotation", "name": harness.MARK, "ts": t,
                       "dur": 900.0})
        ops = [(COPY, 1.0, "cudaMemcpyAsync")] * 2 + [(n, d, "cudaGraphLaunch")
                                                      for n, d in replay]
        ops += [(COPY, 1.0, "cudaMemcpyAsync")] * 3
        at = t + 10.0
        for name, dur, launch in ops:
            corr += 1
            events.append(x(launch, "cuda_runtime", at, 1.0, corr))
            cat = "gpu_memcpy" if name == COPY else "gpu_memset" if name == SET else "kernel"
            events.append(x(name, cat, at + 5.0, dur, corr))
            at += 10.0
    return trace.unit_ops(events, harness.MARK)


def obs_of(unit_ops):
    return {"units": {"update": unit_ops}}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_stage_reader(metric, monkeypatch):
    """Each reader on four units, one of them mismatched (a profiler that
    lost its first records): the mean of the three matched; with half or
    more mismatched, None; with no table, no units or a port without
    tables, None; its entry lists its cells."""
    read = harness.reader(f"stage_us.{metric}")
    lost = REPLAY[1:]                         # the first op lost
    four = obs_of(units([REPLAY, lost, REPLAY, REPLAY]))
    assert read(four) is None                 # no table yet
    profiling._TABLES.append(TABLE)
    want = WANT.get(metric)
    assert read(four) == (pytest.approx(want, rel=1e-12) if want is not None else None)
    assert read(obs_of(units([REPLAY, lost, lost, lost]))) is None
    assert read({"units": {}}) is None
    monkeypatch.delattr(profiling, "stage_tables")
    assert read(four) is None
    (entry,) = [m for m in harness.load_benchmark()["per_layer"]
                if m["name"] == f"stage_us.{metric}"]
    assert entry == {"name": f"stage_us.{metric}", "unit": "us", "better": "lower",
                     "source": "device_trace", "layer": "control step",
                     "moves": "propagations_per_s", "workloads": list(READERS[metric])}


def test_the_stages_and_outside_add_up_to_the_unit():
    profiling._TABLES.append(TABLE)
    obs = obs_of(units([REPLAY] * 3))
    got = sum(stages.stage_us(obs, n) for n in ("prologue", "rollout_cost", "average",
                                                 "finish", stages.OUTSIDE))
    assert got == pytest.approx(sum(d for _, d in REPLAY) + 5.0, rel=1e-12)
    assert harness.reader("stage_matched.update")(obs) == 100.0


def test_the_share_of_units_matched(monkeypatch):
    """``stage_matched.update``: the share of the traced units the table
    matches, also where too few match for a stage reading; None with no
    table, no units or a port without tables; its entry lists the four
    cells."""
    read = harness.reader("stage_matched.update")
    lost = REPLAY[1:]
    four = obs_of(units([REPLAY, lost, REPLAY, REPLAY]))
    assert read(four) is None
    profiling._TABLES.append(TABLE)
    assert read(four) == 75.0
    few = obs_of(units([REPLAY, lost, lost, lost]))
    assert read(few) == 25.0 and stages.stage_us(few, "prologue") is None
    assert read({"units": {}}) is None
    (entry,) = [m for m in harness.load_benchmark()["per_layer"]
                if m["name"] == "stage_matched.update"]
    monkeypatch.delattr(profiling, "stage_tables")
    assert read(four) is None
    assert entry == {"name": "stage_matched.update", "unit": "%", "better": "higher",
                     "source": "device_trace", "layer": "control step",
                     "moves": "propagations_per_s", "workloads": list(CELLS)}


def test_a_unit_matches_where_one_place_fits():
    """The block lies after the copies in and before the clones: a kernel
    where the table has a copy, a copy where it has a kernel, or a block
    that two places fit, matches nothing; of two tables the one that more
    units match is read."""
    assert stages._place("CCKKSKCKCCC", TABLE.kinds) == 2
    assert stages._place("CCKKKKCKCCC", TABLE.kinds) is None       # a kernel for the set
    assert stages._place("CKCKKSKCKCC", TABLE.kinds) is None       # a kernel among the copies in
    assert stages._place("CCCC", "CC") is None                     # three places fit
    assert stages._place("CCKC", "KC") == 2
    other = profiling.StageTable((("prologue", 0, 3),), "KKK")
    profiling._TABLES.extend([TABLE, other])
    obs = obs_of(units([REPLAY] * 2))
    assert stages.stage_us(obs, "prologue") == 4.0                 # TABLE's, not other's


def test_the_readers_are_silent_on_the_cpu():
    """The update cell through harness.run at a tiny size on the CPU: no
    device trace, so no stage reading, and the run is correct."""
    line, _ = harness.run("full_body.update", 2**31 + 7, 0.0, True, torch.device("cpu"), 0.0,
                          config_overrides={"num_samples": K, "horizon": T},
                          traffic_overrides={"warmup_units": 1, "trace_units": 2,
                                             "check_sample": 1})
    assert line["correct"]
    assert not any(m.startswith("stage_us.") for m in line["metrics"])
