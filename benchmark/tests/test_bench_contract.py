"""What a configuration may bring, at small sizes on the CPU through
``harness.run``'s overrides: solver ``options`` reach the port's update as
written and are refused where they are unknown or cannot be honoured; a
configuration's own ``reference`` module judges its cells and drives its
plant; an answer that module marks undecidable is counted under
``undecided``, left out of ``u_gap``, and held to the cell's limits file; a
per-layer reader sees every device operation of every traced unit; every
reference module imports nothing of the program. With no options and the
default reference, the three cells check what they checked before."""

import ast
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, programs, reference, timing, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"num_samples": 96, "horizon": 8}
QUICK = {"warmup_units": 2, "trace_units": 4, "check_sample": 2}
FLAGSHIP = "full_body.update"
FLEET = "diff_drive.fleet-B256"
REFINED = {"refine_steps": 2, "refine_method": "gauss_newton"}
PORT_AND_JAX = set(harness.FORBIDDEN) | {"ccv_mppi_path_tracker_tpu_torch"}


def config_of(cell, root=ROOT):
    return harness.cell_files(harness.load_benchmark(root), cell, root)["config"]


def with_options(cell, options, root=ROOT):
    """Configuration overrides: the small sizes, and ``options`` in the
    program block."""
    program = dict(config_of(cell, root)["program"], options=options)
    return dict(SMALL, program=program)


def run(cell, seed=2**31 + 7, seconds=0.0, trace=False, program=None, config=None,
        root=ROOT):
    """One run; with ``seconds`` 0 the window holds one unit, so the checked
    answers are the same on every machine."""
    traffic = dict(QUICK, **({"robots": 5} if "fleet" in cell else {}))
    return harness.run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                       program=program, config_overrides=SMALL if config is None else config,
                       traffic_overrides=traffic, root=root)


@pytest.fixture
def no_timing(monkeypatch):
    """Fails the test if a measured window starts."""
    def start(self):
        raise AssertionError("the window started")
    monkeypatch.setattr(timing.DeviceWindow, "start", start)


# --- options -----------------------------------------------------------------------------

def test_options_reach_compile_step_as_written(monkeypatch):
    from ccv_mppi_path_tracker_tpu_torch import solver

    seen = []
    real = solver.compile_step

    def spy(cfg, **options):
        seen.append(options)
        return real(cfg, **options)
    monkeypatch.setattr(solver, "compile_step", spy)
    line, _ = run(FLAGSHIP, config=with_options(FLAGSHIP, REFINED))
    assert seen == [dict(use_kernel=True, lean=True, **REFINED)]
    assert line["attempted"] == 1
    seen.clear()
    run(FLAGSHIP)
    assert seen == [dict(use_kernel=True, lean=True)]


def test_a_refined_update_fails_the_default_reference():
    """The Gauss-Newton stage moves u_opt far past the limit of the sampled
    update's reference: the limit sees the stage."""
    line, _ = run(FLAGSHIP, config=with_options(FLAGSHIP, REFINED))
    assert line["correct"] is False
    assert line["checks"]["u_gap"]["value"] > 10 * line["checks"]["u_gap"]["limit"]


def test_options_reach_the_serving_loop():
    conf = dict(config_of(FLAGSHIP), **with_options(FLAGSHIP, {"elite_frac": 0.25, **REFINED}))
    port = programs.Port(conf, torch.device("cpu"))
    path = port.path(reference.course(conf["course"]))
    loop = port.control_loop(path, 3)
    assert loop.compiled.options == dict(adapt_sigma=False, use_kernel=True, lean=True,
                                         elite_frac=0.25, **REFINED)


@pytest.mark.parametrize("options,words", [
    ({"refine_iterations": 3}, "no option 'refine_iterations'"),
    ({"cfg": 1}, "no option 'cfg'"),
    ({"noise": None}, "not an option of a configuration"),
    ({"lean": False}, "not an option of a configuration"),
    ({"elite_stale": True}, "no option 'elite_stale'"),
])
def test_an_unknown_option_is_refused(options, words, no_timing):
    with pytest.raises(programs.ConfigMismatch, match=words):
        run(FLAGSHIP, config=with_options(FLAGSHIP, options))


@pytest.mark.parametrize("cell,options,words", [
    (FLEET, {"refine_steps": 3}, "the fleet tick"),
    (FLEET, {"adapt_sigma": True}, "the fleet tick"),
    (FLAGSHIP, {"debug_candidates": 4}, "lean drops the debug outputs"),   # mppi_step's own
])
def test_an_option_the_path_cannot_honour_is_refused(cell, options, words, no_timing):
    with pytest.raises(ValueError, match=words):
        run(cell, config=with_options(cell, options))


def test_the_serving_loop_refuses_adapt_sigma():
    conf = dict(config_of(FLAGSHIP), **with_options(FLAGSHIP, {"adapt_sigma": True}))
    port = programs.Port(conf, torch.device("cpu"))
    with pytest.raises(programs.ConfigMismatch, match="the serving loop"):
        port.control_loop(port.path(reference.course(conf["course"])), 3)


@pytest.mark.parametrize("cell", [FLAGSHIP, "diff_drive.update"])
def test_adapt_sigma_leaves_u_opt_bit_equal(cell):
    """The second moment changes no bit of the update, and the default
    reference judges it correct."""
    outs = []
    for options in ({}, {"adapt_sigma": True}):
        conf = dict(config_of(cell), **with_options(cell, options))
        port = programs.Port(conf, torch.device("cpu"))
        course = reference.course(conf["course"], (0.2, -0.1))
        path, step = port.path(course), port.update_step()
        state = torch.tensor(harness.start_pose(course, reference.num_states(conf),
                                                np.random.default_rng(5), 0.05))
        ctrl, us = port.initial(11), []
        for _ in range(3):
            ctrl, u = step(ctrl, state, path, torch.tensor(0.1))
            us.append(u)
        outs.append(torch.stack(us))
    assert torch.equal(outs[0], outs[1])
    line, _ = run(cell, config=with_options(cell, {"adapt_sigma": True}))
    assert line["correct"] is True


# --- a configuration's own reference module ------------------------------------------------

MODULE = '''
from pathlib import Path

from benchmark import reference

LOG = Path(__file__).with_suffix(".log")
BIAS = {bias!r}


def _log(name):
    with LOG.open("a") as f:
        f.write(name + "\\n")


def update(config, path_xy, pose, u_prev, seed, step, robots=None, dtype=None):
    _log("update")
    kw = {{}} if dtype is None else {{"dtype": dtype}}
    u = reference.update(config, path_xy, pose, u_prev, seed, step, robots, **kw)
    u[..., 0] += BIAS * (config["solver"]["u_max"][0] - config["solver"]["u_min"][0])
    return u


def num_states(config):
    _log("num_states")
    return reference.num_states(config)


def plant(config, poses, u0, dt):
    _log("plant")
    return reference.plant(config, poses, u0, dt)
'''

MARKED = '''

def update_marked(config, path_xy, pose, u_prev, seed, step):
    """Marks robot 0 of every answer undecidable, and gets it wrong."""
    import torch

    u = update(config, path_xy, pose, u_prev, seed, step)
    undecided = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
    undecided[0] = True
    u[0] += 1.0
    return u, undecided
'''


def checkout(tmp_path, module: str, limits=None):
    """A checkout whose every configuration names ``benchmark/own_ref.py``
    (``module``), with its cells' limits updated by ``limits``."""
    root = tmp_path / "checkout"
    here = root / "benchmark"
    (here / "configs").mkdir(parents=True)
    (here / "limits").mkdir()
    (here / "traffic").symlink_to(ROOT / "benchmark" / "traffic")
    for c in BENCH["configs"]:
        conf = dict(json.loads((ROOT / c["file"]).read_text()), reference="benchmark/own_ref.py")
        (root / c["file"]).write_text(json.dumps(conf))
    for cell in CELLS:
        lim = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
        (here / "limits" / f"{cell}.json").write_text(json.dumps(dict(lim, **(limits or {}))))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (here / "own_ref.py").write_text(module)
    return root


def calls(root):
    log = root / "benchmark" / "own_ref.log"
    return log.read_text().split() if log.exists() else []


@pytest.mark.parametrize("cell", [FLAGSHIP, FLEET])
def test_a_configuration_is_judged_by_its_own_reference(cell, tmp_path):
    """A module that is the default reference moved by 1 % of the box: the
    run reads that gap, where the default reads none, and the kind took the
    pose length and the plant from it too."""
    root = checkout(tmp_path, MODULE.format(bias=0.01))
    line, _ = run(cell, root=root)
    assert line["correct"] is False
    assert line["checks"]["u_gap"]["value"] == pytest.approx(0.01, rel=1e-3)
    assert list(line["checks"]) == ["u_gap", "carry"]
    assert {"update", "num_states"} <= set(calls(root))
    assert ("plant" in calls(root)) == (cell == FLEET)
    fair = checkout(tmp_path / "fair", MODULE.format(bias=0.0))
    assert run(cell, root=fair)[0]["correct"] is True


def test_the_control_uses_the_configuration_s_reference(tmp_path):
    root = checkout(tmp_path, MODULE.format(bias=0.0))
    line, _ = run(FLAGSHIP, program=programs.Control, root=root)
    assert line["correct"] is False
    assert calls(root).count("update") > line["attempted"]     # the control's and the check's


@pytest.mark.parametrize("bad", ["benchmark/../reference.py", "/tmp/own_ref.py",
                                 "tests/own_ref.py"])
def test_a_reference_outside_the_benchmark_is_refused(bad):
    with pytest.raises(ValueError, match="a file under benchmark/"):
        harness.reference_module({"reference": bad})


def test_a_reference_must_supply_the_model_s_parts(tmp_path):
    root = checkout(tmp_path, "def update(*a, **k):\n    pass\n")
    with pytest.raises(ValueError, match="lacks num_states, plant"):
        harness.reference_module({"reference": "benchmark/own_ref.py"}, root)


# --- undecidable answers ---------------------------------------------------------------------

def test_undecided_answers_are_counted_and_left_out_of_u_gap(tmp_path):
    """Robot 0 of each of the three answers (the first, the window's one
    unit kept, the last) is marked and wrong by 1.0: counted, and u_gap
    reads the other robots only."""
    root = checkout(tmp_path, MODULE.format(bias=0.0) + MARKED, {"undecided": 3})
    line, stderr = run(FLEET, root=root)
    assert list(line["checks"]) == ["u_gap", "carry", "undecided"]
    assert line["checks"]["undecided"] == {"value": 3, "limit": 3}
    assert line["checks"]["u_gap"]["value"] < 1e-5
    assert line["correct"] is True and line["failed"] == 0
    assert "check undecided: 3 (limit 3)" in stderr


def test_too_many_undecided_answers_fail_the_run(tmp_path):
    root = checkout(tmp_path, MODULE.format(bias=0.0) + MARKED, {"undecided": 2})
    line, _ = run(FLEET, root=root)
    assert line["checks"]["undecided"]["value"] == 3 and line["correct"] is False


def test_undecided_without_a_limit_fails_before_the_window(tmp_path, no_timing):
    root = checkout(tmp_path, MODULE.format(bias=0.0) + MARKED)
    with pytest.raises(ValueError, match="no limit for undecided"):
        run(FLEET, root=root)


# --- the three cells as before -----------------------------------------------------------------

def parent_plant(model, poses, u0, dt):
    """The plant as the harness had it before a configuration could bring
    its own (``harness.host_plant``), frozen."""
    x, y, yaw = poses[:, 0], poses[:, 1], poses[:, 2]
    v, w = u0[:, 0], u0[:, 1]
    heading = yaw if model == "unicycle" else yaw + u0[:, reference.STEER]
    out = [x + v * np.cos(heading) * dt, y + v * np.sin(heading) * dt, yaw + w * dt]
    if model == "full_body":
        out += [poses[:, 3] + u0[:, 3] * dt, poses[:, 4] + u0[:, 4] * dt]
    return np.stack(out, axis=-1).astype(np.float32)


def parent_judge(answers, config, course, seed, device, limits):
    """``harness.judge`` for the update and fleet cells as it was before the
    reference became the configuration's, frozen."""
    sol = config["solver"]
    box = (torch.tensor(sol["u_max"], dtype=torch.float64)
           - torch.tensor(sol["u_min"], dtype=torch.float64)).to(device)
    out, failed = {"u_gap": 0.0, "carry": 0}, 0
    for a in answers:
        ref = reference.update(config, course, torch.from_numpy(a.poses).to(device),
                               None if a.n == 0 else a.u_prev, seed, a.n)
        got = a.out.to(device=device, dtype=torch.float64)
        gap = ((got - ref.double()).abs() / box).max().item()
        one = {"u_gap": gap if math.isfinite(gap) else math.inf}
        bad = not torch.equal(a.u_prev, a.prev_out)
        bad |= a.step is not None and a.step != a.n
        bad |= a.key is not None and a.key.tolist() != [seed, a.n]
        one["carry"] = int(bad)
        for name, value in one.items():
            out[name] = max(out.get(name, 0), value) if name.endswith("gap") else (
                out.get(name, 0) + value)
        failed += any(not (value <= limits[name]) for name, value in one.items())
    return out, failed


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 99])
def test_the_cells_check_what_they_checked(cell, seed, monkeypatch):
    """The same keys and values, bit for bit, as the frozen judge gives on
    the same answers, and the default module's plant is the frozen one."""
    seen = []
    judge = harness.judge

    def spy(*args):
        seen.append(args)
        return judge(*args)
    monkeypatch.setattr(harness, "judge", spy)
    line, _ = run(cell, seed=seed)
    (args,) = seen
    assert args[-1] is reference
    out, failed = parent_judge(*args[:-1])
    assert {k: c["value"] for k, c in line["checks"].items()} == out
    assert list(line["checks"]) == ["u_gap", "carry"] and line["failed"] == failed == 0
    rng = np.random.default_rng(seed % 2**32)
    conf = config_of(cell)
    poses = rng.normal(size=(7, reference.num_states(conf))).astype(np.float32)
    u0 = rng.normal(size=(7, len(conf["solver"]["u_min"]))).astype(np.float32)
    assert np.array_equal(reference.plant(conf, poses, u0, 0.1),
                          parent_plant(conf["model"], poses, u0, 0.1))


# --- what a reader sees ----------------------------------------------------------------------

def x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """Two units. Unit 0 launches a graph (correlation 1: the fused kernel
    and three small kernels after it, the last running after unit 1 began on
    the host) and a copy (2); unit 1 launches a graph (3); one copy runs
    with no launch in the trace; one kernel is launched between the units."""
    mark = harness.MARK
    k = "void rollout_cost_kernel<3, false, true>(float*)"
    return [
        x(mark, "user_annotation", 0, 100), x(mark, "user_annotation", 200, 100),
        x("cudaGraphLaunch", "cuda_runtime", 10, 20, 1),
        x("cudaMemcpyAsync", "cuda_runtime", 40, 5, 2),
        x("cudaLaunchKernel", "cuda_runtime", 150, 5, 9),
        x("cudaGraphLaunch", "cuda_runtime", 210, 20, 3),
        x(k, "kernel", 30, 100, 1), x("fill", "kernel", 131, 10, 1),
        x("cholesky", "kernel", 142, 40, 1), x("solve", "kernel", 205, 30, 1),
        x("Memcpy DtoD", "gpu_memcpy", 236, 4, 2),
        x("stray", "kernel", 160, 3, 9),
        x(k, "kernel", 240, 100, 3), x("cholesky", "kernel", 341, 40, 3),
        x("Memset", "gpu_memset", 390, 2),
        x("aten::cat", "cpu_op", 100, 60),
    ]


def after_the_kernel_us(units):
    """A reader's split: the device time a unit spends after its last
    ``rollout_cost_kernel`` ends, per unit."""
    k = np.array([trace.KERNEL_NAME in n for n in units["names"]])[units["name"]]
    out = []
    for i in range(len(units["unit_us"])):
        mine = units["unit"] == i
        end = (units["start_us"] + units["dur_us"])[mine & k].max()
        out.append(float(units["dur_us"][mine & (units["start_us"] >= end)].sum()))
    return out


def test_unit_ops_give_each_unit_its_device_operations():
    units = trace.unit_ops(synthetic_trace(), harness.MARK)
    names = [units["names"][j] for j in units["name"]]
    assert units["unit"].tolist() == [0, 0, 0, 0, 0, 1, 1, 1]
    assert names == ["void rollout_cost_kernel<3, false, true>(float*)", "fill", "cholesky",
                     "solve", "Memcpy DtoD", "void rollout_cost_kernel<3, false, true>(float*)",
                     "cholesky", "Memset"]
    assert units["start_us"].tolist() == [30, 131, 142, 205, 236, 40, 141, 190]
    assert units["dur_us"].tolist() == [100, 10, 40, 30, 4, 100, 40, 2]
    assert units["unit_us"].tolist() == [100, 100]
    assert units["unit"].dtype == np.int32 and units["start_us"].dtype == np.float64
    assert after_the_kernel_us(units) == [84.0, 42.0]
    assert trace.unit_ops([x(harness.MARK, "user_annotation", 0, 5)],
                          harness.MARK)["unit"].shape == (0,)


def test_the_breakdown_is_what_it_was():
    bd = trace.breakdown(synthetic_trace(), harness.MARK)
    assert bd["units"] == 2 and bd["window_us"] == 392 and bd["kernel_ms"] == 0.1
    assert set(bd) == {"units", "window_us", "busy_us", "device_idle_share",
                       "inside_idle_share", "kernel_ms", "top_device_ops",
                       "longest_idle_gaps"}


def test_a_reader_sees_the_run_s_config_traffic_and_units(monkeypatch):
    seen = []
    monkeypatch.setattr(harness, "reader", lambda name: lambda obs: seen.append(obs))
    line, _ = run(FLAGSHIP, trace=True, config=with_options(FLAGSHIP, {"adapt_sigma": True}))
    obs = seen[0]
    assert obs["config"]["program"]["options"] == {"adapt_sigma": True}
    assert obs["traffic"]["kind"] == "chained_update" and obs["units"] == {}   # no card here
    assert {"spans", "traces", "shape"} <= set(obs) and line["metrics"] == {}


# --- the import rule ---------------------------------------------------------------------------

def imported(path: Path) -> set:
    """Every top-level module name that the file's import statements name,
    and the ``benchmark`` modules it imports from by name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
            if node.module == "benchmark":
                names |= {f"benchmark.{a.name}" for a in node.names}
    return names


def reference_files(bench=BENCH, root=ROOT):
    files = {"benchmark/reference.py"}
    for c in bench["configs"]:
        files.add(json.loads((root / c["file"]).read_text()).get("reference",
                                                                  "benchmark/reference.py"))
    return sorted(files)


ALLOWED = {"benchmark.reference", "benchmark.work"}   # plain code that imports no program


def breaks_the_rule(path: Path) -> set:
    names = imported(path)
    bad = {n for n in names if n.split(".")[0] in PORT_AND_JAX}
    bad |= {n for n in names if n.startswith("benchmark.") and n not in ALLOWED}
    return bad


@pytest.mark.parametrize("name", reference_files())
def test_every_reference_module_imports_nothing_of_the_program(name):
    """By its import statements, and loaded in a fresh process as the
    harness loads it."""
    assert not breaks_the_rule(ROOT / name)
    code = ("import json, sys; from benchmark import harness; "
            f"harness.reference_module({{'reference': {name!r}}}); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & PORT_AND_JAX


def test_the_import_rule_catches_a_module_that_breaks_it(tmp_path):
    for body in ("import ccv_mppi_path_tracker_tpu_torch.solver\n",
                 "from jax import numpy\n", "from benchmark import programs\n",
                 "def f():\n    import bench_torch\n"):
        path = tmp_path / "bad.py"
        path.write_text(body)
        assert breaks_the_rule(path), body
    root = checkout(tmp_path / "ok", MODULE.format(bias=0.0))
    assert reference_files(BENCH, root) == ["benchmark/own_ref.py", "benchmark/reference.py"]
    assert not breaks_the_rule(root / "benchmark" / "own_ref.py")
