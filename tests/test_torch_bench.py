"""The port's benchmark harness (``bench_torch/``) on the CPU, at tiny sizes
with ``--device cpu``: the cells against their sources, the metric's count,
the seed, the gates, the refusal to run without a card, the trace parser,
its own work count against the package's, and that it imports no JAX."""

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import __main__ as cli
from bench_torch import cells, timing, trace, work
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    _per_sample_work,
    rollout_cost_work,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MODELS = ("unicycle", "steering_unicycle", "rate_limited_steering", "full_body")


def tiny(cell):
    """The cell at a size the CPU runs in well under a second."""
    return dataclasses.replace(cell, num_samples=64 if cell.robots == 1 else 32,
                               horizon=min(cell.horizon, 12), robots=min(cell.robots, 4),
                               chain=3, cycles=40)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the cells against their sources ---------------------------------------------

def _bench_defaults():
    src = (ROOT / "bench.py").read_text()
    k = re.search(r'"--num-samples", type=int, default=([\d_]+)', src).group(1)
    t = re.search(r'"--horizon", type=int, default=(\d+)', src).group(1)
    model = re.search(r'"--model", default="(\w+)"', src).group(1)
    return int(k.replace("_", "")), int(t), model


def _suite_cases():
    tree = ast.parse((ROOT / "scripts" / "bench_suite.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "cases":
            return [tuple(ast.literal_eval(e)) for e in node.value.elts]
    raise AssertionError("no cases in scripts/bench_suite.py")


def _suite_fleet():
    src = (ROOT / "scripts" / "bench_suite.py").read_text()
    b, k, t = re.search(r"measure_fleet\((\d+), (\d+), (\d+), use_kernel\)", src).groups()
    return int(b), int(k), int(t)


def test_there_are_seven_cells_of_one_card():
    assert len(cells.CELLS) == 7
    assert {c.kind for c in cells.CELLS.values()} == {"update", "loop", "fleet", "serving"}
    assert all(c.why for c in cells.CELLS.values())


@pytest.mark.parametrize("name", ["full_body-K102400-T30", "full_body-K102400-T30-elite0.1",
                                  "full_body-loop200-K102400-T30",
                                  "full_body-serving-K102400-T30"])
def test_flagship_cells_are_bench_py_s_workload(name):
    k, t, model = _bench_defaults()
    c = cells.CELLS[name]
    assert (c.num_samples, c.horizon, c.model) == (k, t, model)


def test_unicycle_and_reference_point_are_bench_suite_cases():
    cases = _suite_cases()
    for name in ("unicycle-K102400-T30", "full_body-K102400-T30"):
        c = cells.CELLS[name]
        assert (c.model, c.num_samples, c.horizon) in cases
    c = cells.CELLS["full_body-K10000-T15"]
    # the reference node's K=10000, T=15 (src/full_body_mppi.cpp:10); the
    # suite rounds its K to 10240, the kernel's tile
    assert (c.model, c.horizon) == ("full_body", 15) and c.num_samples == 10_000
    assert ("full_body", 10240, 15) in cases


def test_fleet_cell_is_bench_suite_fleet():
    c = cells.CELLS["fleet-unicycle-B256-K1024-T15"]
    assert (c.robots, c.num_samples, c.horizon) == _suite_fleet()
    assert c.model == "unicycle" and c.arms == ("kernel", "eager")


def test_elite_and_loop_cells():
    assert cells.CELLS["full_body-K102400-T30-elite0.1"].elite_frac == 0.1
    for name in ("full_body-loop200-K102400-T30", "full_body-serving-K102400-T30"):
        assert cells.CELLS[name].cycles == 200
    assert cells.CELLS["full_body-K102400-T30"].arms == ("kernel_lean", "kernel_full",
                                                         "eager_lean")


# --- the metric --------------------------------------------------------------------

def test_propagations_use_bench_py_s_count():
    src = (ROOT / "bench.py").read_text()
    assert "props = args.num_samples * (args.horizon - 1)" in src
    assert "baseline = 10_000 * 14 * 10" in src
    assert cells.BASELINE_PROPAGATIONS == 10_000 * 14 * 10
    for c in cells.CELLS.values():
        if c.kind == "update":
            assert cells.metric_value(c, 2.0) == pytest.approx(
                c.num_samples * (c.horizon - 1) / 2e-3, rel=1e-15)
    fleet = cells.CELLS["fleet-unicycle-B256-K1024-T15"]
    assert cells.metric_value(fleet, 4.0) == pytest.approx(256 / 4e-3)
    loop = cells.CELLS["full_body-loop200-K102400-T30"]
    assert cells.metric_value(loop, 5.0) == pytest.approx(200.0)


@pytest.mark.parametrize("samples,p,n", [(list(range(10)), None, 10),
                                         (list(range(20)), 50.0, 20),
                                         (list(range(200)), 95.0, 200),
                                         (list(range(1000)), 99.0, 1000)])
def test_summary_reports_the_percentile_with_ten_beyond(samples, p, n):
    s = timing.summary(samples)
    assert s["n"] == n and s["p"] == p and s["mean"] == pytest.approx(sum(samples) / n)
    if p is not None:
        assert sum(x > s["p_value"] for x in samples) >= timing.TAIL


@pytest.mark.parametrize("name", ["full_body-K102400-T30", "fleet-unicycle-B256-K1024-T15",
                                  "full_body-serving-K102400-T30"])
def test_metric_is_all_the_time_over_all_the_work(name):
    """A stall every tenth update moves the metric; the median would not
    see it."""
    cell = cells.CELLS[name]
    even = [1.0] * 200
    stalled = ([1.0] * 9 + [11.0]) * 20
    a, b = cells.timed(cell, even), cells.timed(cell, stalled, rounds=[2.0] * 20)
    assert a["step_ms_median"] == b["step_ms_median"] == 1.0
    assert a["step_ms"] == 1.0 and b["step_ms"] == pytest.approx(2.0)
    assert b["value"] == pytest.approx(a["value"] / 2)
    assert b["value"] == pytest.approx(cells.metric_value(cell, 2.0))
    assert b["step_ms_tail"] == {"p": 95.0, "value": 11.0} and b["rounds_ms"] == [2.0] * 20
    assert ("vs_baseline" in a) == (cell.kind == "update")


def test_serving_runs_unpaced(monkeypatch):
    """The serving cell's rate is one no cycle can meet, so cycles/s cannot
    saturate at the rate."""
    from ccv_mppi_path_tracker_tpu_torch.runtime import realtime

    seen = {}
    monkeypatch.setattr(realtime, "run_realtime_experiment",
                        lambda *a, **kw: seen.update(kw) or "out")
    assert cells._serving(cells.inputs(tiny(cells.CELLS["full_body-serving-K102400-T30"]),
                                       0, CPU), 7) == "out"
    assert seen["hz"] == cells.SERVING_HZ and 1e3 / seen["hz"] <= 1e-3
    assert seen["num_cycles"] == 7 and seen["use_kernel"]


# --- the seed ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(cells.CELLS))
def test_seed_fixes_the_inputs(name):
    cell = tiny(cells.CELLS[name])
    a, b, c = (cells.inputs(cell, s, CPU) for s in (3, 3, 4))
    for key in ("course", "start"):
        np.testing.assert_array_equal(a[key], b[key])
        assert not np.array_equal(a[key], c[key])
    assert torch.equal(a["state"], b["state"]) and torch.equal(a["path"].xy, b["path"].xy)
    assert a["seed"] == b["seed"] != c["seed"]


# --- the gates ---------------------------------------------------------------------

def test_gates_fail_on_wrong_numbers():
    u = torch.linspace(-1.0, 2.0, 30).reshape(10, 3)
    assert cells.gate_u(u, u)["ok"]
    wrong = u.clone()
    wrong[3, 1] += 5e-4 * 2.0 + 6e-5
    g = cells.gate_u(wrong, u)
    assert not g["ok"] and g["max_abs_err"] > g["bound"]
    assert not cells.gate_u(u * float("nan"), u)["ok"]
    assert cells.gate_thresh(1.0, 1.0 + 1e-5)["ok"]
    assert not cells.gate_thresh(1.0, 1.0 + 1e-4)["ok"]
    assert cells.gate_rmse(0.149)["ok"] and not cells.gate_rmse(0.151)["ok"]
    assert not cells.gate_rmse(float("nan"))["ok"]
    assert cells.gate_fleet([0.1, 0.29])["ok"]
    assert not cells.gate_fleet([0.1, 0.31])["ok"]
    assert not cells.gate_fleet([0.1, float("nan")])["ok"]
    assert cells.gate_reads((204, 104), (200, 100))["ok"]
    assert cells.gate_reads((200, 100), (200, 100),
                            [{"runtime/realtime.py:107": 200}, {}])["ok"]
    assert not cells.gate_reads((205, 104), (200, 100))["ok"]    # 1.01 a cycle
    assert not cells.gate_reads((203, 104), (200, 100))["ok"]    # 0.99
    assert not cells.gate_reads((405, 205), (200, 100))["ok"]
    assert not cells.gate_reads((355, 205), (200, 100))["ok"]
    assert cells.gate_reads((None, None), (200, 100))["ok"]   # the CPU: not counted
    with pytest.raises(cells.GateError) as e:
        cells.check(cells.gate_rmse(0.1), cells.gate_rmse(0.2))
    assert [g["ok"] for g in e.value.gate] == [True, False]


def test_sync_count_skips_the_debug_mode_s_own_warning():
    """The first set_sync_debug_mode of a process warns once that the mode
    is a prototype; counted as a sync, it read 205 syncs in 200 cycles
    against 104 in 100."""
    def warning(message, filename, lineno):
        return warnings.WarningMessage(UserWarning(message), UserWarning, filename, lineno)

    caught = [
        warning("Synchronization debug mode is a prototype feature and does not yet detect "
                "all synchronizing operations", "/x/torch/cuda/__init__.py", 1270),
        warning("called a synchronizing CUDA operation (Triggered internally at ...)",
                "/r/pkg/runtime/realtime.py", 107),
        warning("called a synchronizing CUDA operation", "/r/pkg/runtime/realtime.py", 107),
        warning("called a synchronizing CUDA operation", "/r/pkg/paths/resample.py", 55),
        warning("an unrelated warning", "/r/pkg/paths/resample.py", 58),
    ]
    assert cells.sync_sites(caught) == {"pkg/runtime/realtime.py:107": 2,
                                        "pkg/paths/resample.py:55": 1}


@pytest.mark.parametrize("name", ["full_body-K102400-T30", "full_body-K102400-T30-elite0.1"])
def test_update_gate_fails_on_an_injected_u_opt(name, monkeypatch, one_thread):
    real = cells.plain_update

    def wrong(x, elite_frac=None):
        u, t = real(x, elite_frac)
        return u + 1e-2, t

    monkeypatch.setattr(cells, "plain_update", wrong)
    with pytest.raises(cells.GateError) as e:
        cells.run(tiny(cells.CELLS[name]), 0, CPU, quick=True)
    assert e.value.gate[0]["max_abs_err"] == pytest.approx(1e-2, rel=1e-3)


def test_loop_and_fleet_gates_fail_on_injected_errors(monkeypatch, one_thread):
    monkeypatch.setattr(cells, "_fleet_loop", lambda *a: np.array([0.05, 0.4]))
    with pytest.raises(cells.GateError) as e:
        cells.run(tiny(cells.CELLS["fleet-unicycle-B256-K1024-T15"]), 0, CPU, quick=True)
    assert e.value.gate[0]["max_distance_m"] == 0.4
    real = cells._tracking

    def off_course(*a):
        out = real(*a)
        out["metrics"]["rmse"] = 0.2
        return out

    monkeypatch.setattr(cells, "_tracking", off_course)
    with pytest.raises(cells.GateError) as e:
        cells.run(tiny(cells.CELLS["full_body-loop200-K102400-T30"]), 0, CPU, quick=True)
    assert e.value.gate[0]["rmse_m"] == 0.2


@pytest.mark.parametrize("name", [n for n, c in sorted(cells.CELLS.items())
                                  if c.kind == "update"])
def test_update_arms_step_the_compiled_step(name, monkeypatch, one_thread):
    """Each update arm's chain steps a ``compile_step`` of the arm's options
    (bench.py:121-127 times jax.jit of every arm), the gate steps the
    kernel-lean arm's, and on the CPU a chain is bit-equal to op-by-op
    ``mppi_step`` from the same state."""
    from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step
    from ccv_mppi_path_tracker_tpu_torch.solver.mppi import CompiledStep

    calls = []
    real_call = CompiledStep.__call__

    def spy(self, *args, **kwargs):
        calls.append(self)
        return real_call(self, *args, **kwargs)

    monkeypatch.setattr(CompiledStep, "__call__", spy)
    cell = tiny(cells.CELLS[name])
    x = cells.inputs(cell, 0, CPU)
    arms = cells._update_arms(cell, x, CPU)
    assert tuple(arms) == cell.arms
    elite = {} if cell.elite_frac is None else {"elite_frac": cell.elite_frac}
    for arm_name, chain in arms.items():
        step = cells._update_step(cell, x, arm_name)
        assert isinstance(step, CompiledStep) and step.cfg == x["cfg"]
        assert step.options == dict(elite, use_kernel=arm_name.startswith("kernel"),
                                    lean=arm_name.endswith("lean"))
        calls.clear()
        carry = ref = chain.start()
        for _ in range(cell.chain):
            carry = chain.step(carry)
            ref = mppi_step(x["cfg"], ref, x["state"], x["path"], x["dt"], x["sp"],
                            x["cp"], **step.options)[0]
        assert calls == [step] * cell.chain
        assert carry.step == ref.step == cell.chain
        assert torch.equal(carry.u_prev, ref.u_prev), arm_name
        assert torch.equal(carry.with_key().key, ref.with_key().key)
    calls.clear()
    assert cells._gate_update(cell, x, CPU)[0]["ok"]
    assert calls == [cells._update_step(cell, x, "kernel_lean")]


# --- the command, on the CPU ---------------------------------------------------------

def test_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--cell", "full_body-K102400-T30"], ["--all"], ["--all", "--quick"],
                 ["--ladder"], ["--cell", "full_body-K10000-T15", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)


@pytest.mark.parametrize("name", sorted(cells.CELLS))
def test_cpu_run_gives_gates_and_counts_only(name, monkeypatch, capsys, one_thread):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(cells.CELLS, name, tiny(cells.CELLS[name]))
    threads, cpus = torch.get_num_threads(), os.sched_getaffinity(0)
    assert cli.main(["--cell", name, "--device", "cpu"]) == 0
    # a CPU run times nothing, so it pins nothing
    assert (torch.get_num_threads(), os.sched_getaffinity(0)) == (threads, cpus)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["cell"] == name and rec["gate"]["ok"] and rec["device"]["platform"] == "cpu"
    assert rec["pinned"] is None
    assert rec["metric"] == cells.CELLS[name].metric and rec["card"] is None
    # no number under a device metric's name
    assert rec["value"] is None and rec["step_ms"] is None and "layers" not in rec
    assert "breakdown" not in rec


def test_failed_gate_prints_its_numbers_and_exits_non_zero(monkeypatch, capsys, one_thread):
    name = "full_body-K10000-T15"
    monkeypatch.setitem(cells.CELLS, name, tiny(cells.CELLS[name]))
    monkeypatch.setattr(cells, "gate_u", lambda a, b: {"name": "u_opt", "max_abs_err": 1.0,
                                                       "bound": 0.5, "ok": False})
    assert cli.main(["--cell", name, "--device", "cpu"]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["gate"] == {"ok": False, "checks": [{"name": "u_opt", "max_abs_err": 1.0,
                                                    "bound": 0.5, "ok": False}]}


def test_aggregate_reports_the_spread_between_processes():
    recs = [{"cell": "c", "value": v, "step_ms": 1e3 / v, "vs_baseline": 1.0,
             "gate": {"ok": True, "checks": []}} for v in (2.0, 4.0, 3.0)]
    out = cli.aggregate(recs)
    assert out["per_process"] == [2.0, 4.0, 3.0] and out["value"] == 3.0
    assert out["spread"] == pytest.approx(2.0 / 3.0) and out["gate"]["ok"]
    assert out["vs_baseline"] == 3.0 / cells.BASELINE_PROPAGATIONS
    recs[1]["gate"] = {"ok": False, "checks": []}
    assert not cli.aggregate(recs)["gate"]["ok"]
    cpu = [dict(r, value=None, step_ms=None) for r in recs]
    assert cli.aggregate(cpu)["spread"] is None


def test_pin_sets_one_thread_and_one_cpu(one_thread):
    n = torch.get_num_threads()
    cpus = os.sched_getaffinity(0)
    try:
        out = timing.pin()
        assert out["threads"] == 1 == torch.get_num_threads()
        assert out["cpus"] == [max(cpus)] == sorted(os.sched_getaffinity(0))
    finally:
        os.sched_setaffinity(0, cpus)
        torch.set_num_threads(n)


# --- the trace parser ------------------------------------------------------------------

def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_breakdown_of_a_synthetic_trace():
    events = [
        _ev("user_annotation", trace.MARK, 0, 100),
        _ev("user_annotation", trace.MARK, 100, 100),
        _ev("gpu_user_annotation", trace.MARK, 10, 190),   # the device's copy: ignored
        _ev("cpu_op", "aten::sort", 20, 40),
        _ev("cpu_op", "aten::empty", 25, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5),
        _ev("kernel", "rollout_cost_kernel<full_body>", 10, 10),
        _ev("kernel", "sort_kernel", 60, 20),
        _ev("gpu_memcpy", "Memcpy DtoH", 85, 5),
        _ev("kernel", "rollout_cost_kernel<full_body>", 110, 10),
        _ev("kernel", "sort_kernel", 160, 30),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]
    bd = trace.breakdown(events, top=3)
    assert bd["updates"] == 2 and bd["window_us"] == 200
    assert bd["device_busy_share"] == pytest.approx(75 / 200)
    assert bd["launches_per_update"] == 2.5
    assert bd["kernel_ms"] == pytest.approx(10e-3)
    assert bd["kernel_launches_per_update"] == 1.0
    assert [o["name"] for o in bd["top_device_ops"]] == [
        "sort_kernel", "rollout_cost_kernel<full_body>", "Memcpy DtoH"]
    assert bd["top_device_ops"][0]["us_per_update"] == 25.0
    # busy [10,20] [60,80] [85,90] [110,120] [160,190]: gaps 40, 20, 40, 10, 10, 5
    gaps = bd["longest_idle_gaps"]
    assert [g["us"] for g in gaps] == [40, 40, 20]
    assert gaps[0]["host_op"] == "aten::sort" and gaps[0]["host_op_overlap_us"] == 40
    assert gaps[1]["host_op"] == "cudaLaunchKernel" and gaps[1]["at_us"] == 120
    assert gaps[2]["host_op"] == "python" and gaps[2]["at_us"] == 90
    assert [g["host_ops_cover_us"] for g in gaps] == [40, 5, 0]
    assert trace.breakdown(events, units=4)["launches_per_update"] == 1.25
    with pytest.raises(ValueError):
        trace.breakdown(events[2:])


# --- the work count ---------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("horizon", [15, 30])
@pytest.mark.parametrize("mode", [{}, {"second_moment": True}, {"accumulate": False},
                                  {"costs_in": True}])
def test_work_count_against_the_package_s(model, horizon, mode):
    """work.py counts from the algorithm, the package from its kernel
    source; where the two differ, PERF.md §6 says why: Box-Muller counts its
    integer-to-float conversions apart from their scalings (11 a pair
    against 10), the update its mask's select (+1), the tracking models carry
    7 scalar parameters (the kernel's vector 18), and the rollout and cost
    come from the model equations (within 5 % of the kernel's instruction
    count). Philox's integer instructions agree: 62 a call."""
    m2, acc, cin = (mode.get("second_moment", False), mode.get("accumulate", True),
                    mode.get("costs_in", False))
    ours = work.per_sample(model, horizon, horizon, **mode)
    pkg = _per_sample_work(model, horizon, horizon, m2, True, acc, cin)
    assert ours["philox"] == pkg["philox"]
    assert ours["box_muller"] * 10 == pkg["box_muller"] * 11
    assert ours["sample"] == pkg["sample"]
    assert ours["update"] == pkg["update"] + (1 if acc else 0)
    body, kernel = ours["rollout"] + ours["cost"], pkg["scan"] + pkg["step"]
    assert body == kernel == 0 if cin else abs(body / kernel - 1) < 0.05
    a = work.kernel_work(model, 102_400, horizon, **mode)
    b = rollout_cost_work(model, 102_400, horizon, horizon, **mode)
    assert a["bytes"] == b["bytes"] - (0 if model == "full_body" else 4 * 11)
    assert a["int_ops"] == b["int_ops"]


def test_bound_and_the_elite_update():
    w = work.kernel_work("full_body", 102_400, 30)
    ms, by = work.bound_ms(w)
    assert by == "operations" and ms == pytest.approx(w["int_ops"] / work.INT32_PEAK * 1e3)
    assert work.bound_ms({"flops": 0, "int_ops": 0, "bytes": 3.35e9})[1] == "bytes"
    elite = work.update_work("full_body", 102_400, 30, elite=True)
    one = work.kernel_work("full_body", 102_400, 30, accumulate=False)
    two = work.kernel_work("full_body", 102_400, 30, costs_in=True)
    assert elite == {k: one[k] + two[k] for k in one}
    fleet = work.update_work("unicycle", 1024, 15, num_robots=256)
    assert fleet["int_ops"] == 256 * work.kernel_work("unicycle", 1024, 15)["int_ops"]


# --- no JAX ---------------------------------------------------------------------------------

IMPORT_ALL = """
import sys
import bench_torch, bench_torch.__main__, bench_torch.cells, bench_torch.timing
import bench_torch.trace, bench_torch.work
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ccv_mppi_path_tracker_tpu", "chip_smoke"))
print("loaded:", bad)
sys.exit(1 if bad else 0)
"""


def test_importing_the_harness_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted((ROOT / "bench_torch").glob("*.py")),
                         ids=lambda p: p.name)
def test_harness_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "ccv_mppi_path_tracker_tpu",
                                              "chip_smoke"), f"{path} imports {name}"
