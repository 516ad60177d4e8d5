"""The harness at small sizes on the CPU: every file ``BENCHMARK.json`` names
is found by name, its names keep to the allowed characters, a run prints the
result's keys, the control and each planted fault come out not correct, and
nothing a run imports is JAX, the JAX package or ``bench_torch``.

The serving cell ``full_body.serve-100hz`` is not in ``BENCHMARK.json`` (its
runs spread too widely for a bound, PERF.md); its harness is held here by a
benchmark file that adds it back (:data:`SERVE_ENTRIES`)."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness, programs

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"num_samples": 96, "horizon": 8}
QUICK = {"warmup_units": 2, "trace_units": 4, "check_sample": 2}
ROBOTS = {"robots": 5}
SERVE = "full_body.serve-100hz"
SERVE_ENTRIES = {
    "workloads": [{"name": SERVE, "config": "full_body-K102400-T30", "traffic": "serve-100hz",
                   "chips": 1, "why": "one live robot, poses due every 10 ms"}],
    "end_to_end": [{"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": [SERVE]}
                   for n in ("cycle_ms_p95", "cycle_ms_mean")],
    "per_layer": [{"name": n, "unit": u, "better": "lower", "source": src, "layer": layer,
                   "moves": "cycle_ms_mean", "workloads": [SERVE]}
                  for n, u, src, layer in (("serve.glue_ms", "ms", "host_clock", "serving cycle"),
                                           ("call_host_us.serve", "us", "host_clock",
                                            "compiled call"),
                                           ("device_idle.serve", "%", "device_trace", "device"))]}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def serve_root(tmp_path_factory):
    """A checkout whose BENCHMARK.json adds the serving cell back."""
    root = tmp_path_factory.mktemp("serve_root")
    bench = {k: v + SERVE_ENTRIES.get(k, []) if isinstance(v, list) else v
             for k, v in BENCH.items()}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark").symlink_to(ROOT / "benchmark")
    return root


def run(cell, seed=2**31 + 99, trace=False, seconds=0.25, program=None, root=ROOT):
    traffic = dict(QUICK, **(ROBOTS if "fleet" in cell else {}))
    return harness.run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                       program=program, config_overrides=SMALL, traffic_overrides=traffic,
                       root=root)


def test_the_contract_s_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "benchmark"] and BENCH["paths"] == ["benchmark"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_file_is_found_by_name():
    for cell in CELLS:
        files = harness.cell_files(BENCH, cell, ROOT)
        assert harness.kind_module(files["traffic"]["kind"]).run
        assert set(files["limits"]) >= {"u_gap", "carry"}
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.metrics_of(BENCH, "end_to_end", cell)}
    for cell in CELLS:
        reported = harness.metrics_of(BENCH, "end_to_end", cell)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.metrics_of(BENCH, "per_layer", cell)


@pytest.mark.parametrize("cell", CELLS + [SERVE])
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_s_line(cell, trace, serve_root):
    line, stderr = run(cell, trace=trace, root=serve_root if cell == SERVE else ROOT)
    bench = harness.load_benchmark(serve_root)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["checks"])        # no breakdown without a trace on a card
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = harness.metrics_of(bench, "per_layer" if trace else "end_to_end", cell)
    got = set(line["metrics"])
    if trace:
        assert got and got <= {m["name"] for m in want}   # device readers read nothing here
    else:
        assert got == {m["name"] for m in want}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert [s.split(":")[0] for s in stderr] == [f"check {k}" for k in line["checks"]]
    json.dumps(line)


def test_the_line_with_a_breakdown():
    """A traced line as a card's trace would give it: breakdown and the
    device's busy and window seconds (a synthetic trace)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": harness.MARK, "ts": 0, "dur": 100},
              {"ph": "X", "cat": "user_annotation", "name": harness.MARK, "ts": 200, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "void rollout_cost_kernel<3>(float*)",
               "ts": 20, "dur": 50},
              {"ph": "X", "cat": "kernel", "name": "void rollout_cost_kernel<3>(float*)",
               "ts": 220, "dur": 50},
              {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 100, "dur": 60}]
    from benchmark import trace
    bd = trace.breakdown(events, harness.MARK)
    assert bd["units"] == 2 and bd["window_us"] == 300 and bd["busy_us"] == 100
    assert bd["kernel_ms"] == 0.05 and bd["inside_idle_share"] == pytest.approx(0.5)
    assert bd["longest_idle_gaps"][0] == {"us": 150, "at_us": 70, "host_op": "aten::cat"}
    assert harness.short(events[2]["name"]) == "void rollout_cost_kernel<3>"
    read = harness.reader("rollout_cost_roofline.update")
    obs = {"traces": {"update": bd}, "shape": {"model": "full_body", "num_samples": 102400,
                                               "horizon": 30, "robots": 1}}
    assert read(obs) == pytest.approx(100 * 0.0164879 / 0.05, rel=1e-4)
    assert harness.reader("device_idle.serve")({"traces": {"cycle": bd}}) == pytest.approx(50)
    assert harness.reader("device_idle.update")({"traces": {}}) is None


def test_same_seed_same_inputs():
    """The course and the start pose come from the seed alone (a large one
    too); the window's length decides only how many units run."""
    files = harness.cell_files(BENCH, "full_body.update", ROOT)

    def inputs(seed):
        rng = harness.inputs_rng(seed)
        course = harness.course_for(files["config"], files["traffic"], rng)
        return course, harness.start_pose(course, 5, rng, files["traffic"]["pose_sigma"])

    for a, b in zip(inputs(2**33 + 1), inputs(2**33 + 1)):
        assert (a == b).all()
    assert not (inputs(2**33 + 1)[1] == inputs(2**33 + 2)[1]).all()


def test_sample_is_uniform_and_seeded():
    picks = []
    for seed in range(400):
        s = harness.Sample(seed, 2)
        kept = [None, None]
        for i in range(10):
            slot = s.offer(i)
            if slot is not None:
                kept[slot] = i
        picks += kept
    counts = [picks.count(i) for i in range(10)]
    assert min(counts) > 50 and max(counts) < 110


@pytest.mark.parametrize("cell", CELLS + [SERVE])
def test_the_control_is_not_correct(cell, serve_root):
    """The plain reference in bfloat16 in the update's place fails u_gap."""
    line, _ = run(cell, program=programs.Control, root=serve_root)
    assert line["correct"] is False
    assert line["checks"]["u_gap"]["value"] > line["checks"]["u_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS + [SERVE])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(cell, fault, serve_root):
    line, _ = run(cell, program=faults.FAULTS[fault], root=serve_root)
    assert line["correct"] is False and line["failed"] >= 1
    if fault == "stale_state":
        assert line["checks"]["carry"]["value"] > 0
    if fault == "altered" and "serve" in cell:
        assert line["checks"]["cmd_gap"]["value"] > line["checks"]["cmd_gap"]["limit"]
        assert line["checks"]["mode_miss"]["value"] > 0


def test_half_batch_is_undone():
    from ccv_mppi_path_tracker_tpu_torch.solver import batch, mppi

    before = (mppi.fused_sample_rollout_cost, batch.fused_sample_rollout_cost)
    run("full_body.update", program=faults.HalfBatch)
    assert (mppi.fused_sample_rollout_cost, batch.fused_sample_rollout_cost) == before


def test_the_command_refuses_without_a_card():
    """This machine's torch has no CUDA: the command exits non-zero and
    prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run([sys.executable, "-m", "benchmark", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""


IMPORTS = """
import sys, time, torch
from benchmark import __main__, harness, programs, reference, timing, trace, work
from benchmark.kinds import chained_update, fleet_tick, open_loop_serve
line, _ = harness.run("full_body.update", 3, 0.1, True, torch.device("cpu"), time.perf_counter(),
                      config_overrides={"num_samples": 32, "horizon": 6})
for m in harness.load_benchmark()["per_layer"]:
    harness.reader(m["name"])
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_nothing_a_run_imports_is_jax():
    """In a fresh process: the harness, the reference, the kinds, the
    readers and the port as a run drives it; every top-level module name,
    whole (the port's name begins with the JAX package's)."""
    out = subprocess.run([sys.executable, "-c", IMPORTS], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    tops = set(eval(out))
    assert "ccv_mppi_path_tracker_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.card
def test_the_control_fails_on_the_card(card):
    """The control at the cell's own size on the card (three seeds on the
    chip set its upper reading, PERF.md)."""
    line, _ = harness.run("diff_drive.update", 2**31 + 5, 0.5, False, card, time.perf_counter(),
                          program=programs.Control)
    assert line["correct"] is False
