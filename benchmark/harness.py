"""One run of one cell: find the cell's files by name, run its traffic, judge
what the timed path produced, and build the result's line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the names in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: what a configuration fixes (the
  ``file`` of its ``configs`` entry). Its ``program`` block may hold
  ``options``, keyword options of the port's ``mppi_step`` that the program
  passes on (``benchmark/programs.py``), and its ``reference`` key may name
  the configuration's own reference module (``benchmark/reference.py``
  says what one supplies; that file is the default);
- ``benchmark/traffic/<traffic>.json``: a mix's parameters, with its
  ``kind``, the module ``benchmark/kinds/<kind>.py`` that drives it;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(obs) -> number or None``. ``obs`` holds ``spans`` and ``traces``
  (the kind's spans and ``trace.breakdown`` of each traced window), ``shape``,
  the run's ``config`` and ``traffic`` dicts, and ``units``: for each traced
  window, every device operation of every unit (``trace.unit_ops``);
- ``benchmark/limits/<workload>.json``: the limit of each number that the
  correctness check compares in that cell.

An end-to-end metric ``<name>.<suffix>`` is the kind's ``<name>`` in the
cells it lists: one quantity split where its cells spread too differently to
share a bound.

A kind's ``run(ctx)`` returns an :class:`Outcome`; the harness then frees
the program's state, recomputes the sampled answers with the
configuration's plain reference module and compares.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark import reference

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
MARK = "benchmark.unit"
FORBIDDEN = ("jax", "jaxlib", "flax", "ccv_mppi_path_tracker_tpu", "bench_torch")


# --- finding a cell's files ------------------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(bench: dict, key: str, name: str) -> dict:
    for entry in bench[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix and limits, by name."""
    cell = find(bench, "workloads", workload)
    conf_entry = find(bench, "configs", cell["config"])
    here = root / HERE.name
    return {"cell": cell,
            "config": load_json(root / conf_entry["file"]),
            "traffic": load_json(here / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(here / "limits" / f"{workload}.json")}


def reference_module(config: dict, root: Path = ROOT):
    """The configuration's reference module: the file its ``reference`` key
    names (a path under ``benchmark/`` from the checkout's root), or
    ``benchmark/reference.py``."""
    name = config.get("reference")
    if name is None:
        return reference
    parts = Path(name).parts
    if Path(name).is_absolute() or parts[:1] != (HERE.name,) or ".." in parts:
        raise ValueError(f"a configuration's reference is a file under {HERE.name}/, "
                         f"not {name!r}")
    label = "benchmark_reference_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(label, root / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in ("update", "num_states", "plant") if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"the reference module {name} lacks {', '.join(missing)}")
    return mod


def kind_module(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    label = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, key: str, workload: str) -> list:
    """The entries of ``key`` ("end_to_end" or "per_layer") this cell reports."""
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


# --- what a kind gets and gives ---------------------------------------------------------

@dataclasses.dataclass
class Answer:
    """One output of the timed path kept for the check: update (tick, cycle)
    ``n`` of the chain, the program's carried state going in (its warm
    start (B, T-1, U), step and key), its output of unit n-1 (``prev_out``;
    zeros for unit 0) and of unit n (``out``), and the poses (B, S) it was
    given. The reference starts unit 0 from its own zero warm start. A serving
    cycle adds what was read back: u0, the command and its mode."""

    n: int
    u_prev: torch.Tensor
    prev_out: torch.Tensor
    step: Optional[int]
    key: Optional[torch.Tensor]
    out: torch.Tensor
    poses: np.ndarray
    read: Optional[dict] = None


@dataclasses.dataclass
class Outcome:
    metrics: dict                 # end-to-end values by name
    attempted: int                # units of work in the window
    setup_end: float              # perf_counter when the first timed call began
    answers: list
    memory_peak: int
    spans: dict = dataclasses.field(default_factory=dict)
    traces: dict = dataclasses.field(default_factory=dict)
    units: dict = dataclasses.field(default_factory=dict)   # trace.unit_ops by window


@dataclasses.dataclass
class Context:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    traffic: dict
    program: object
    course: np.ndarray
    rng: np.random.Generator
    reference: object             # the configuration's reference module


class Sample:
    """A uniform sample of ``size`` of the units offered, drawn from the seed
    as they come (reservoir sampling): ``offer(i)`` gives the slot unit i
    takes, or None."""

    def __init__(self, seed: int, size: int):
        self.rng, self.size = random.Random(seed), size

    def offer(self, i: int):
        if i < self.size:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.size else None


def inputs_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed % 2**64)


def course_for(config: dict, traffic: dict, rng) -> np.ndarray:
    off = traffic["course_offset_m"]
    return reference.course(config["course"], tuple(rng.uniform(-off, off, 2)))


def start_pose(course: np.ndarray, num_states: int, rng, sigma) -> np.ndarray:
    """The first course point, headed along the course, perturbed by ``sigma``
    (x, y, yaw)."""
    pose = np.zeros(num_states)
    heading = math.atan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    pose[:3] = course[0, 0], course[0, 1], heading
    pose[:3] += rng.normal(0.0, sigma)
    return pose.astype(np.float32)


def respawn(poses: np.ndarray, starts: np.ndarray, course: np.ndarray, before_end: float):
    """Robots within ``before_end`` metres of the course's end (in x) start
    their lap again from their start pose."""
    done = poses[:, 0] >= course[-1, 0] - before_end
    if done.any():
        poses = np.where(done[:, None], starts, poses)
    return poses


# --- the check ------------------------------------------------------------------------

def _gap(a: float, b: float, angle: bool) -> float:
    if math.isnan(a) and math.isnan(b):
        return 0.0
    d = abs(a - b)
    if angle and math.isfinite(d):
        d = abs((a - b + math.pi) % (2.0 * math.pi) - math.pi)
    return d if math.isfinite(d) else math.inf


def judge(answers: list, config: dict, course: np.ndarray, seed: int, device,
          limits: dict, ref=reference):
    """The numbers compared over every kept answer, and how many answers broke
    a limit, against the reference module ``ref``:

    - ``u_gap``: the largest gap between the program's u_opt and the
      reference's, each control channel over its box width;
    - where ``ref`` has ``update_marked``, ``undecided``: the robots' updates
      that it marks undecidable (a discrete choice of the algorithm within
      rounding of its threshold), which ``u_gap`` leaves out;
    - ``carry``: answers whose carried state was not the previous output
      (the warm start bit for bit, the step and the key [seed, n]);
    - with a serving cycle's read, ``cmd_gap``: the largest gap (m/s, rad/s,
      rad; angles wrapped) between the command read back and the reference's
      command geometry from the u0 read back, and ``mode_miss``: cycles whose
      steering mode differs from the reference's where no angle lies on a
      threshold."""
    sol = config["solver"]
    box = (torch.tensor(sol["u_max"], dtype=torch.float64)
           - torch.tensor(sol["u_min"], dtype=torch.float64)).to(device)
    marked = getattr(ref, "update_marked", None)
    out, failed = {"u_gap": 0.0, "carry": 0}, 0
    if marked is not None:
        out["undecided"] = 0
    for a in answers:
        args = (config, course, torch.from_numpy(a.poses).to(device),
                None if a.n == 0 else a.u_prev, seed, a.n)
        got = a.out.to(device=device, dtype=torch.float64)
        if marked is None:
            gap = ((got - ref.update(*args).double()).abs() / box).max().item()
        else:
            want, undecided = marked(*args)
            diff = ((got - want.double()).abs() / box)[~undecided.to(device)]
            gap = diff.max().item() if diff.numel() else 0.0
        one = {"u_gap": gap if math.isfinite(gap) else math.inf}
        bad = not torch.equal(a.u_prev, a.prev_out)
        bad |= a.step is not None and a.step != a.n
        bad |= a.key is not None and a.key.tolist() != [seed, a.n]
        one["carry"] = int(bad)
        if marked is not None:
            one["undecided"] = int(undecided.sum())
        if a.read is not None:
            want = getattr(ref, "command", reference.command)(
                config["model"], a.read["u0"], a.read["dt"], config["command"])
            one["cmd_gap"] = max(_gap(a.read[name], v, name.startswith("steer"))
                                 for name, v in want.items())
            mode = getattr(ref, "steering_mode", reference.steering_mode)(
                a.read["steer_r"], a.read["steer_l"])
            one["mode_miss"] = int(mode is not None and mode != a.read["mode"])
        for name, value in one.items():
            out[name] = max(out.get(name, 0), value) if name.endswith("gap") else (
                out.get(name, 0) + value)
        failed += any(not (value <= limits[name]) for name, value in one.items())
    return out, failed


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    if not (name.startswith("void ") and name.endswith(")")):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += (name[i] == ")") - (name[i] == "(")
        if depth == 0:
            return name[:i].rstrip()
    return name


# --- one run --------------------------------------------------------------------------

def device_info(device, memory_peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": memory_peak}


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        process_start: float, program=None, config_overrides=None,
        traffic_overrides=None, root: Path = ROOT):
    """One run of ``workload``: returns (the result's line as a dict, the
    lines for standard error). ``program`` (``programs.Port`` by default) is
    built from the configuration, the course and the configuration's
    reference module; ``*_overrides`` change the configuration or the mix
    (the tests' small sizes). A reference that marks undecidable answers
    needs a limit for ``undecided`` in the cell's limits file: without one
    the run raises before its window."""
    from benchmark import programs

    bench = load_benchmark(root)
    files = cell_files(bench, workload, root)
    config = dict(files["config"], **(config_overrides or {}))
    traffic = dict(files["traffic"], **(traffic_overrides or {}))
    limits = files["limits"]
    ref = reference_module(config, root)
    if hasattr(ref, "update_marked") and "undecided" not in limits:
        raise ValueError(f"{workload}'s reference marks undecided answers, and its limits "
                         f"file has no limit for undecided")
    rng = inputs_rng(seed)
    course = course_for(config, traffic, rng)
    if program is None:
        program = programs.Port
    prog = program(config, device, course, ref)
    ctx = Context(seed, seconds, trace, device, config, traffic, prog, course, rng, ref)
    try:
        outcome = kind_module(traffic["kind"]).run(ctx)
    finally:
        getattr(prog, "restore", lambda: None)()
        gc.unfreeze()
    del ctx, prog
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    with torch.no_grad():
        compared, failed = judge(outcome.answers, config, course, seed, device, limits, ref)
    checks = {name: {"value": compared[name], "limit": limits[name]}
              for name in compared}
    stderr = [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
              for name, c in checks.items()]

    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": outcome.attempted, "failed": failed}
    metrics = {}
    if not trace:
        for m in metrics_of(bench, "end_to_end", workload):
            if m["name"] == "setup_s":
                value = outcome.setup_end - process_start
            else:   # "propagations_per_s.node" is the kind's "propagations_per_s"
                value = outcome.metrics[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        obs = {"spans": outcome.spans, "traces": outcome.traces, "units": outcome.units,
               "config": config, "traffic": traffic,
               "shape": {"model": config["model"], "num_samples": config["num_samples"],
                         "horizon": config["horizon"],
                         "robots": traffic.get("robots", 1)}}
        for m in metrics_of(bench, "per_layer", workload):
            value = reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = device_info(device, outcome.memory_peak)
    if trace and outcome.traces:
        (bd,) = outcome.traces.values()
        line["device"].update(busy_s=bd["busy_us"] / 1e6, window_s=bd["window_us"] / 1e6)
        line["breakdown"] = {
            "device_ops": [[short(o["name"]), o["us"] / 1e6]
                           for o in bd["top_device_ops"][:10]],
            "idle_gaps": [[g["host_op"], g["us"] / 1e6] for g in bd["longest_idle_gaps"][:10]]}
    line["checks"] = checks
    return line, stderr
