"""The port's benchmark: the twin of ``bench.py``'s ``main``.

    python3 -m bench_torch --cell full_body-K102400-T30 [--seed 0]
    python3 -m bench_torch --cell NAME --procs 5     # five processes, their spread
    python3 -m bench_torch --all [--procs 3]         # every cell, each in its own processes
    python3 -m bench_torch --all --quick             # short chains, no trace, one process a cell
    python3 -m bench_torch --ladder                  # the diagnostic ladder (not a cell)
    python3 -m bench_torch --list

One JSON line a cell: ``bench.py:167-181``'s keys where they apply
(``metric``, ``value``, ``unit``, ``vs_baseline`` against 1.4e6, ``model``,
``num_samples``, ``horizon``, ``kernel``, ``lean``, ``step_ms``,
``replan_hz``), with ``device`` (platform, name, count), ``card``
(``nvidia-smi``'s name and power limit), the gate's checks, the per-layer
metrics (``layers``), the traced run's ``breakdown`` and, over several
processes, ``per_process`` and ``spread`` (max - min over the median).

It runs on the card and raises where there is none: ``--device cpu`` (the
tests) runs the gates and counts, and prints no device metric. A cell whose
gate fails prints the numbers it compared and exits non-zero. A process on
the card pins itself (``bench_torch/timing.py pin``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

START = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]


def resolve_device(name):
    """torch.device for ``--device``; None is the card. No card: an error,
    never the CPU."""
    import torch

    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the card "
                           "(--device cpu runs its gates and counts only)")
    return dev


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_info(dev):
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}, None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count()}, nvidia_smi("name,power.limit")


def run_one(name, seed, dev, quick):
    """One cell in this process, pinned on the card (a CPU run times
    nothing); (record, exit code)."""
    from bench_torch import cells, timing

    pinned = timing.pin() if dev.type == "cuda" else None
    info, card = device_info(dev)
    try:
        rec = cells.run(cells.CELLS[name], seed, dev, quick=quick)
    except cells.GateError as e:
        rec, code = {"cell": name, "seed": seed, "gate": {"ok": False, "checks": e.gate}}, 1
    else:
        code = 0
    rec.update(device=info, card=card, pinned=pinned,
               process_seconds=time.perf_counter() - START)
    if card is not None:
        rec["after"] = {"clocks.sm,power.draw,temperature.gpu":
                        nvidia_smi("clocks.sm,power.draw,temperature.gpu")}
    return rec, code


def spawn(name, seed, device, quick):
    """One cell in a process of its own; (record or None, exit code,
    stderr)."""
    cmd = [sys.executable, "-m", "bench_torch", "--cell", name, "--seed", str(seed)] + (
        ["--device", device] if device else []) + (["--quick"] if quick else [])
    # a fixed hash seed: every process lays out its dicts and sets alike
    env = dict(os.environ, PYTHONHASHSEED="0", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
    rec = None
    lines = proc.stdout.strip().splitlines()
    if lines:
        try:
            rec = json.loads(lines[-1])
        except json.JSONDecodeError:
            rec = None
    return rec, proc.returncode, proc.stderr


def aggregate(records):
    """One cell's line over its processes: the first process's record with
    ``value``, ``step_ms`` and ``replan_hz`` the medians over processes,
    ``per_process`` each process's value and ``spread`` (max - min) /
    median; every process's gate."""
    out = dict(records[0])
    values = [r.get("value") for r in records]
    out["processes"] = len(records)
    out["per_process"] = values
    out["per_process_rounds_ms"] = [r.get("rounds_ms") for r in records]
    out["gates_ok"] = [r["gate"]["ok"] for r in records]
    out["gate"] = dict(out["gate"], ok=all(out["gates_ok"]))
    if all(v is not None for v in values):
        med = statistics.median(values)
        out["value"] = med
        out["spread"] = (max(values) - min(values)) / med
        out["step_ms"] = statistics.median(r["step_ms"] for r in records)
        out["replan_hz"] = 1e3 / out["step_ms"]
        if out.get("vs_baseline") is not None:
            from bench_torch.cells import BASELINE_PROPAGATIONS

            out["vs_baseline"] = med / BASELINE_PROPAGATIONS
    else:
        out["spread"] = None
    return out


def run_spawned(names, seed, device, quick, procs):
    code = 0
    for name in names:
        records = []
        for _ in range(procs):
            rec, rc, err = spawn(name, seed, device, quick)
            if rec is None:
                print(f"bench_torch: {name} printed no record (exit {rc}):\n{err[-3000:]}",
                      file=sys.stderr, flush=True)
                code = 1
                break
            records.append(rec)
            if rc != 0:
                code = 1
                print(f"bench_torch: {name} exit {rc}:\n{err[-3000:]}", file=sys.stderr,
                      flush=True)
                break
        if records:
            print(json.dumps(aggregate(records)), flush=True)
    return code


def main(argv=None):
    from bench_torch import cells

    p = argparse.ArgumentParser(prog="python3 -m bench_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--cell", choices=sorted(cells.CELLS))
    what.add_argument("--all", action="store_true")
    what.add_argument("--ladder", action="store_true")
    what.add_argument("--list", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default the card; cpu runs the gates and counts only (tests)")
    p.add_argument("--quick", action="store_true",
                   help="short chains, one run a loop, no traced run; one process a "
                        "cell with --all")
    p.add_argument("--procs", type=int, default=None,
                   help="processes a cell (default 3 with --all, 1 with --quick; "
                        "with --cell, 1 runs in this process)")
    args = p.parse_args(argv)

    if args.list:
        for c in cells.CELLS.values():
            print(f"{c.name}: {c.metric} ({c.unit}); {c.why}")
        return 0
    dev = resolve_device(args.device)
    if args.ladder:
        from bench_torch import timing, trace

        pinned = timing.pin() if dev.type == "cuda" else None
        info, card = device_info(dev)
        out = trace.ladder(args.seed, dev)
        print(json.dumps(dict(out, device=info, card=card, pinned=pinned, seed=args.seed)))
        return 0
    procs = args.procs or (3 if args.all and not args.quick else 1)
    if args.all:
        return run_spawned(list(cells.CELLS), args.seed, args.device, args.quick, procs)
    if procs > 1:
        return run_spawned([args.cell], args.seed, args.device, args.quick, procs)
    rec, code = run_one(args.cell, args.seed, dev, args.quick)
    print(json.dumps(rec), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
