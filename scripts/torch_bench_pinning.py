#!/usr/bin/env python3
"""The spread between processes of one commit, by what each process pins.

    python3 scripts/torch_bench_pinning.py [--cells NAME ...] [--rounds 3]
        [--out bench_pinning.json]

For each cell, runs ``rounds`` processes of the benchmark's cell under each
mode (none: torch's default threads on every CPU; threads: one intra-op
thread; core: one thread on one CPU, ``bench_torch/timing.py pin``, what the
benchmark does), the modes in turns and their order reversed every round,
and prints each mode's per-process values and their spread, (max - min) over
the median. Each process is this script again with ``--child``: it sets its
mode itself, then runs the cell through ``bench_torch.cells.run``. Needs the
card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ("none", "threads", "core")


def child(mode, name, seed):
    """One cell in this process under ``mode``; prints its record."""
    import torch

    from bench_torch import cells, timing

    if mode == "core":
        timing.pin()
    elif mode == "threads":
        torch.set_num_threads(1)
    rec = cells.run(cells.CELLS[name], seed, torch.device("cuda"))
    rec.update(pin=mode, threads=torch.get_num_threads(),
               cpus=sorted(os.sched_getaffinity(0)))
    print(json.dumps(rec), flush=True)


def spawn(mode, name, seed):
    env = dict(os.environ, PYTHONHASHSEED="0", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, __file__, "--child", mode, name, str(seed)],
                          cwd=ROOT, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} pin {mode}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cells", nargs="+",
                   default=["full_body-K102400-T30", "unicycle-K102400-T30"])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--child", nargs=3, metavar=("MODE", "CELL", "SEED"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        mode, name, seed = args.child
        return child(mode, name, int(seed))

    out = {}
    for name in args.cells:
        runs = {m: [] for m in MODES}
        for r in range(args.rounds):
            for mode in (MODES if r % 2 == 0 else MODES[::-1]):
                runs[mode].append(spawn(mode, name, args.seed))
        out[name] = {}
        for mode, recs in runs.items():
            values = [r["value"] for r in recs]
            med = statistics.median(values)
            row = {"values": values, "step_ms": [r["step_ms"] for r in recs],
                   "rounds_ms": [r["rounds_ms"] for r in recs],
                   "spread": (max(values) - min(values)) / med, "median": med,
                   "layers": [r["layers"] for r in recs],
                   "threads": [r["threads"] for r in recs], "cpus": [r["cpus"] for r in recs]}
            out[name][mode] = row
            print(json.dumps({"cell": name, "pin": mode, "median": med,
                              "spread": row["spread"], "step_ms": row["step_ms"],
                              "host_enqueue_us": [lay.get("host_enqueue_us_per_update")
                                                  for lay in row["layers"]]}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(out, card=card), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
