"""The readings the correctness limits are set from, on the card.

    python3 -m benchmark.readings --workload full_body.update --seeds 1,2,3 \\
        --seconds 2 [--program port|control|stale_state|half_batch|altered]

For each seed, one run of the cell in this process as the benchmark runs it
(``harness.run``), with a short window at the cell's own sizes and load, and
the numbers it compared. With the port (the default) they give the lower
reading of each limit, the largest over sound seeds; with ``control`` (the
plain reference in bfloat16 in the update's place, ``programs.Control``) or a
fault of ``benchmark/faults.py`` the upper one, the smallest. One JSON line a
run. The benchmark's own runs never run these programs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import faults, harness, programs

PROGRAMS = dict(port=programs.Port, control=programs.Control, **faults.FAULTS)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", choices=sorted(PROGRAMS), default="port")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        try:
            line, _ = harness.run(args.workload, seed, args.seconds, False, dev, t0,
                                  program=PROGRAMS[args.program])
            out = {"correct": line["correct"], "checks": line["checks"],
                   "attempted": line["attempted"]}
        except Exception as e:  # a control that crashes sets no reading
            out = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(dict(out, workload=args.workload, seed=seed, program=args.program,
                              seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
