"""Run one cell of the benchmark once, on the card.

    python3 -m benchmark --workload full_body.update --seed 7 --seconds 20 --trace 0

It loads the cell's configuration and traffic (named in ``BENCHMARK.json``),
makes the inputs from ``--seed``, warms up, measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one JSON
object as the last line of standard output: ``correct``, ``attempted`` (units of
work in the window: updates, robot-updates, cycles), ``failed`` (checked answers that
broke a limit), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit; those also end standard
error. Without a CUDA card it exits non-zero and prints no result; so it does
if JAX, ``bench_torch`` or the JAX package got imported.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# The program's caches at fixed paths inside the checkout, so that only a
# checkout's first run builds; the port builds its nvcc libraries into
# build/torch_kernels/ there itself.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.find(harness.load_benchmark(ROOT), "workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # load from one process with few threads
    line, stderr = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
    if loaded:
        print(f"benchmark: the run imported {', '.join(loaded)}", file=sys.stderr)
        return 3
    for text in stderr:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
