#!/usr/bin/env python3
"""Multi-process sample-sharded MPPI demo of the PyTorch port (the twin of
scripts/multihost_demo.py): the full-body closed loop with its K samples
split over every rank of a ``torch.distributed`` group.

    python3 scripts/torch_multihost_demo.py --num-samples 131072 --steps 50 --kernel
    torchrun --nproc-per-node N scripts/torch_multihost_demo.py --kernel

Under a launch (``torchrun``, or ``MASTER_ADDR``/``WORLD_SIZE``/``RANK`` set)
each rank joins the group over NCCL on its card (``cuda:LOCAL_RANK``);
without one the script forms a group of one over NCCL on ``cuda:0``, the
counterpart of the JAX demo's mesh over every local device. ``--device cpu``
runs a group over gloo on the CPU. Over NCCL a closed-loop cycle is one CUDA
graph with its collectives inside (parallel/sharded.py
build_sharded_simulate), replayed once a cycle. Rank 0 prints the JAX
demo's lines, then the captures and the kernel launches of every rank.
Imports torch and numpy only.
"""

import argparse
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join(device):
    """(launched, group, device) of this rank: the launch's group, or a
    group of one where no launch is configured; over gloo on the CPU, else
    over NCCL."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.parallel import initialize_multihost, samples_group

    backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    launched = initialize_multihost(backend=backend)
    if not launched:
        initialize_multihost(f"localhost:{free_port()}", 1, 0, backend=backend, timeout_s=120)
    group, device = samples_group(device)
    return launched, group, device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-samples", type=int, default=131072)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--kernel", action="store_true")
    p.add_argument("--device", default=None,
                   help="this rank's device (default: cuda:LOCAL_RANK, cuda:0 alone)")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
        philox_normals_cuda,
    )
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.parallel import (
        build_sharded_simulate,
        shutdown_multihost,
    )
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime.loop import CYCLE

    launched, group, device = join(args.device)
    try:
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        if rank == 0:
            print(f"distributed={launched} processes={dist.get_world_size()} devices={n}",
                  flush=True)
        k = (args.num_samples // n) * n
        cfg, sp, cp, course = full_body_launch(num_samples=k, horizon=args.horizon,
                                               device=device)
        path = PathBuffer.from_points(course, 0.1, device=device)
        sim = build_sharded_simulate(cfg, group, num_steps=args.steps, use_kernel=args.kernel)

        ctrl = ControllerState.initial(0, cfg.horizon, 5, device=device)
        slope = float(np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0]))
        state0 = torch.tensor([course[0, 0], course[0, 1], slope, 0.0, 0.0],
                              dtype=torch.float32, device=device)
        # the eager arm's launches are its draw's (ops/sampling.py)
        counted = fused_sample_rollout_cost if args.kernel else philox_normals_cuda
        launches, captures = counted.launches, CYCLE.captures
        t0 = time.time()
        ctrl, logs = sim(ctrl, state0, path, torch.full((), 0.1, device=device), sp, cp)
        states = logs["state"].cpu().numpy()
        wall = time.time() - t0
        final = states[-1]
        per_rank = [None] * n
        dist.all_gather_object(per_rank, (counted.launches - launches,
                                          CYCLE.captures - captures), group=group)
        if rank == 0:
            m = tracking_metrics(states[:, :2], course)
            print(f"{args.steps} cycles at K={k} over {n} devices in {wall:.1f}s "
                  f"(incl. compile): RMSE={m['rmse']:.3f} final={final[:2]}", flush=True)
            print(f"compiled={sim.compiled} ({dist.get_backend(group)} on {device}); "
                  f"captures a rank {[c for _, c in per_rank]}; "
                  f"{'kernel' if args.kernel else 'draw'} launches a rank "
                  f"{[n_ for n_, _ in per_rank]}", flush=True)
    finally:
        shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main())
