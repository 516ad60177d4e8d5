"""Command-line interface of the port (the ``run`` subcommand).

    python -m ccv_mppi_path_tracker_tpu_torch run --preset full_body --steps 200 \\
        --num-samples 102400 --horizon 30

runs a closed-loop tracking experiment on a launch-file preset (diff_drive,
steering_diff_drive or full_body; diff_drive by default) through the
fused CUDA kernel (``--no-kernel``: the eager path) and prints the
calc_e_rmse.py metrics, as the JAX package's ``run`` does.
"""

from __future__ import annotations

import argparse
import sys

import torch


def _add_run_args(p):
    p.add_argument("--preset", default="diff_drive",
                   choices=["diff_drive", "steering_diff_drive", "full_body"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--horizon", type=int, default=15)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; a CUDA device that is not there is an "
                        "error, never a fallback to the CPU")
    p.add_argument("--no-kernel", action="store_true",
                   help="run the eager tensor path instead of the fused kernel")
    p.add_argument("--shift-warm-start", action="store_true",
                   help="center sampling on the one-step-shifted previous "
                        "optimum (the reference does not shift)")
    p.add_argument("--delay", type=float, default=None,
                   help="actuation-latency compensation in seconds: solve "
                        "from the delay-predicted state")
    p.add_argument("--elite-frac", type=float, default=None,
                   help="keep softmax weight only on this best cost fraction "
                        "of the samples (on the kernel and eager paths)")


def cmd_run(args):
    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: device {args.device} requested but CUDA is not available",
              file=sys.stderr)
        return 2
    kwargs = {"horizon": args.horizon, "device": device}
    if args.num_samples:
        kwargs["num_samples"] = args.num_samples
    cfg, sp, cp, course = PRESETS[args.preset](**kwargs)
    opts = {}
    if args.shift_warm_start:
        opts["shift_warm_start"] = True
    if args.delay is not None:
        opts["delay"] = args.delay
    if args.elite_frac is not None:
        opts["elite_frac"] = args.elite_frac
    use_kernel = not args.no_kernel
    print(f"solver path: {'fused kernel' if use_kernel else 'eager'} on {device}")
    out = run_tracking_experiment(
        cfg, sp, cp, course, num_steps=args.steps, dt=args.dt, seed=args.seed,
        use_kernel=use_kernel, solver_options=opts or None,
    )
    m = out["metrics"]
    print(f"Time: {round(m['time'], 1)}")
    print(f"Max Error: {round(m['max_error'], 3)}")
    print(f"RMSE Error: {round(m['rmse'], 3)}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="ccv_mppi_path_tracker_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="closed-loop tracking experiment")
    _add_run_args(pr)
    pr.set_defaults(fn=cmd_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
