"""Command-line interface of the port (the ``run`` and ``fleet``
subcommands).

    python -m ccv_mppi_path_tracker_tpu_torch run --preset full_body --steps 200 \\
        --num-samples 102400 --horizon 30

runs a closed-loop tracking experiment on a launch-file preset (diff_drive,
steering_diff_drive or full_body; diff_drive by default) through the
fused CUDA kernel (``--no-kernel``: the eager path) and prints the
calc_e_rmse.py metrics, as the JAX package's ``run`` does.

    python -m ccv_mppi_path_tracker_tpu_torch fleet --robots 64 --steps 200

runs a fleet of robots (64 by default) on the preset's course, all of them
in one fused-kernel launch per tick (``--no-kernel``: the eager arm), and
prints the RMSE over robots and the robot-updates per second.
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


def _resolve(args):
    """(device, cfg, sp, cp, course) of the preset on the requested device;
    device None when a CUDA device was asked for and there is none."""
    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: device {args.device} requested but CUDA is not available",
              file=sys.stderr)
        return (None,) * 5
    kwargs = {"horizon": args.horizon, "device": device}
    if args.num_samples:
        kwargs["num_samples"] = args.num_samples
    return (device,) + PRESETS[args.preset](**kwargs)


def cmd_run(args):
    from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment

    device, cfg, sp, cp, course = _resolve(args)
    if device is None:
        return 2
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


def cmd_fleet(args):
    """Fleet serving demo: B robots per tick, one kernel launch per tick."""
    import time

    import numpy as np

    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.solver.batch import build_fleet_step, init_fleet

    device, cfg, sp, cp, course = _resolve(args)
    if device is None:
        return 2
    path = PathBuffer.from_points(course, 0.1, device=device)
    model = get_model(cfg.model)
    num_robots = args.robots
    states = torch.zeros((num_robots, model.num_states), device=device)
    states[:, 1] = float(course[0, 1])
    dt = torch.full((), args.dt, device=device)
    use_kernel = not args.no_kernel
    step = build_fleet_step(cfg, use_kernel=use_kernel)
    ctrls = init_fleet(cfg, num_robots, seed=args.seed, device=device)
    traj = [states]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        ctrls, res = step(ctrls, states, path, dt, sp, cp)
        states = model.step(states, res.u0, dt)
        traj.append(states)
    traj = torch.stack(traj).cpu().numpy()  # (steps+1, B, S); waits for the card
    wall = time.perf_counter() - t0
    rmses = [tracking_metrics(traj[:, b, :2], course, dt=args.dt)["rmse"]
             for b in range(num_robots)]
    print(f"fleet: {num_robots} robots x K={cfg.num_samples}, {args.steps} ticks, "
          f"{'kernel' if use_kernel else 'eager'} path on {device}")
    print(f"RMSE mean={np.mean(rmses):.3f} worst={np.max(rmses):.3f}")
    print(f"wall: {wall:.2f} s = {num_robots * args.steps / wall:,.0f} robot-updates/s "
          f"(host clock)")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="ccv_mppi_path_tracker_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="closed-loop tracking experiment")
    _add_run_args(pr)
    pr.set_defaults(fn=cmd_run)
    pf = sub.add_parser("fleet", help="batched multi-robot serving demo")
    _add_run_args(pf)
    pf.add_argument("--robots", type=int, default=64)
    pf.set_defaults(fn=cmd_fleet)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
