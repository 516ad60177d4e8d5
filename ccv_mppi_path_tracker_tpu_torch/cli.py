"""Command-line interface of the port.

    python -m ccv_mppi_path_tracker_tpu_torch run --preset full_body --steps 200 \\
        --num-samples 102400 --horizon 30
    python -m ccv_mppi_path_tracker_tpu_torch run --preset diff_drive --record log/ \\
        --course dkan --save-ckpt ck.npz --plot out.png --animate run.html
    python -m ccv_mppi_path_tracker_tpu_torch run --resume-ckpt ck.npz
    python -m ccv_mppi_path_tracker_tpu_torch realtime --preset full_body --hz 10
    python -m ccv_mppi_path_tracker_tpu_torch realtime --pipelined --micro-batch 4
    python -m ccv_mppi_path_tracker_tpu_torch compare --preset diff_drive
    python -m ccv_mppi_path_tracker_tpu_torch course --kind dkan --out course.csv
    python -m ccv_mppi_path_tracker_tpu_torch fleet --robots 64 --steps 200
    python -m ccv_mppi_path_tracker_tpu_torch sysid --seed 0
    python -m ccv_mppi_path_tracker_tpu_torch export --preset full_body --out step.pt2
    python -m ccv_mppi_path_tracker_tpu_torch profile --preset full_body --steps 20

``run`` is a closed-loop tracking experiment on a launch-file preset
(diff_drive, steering_diff_drive or full_body; diff_drive by default); it
prints the calc_e_rmse.py metrics, as the JAX package's ``run`` does, and can
record the reference-layout CSV, swap the course, save or resume the
controller state, and draw the tracking figures and a per-cycle animation
(``--plot``, ``--plot-yaw``, ``--animate``; these need matplotlib).
``realtime`` paces the loop at ``--hz`` on the native scheduler
(``--pipelined``: dispatch the next update before fetching this one's
command); ``compare`` pits MPPI against pure pursuit; ``course`` writes a
course CSV; ``fleet`` runs many robots in one kernel launch a tick; ``sysid``
recovers a droopy plant's actuator gains by Adam through the model step;
``export`` serializes the eager control step with ``torch.export``;
``profile`` writes a ``torch.profiler`` trace of control cycles and a phase
summary. ``--kernel`` forces the fused CUDA kernel and ``--no-kernel`` the
eager path; with neither, the solver path is chosen by
``kernels/rollout_cost.py should_use_kernel`` (auto); on the card either
path replays as a CUDA graph, and the "solver path" line says so. Every
subcommand but ``course`` runs on ``--device`` (``cuda`` by default; a CUDA
device that is not there is an error, never a fallback).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _add_run_args(p, kernel_flags=True):
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
    p.add_argument("--course", default="preset",
                   choices=["preset", "sin", "dkan", "square", "circle"],
                   help="replace the preset's course (e.g. --course dkan "
                        "mirrors launch/dkan_diff_drive_mppi.launch)")
    if not kernel_flags:
        return  # export pins the eager path (torch.export cannot trace the kernel)
    kg = p.add_mutually_exclusive_group()
    kg.add_argument("--kernel", action="store_true",
                    help="force the fused CUDA kernel (default: auto, the kernel "
                         "for a built-in model on a CUDA device, "
                         "kernels/rollout_cost.py should_use_kernel)")
    kg.add_argument("--no-kernel", action="store_true",
                    help="force the eager tensor path")


def _add_plot_args(p):
    p.add_argument("--plot", default=None,
                   help="save the tracking figure (graph2.py layout) to this file")
    p.add_argument("--plot-yaw", default=None,
                   help="save the yaw-vs-path-yaw figure (graph3.py layout) to this file")
    p.add_argument("--animate", default=None,
                   help="write a per-cycle animation (.html or .gif) of the candidate, "
                        "optimal and reference paths, the rviz view")
    p.add_argument("--animate-candidates", type=int, default=24,
                   help="candidate rollouts drawn a frame (eager path only)")


def _kernel_choice(args, cfg, device):
    """(use_kernel, auto) from --kernel / --no-kernel, or, with neither,
    should_use_kernel for this model and device (auto)."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import should_use_kernel

    if args.kernel or args.no_kernel:
        return args.kernel, False
    return should_use_kernel(cfg.model, device), True


def _print_path(use_kernel, auto, device):
    replay = ", replayed as a CUDA graph" if torch.device(device).type == "cuda" else ""
    print(f"solver path: {'fused kernel' if use_kernel else 'eager'}"
          f"{' (auto)' if auto else ''} on {device}{replay}")


def _add_solver_args(p):
    p.add_argument("--shift-warm-start", action="store_true",
                   help="center sampling on the one-step-shifted previous "
                        "optimum (the reference does not shift)")
    p.add_argument("--delay", type=float, default=None,
                   help="actuation-latency compensation in seconds: solve "
                        "from the delay-predicted state")
    p.add_argument("--elite-frac", type=float, default=None,
                   help="keep softmax weight only on this best cost fraction "
                        "of the samples (on the kernel and eager paths)")


def _course(kind):
    """The --course override as a float32 (N, 2) array."""
    from ccv_mppi_path_tracker_tpu_torch.paths import (
        circle_course,
        dkan_course,
        filtered_square_course,
        spline_resample_course,
        sum_of_cosines_course,
    )

    return {
        "sin": lambda: sum_of_cosines_course(
            amplitudes=(1.0, 0, 0), frequencies=(0.25, 0, 0), deltas=(0, 0, 0),
            resolution=0.1, course_length=10.0),
        # the raw dkan corners are unreachable kinks: the spline-smoothed
        # corridor, as the JAX package's tests/test_paths.py drives it
        "dkan": lambda: spline_resample_course(dkan_course(resolution=0.5), resolution=0.1),
        "square": filtered_square_course,
        "circle": lambda: circle_course(radius=10.0, resolution=0.1),
    }[kind]().astype(np.float32)


def _device(args):
    """The requested device, or None (with the error printed) when it is a
    CUDA device and there is none."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: device {args.device} requested but CUDA is not available",
              file=sys.stderr)
        return None
    return device


def _resolve(args):
    """(device, cfg, sp, cp, course) of the preset on the requested device,
    with the --course override; device None when a CUDA device was asked for
    and there is none."""
    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS

    device = _device(args)
    if device is None:
        return (None,) * 5
    kwargs = {"horizon": args.horizon, "device": device}
    if args.num_samples:
        kwargs["num_samples"] = args.num_samples
    cfg, sp, cp, course = PRESETS[args.preset](**kwargs)
    if args.course != "preset":
        course = _course(args.course)
    return device, cfg, sp, cp, course


def _print_metrics(m):
    print(f"Time: {round(m['time'], 1)}")
    print(f"Max Error: {round(m['max_error'], 3)}")
    print(f"RMSE Error: {round(m['rmse'], 3)}")


def cmd_run(args):
    from ccv_mppi_path_tracker_tpu_torch.runtime import (
        load_checkpoint,
        run_tracking_experiment,
        save_checkpoint,
    )

    device, cfg, sp, cp, course = _resolve(args)
    if device is None:
        return 2
    extra = {}
    if args.resume_ckpt:
        ck_cfg, ctrl, params = load_checkpoint(args.resume_ckpt, device=device)
        if (ck_cfg.model, ck_cfg.horizon) != (cfg.model, cfg.horizon):
            print(f"error: checkpoint is for {ck_cfg.model} T={ck_cfg.horizon}, "
                  f"requested {cfg.model} T={cfg.horizon}", file=sys.stderr)
            return 2
        sp, cp = params["sp"], params["cp"]
        extra["ctrl"] = ctrl
        print(f"resumed from {args.resume_ckpt} (cycle {ctrl.step})")
    opts = {}
    if args.shift_warm_start:
        opts["shift_warm_start"] = True
    if args.delay is not None:
        opts["delay"] = args.delay
    if args.elite_frac is not None:
        opts["elite_frac"] = args.elite_frac
    if args.animate and not (args.kernel or args.no_kernel):
        # the candidate paths are an eager-path output, so auto stays eager
        use_kernel, auto = False, True
    else:
        use_kernel, auto = _kernel_choice(args, cfg, device)
    if args.animate:
        if not use_kernel:
            opts["debug_candidates"] = args.animate_candidates
        extra["with_paths"] = True
    _print_path(use_kernel, auto, device)
    out = run_tracking_experiment(
        cfg, sp, cp, course, num_steps=args.steps, dt=args.dt, seed=args.seed,
        use_kernel=use_kernel, solver_options=opts or None, **extra,
    )
    if args.animate:
        from ccv_mppi_path_tracker_tpu_torch.metrics.animate import animate_tracking

        n = animate_tracking(out, args.animate)
        print(f"animation: {args.animate} ({n} frames)")
    if args.save_ckpt:
        save_checkpoint(args.save_ckpt, cfg, out["ctrl"], sp=sp, cp=cp)
        print(f"checkpoint: {args.save_ckpt}")
    _print_metrics(out["metrics"])
    if args.record:
        _record(args, out, cfg)
    if args.plot:
        from ccv_mppi_path_tracker_tpu_torch.metrics.plots import plot_tracking

        plot_tracking(out, out=args.plot)
        print(f"figure: {args.plot}")
    if args.plot_yaw:
        from ccv_mppi_path_tracker_tpu_torch.metrics.plots import plot_yaw_comparison

        plot_yaw_comparison(out, out=args.plot_yaw)
        print(f"figure: {args.plot_yaw}")
    return 0


def _record(args, out, cfg):
    """The run's cycles in the reference recorder's CSV layout."""
    from ccv_mppi_path_tracker_tpu_torch.metrics import Recorder
    from ccv_mppi_path_tracker_tpu_torch.solver.command import command_from_solution

    rec = Recorder(args.record, method=args.preset)
    logs = out["logs"]
    for i, (state, u0) in enumerate(zip(logs["state"], torch.as_tensor(logs["u0"]))):
        rec.write_cycle(i * args.dt, state, command_from_solution(cfg.model, u0, args.dt))
    rec.close(out["course"])
    print(f"recorded: {rec.path}")


def cmd_compare(args):
    """MPPI vs the pure-pursuit baseline on the same course."""
    from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment
    from ccv_mppi_path_tracker_tpu_torch.runtime.pure_pursuit import (
        PurePursuitConfig,
        run_pure_pursuit_experiment,
    )

    device, cfg, sp, cp, course = _resolve(args)
    if device is None:
        return 2
    use_kernel, _ = _kernel_choice(args, cfg, device)
    mppi = run_tracking_experiment(cfg, sp, cp, course, num_steps=args.steps, dt=args.dt,
                                   seed=args.seed, use_kernel=use_kernel)
    pp = run_pure_pursuit_experiment(course, num_steps=args.steps, dt=args.dt,
                                     cfg=PurePursuitConfig(v_ref=float(cp.v_ref)),
                                     device=device)
    for name, r in (("mppi", mppi), ("pure_pursuit", pp)):
        m = r["metrics"]
        print(f"{name}: RMSE={m['rmse']:.3f} max={m['max_error']:.3f}")
    if args.plot:
        from ccv_mppi_path_tracker_tpu_torch.metrics.plots import plot_tracking_comparison

        plot_tracking_comparison({"MPPI": mppi, "Pure Pursuit": pp}, out=args.plot)
        print(f"wrote comparison figure {args.plot}")
    return 0


def cmd_realtime(args):
    """Wall-clock fixed-rate run with the native scheduler and recorder."""
    from ccv_mppi_path_tracker_tpu_torch.runtime.realtime import (
        run_pipelined_experiment,
        run_realtime_experiment,
    )

    device, cfg, sp, cp, course = _resolve(args)
    if device is None:
        return 2
    rec = None
    if args.record:
        os.makedirs(args.record, exist_ok=True)
        rec = os.path.join(args.record, f"{args.preset}_realtime.csv")
    use_kernel, auto = _kernel_choice(args, cfg, device)
    _print_path(use_kernel, auto, device)
    if args.pipelined or args.micro_batch > 1:
        if rec is not None:
            print("note: --record is not supported by the pipelined loop "
                  "(no per-cycle command CSV); running without recording")
            rec = None
        out = run_pipelined_experiment(cfg, sp, cp, course, hz=args.hz,
                                       num_cycles=args.steps, use_kernel=use_kernel,
                                       micro_batch=args.micro_batch)
        fm = out["fetch_ms"]
        print(f"pipelined: micro_batch={args.micro_batch} "
              f"fetch p95 {fm['p95']:.2f} ms (max {fm['max']:.2f})")
    else:
        out = run_realtime_experiment(cfg, sp, cp, course, hz=args.hz,
                                      num_cycles=args.steps, record_path=rec,
                                      use_kernel=use_kernel)
    rs = out["rate_stats"]
    _print_metrics(out["metrics"])
    print(f"rate: {rs['cycles']} cycles, {rs['deadline_misses']} misses, "
          f"mean dt {rs['mean_dt'] * 1e3:.2f} ms, max jitter "
          f"{rs['max_abs_jitter'] * 1e3:.2f} ms")
    if rec:
        print(f"recorded: {rec}")
    return 0


def cmd_course(args):
    from ccv_mppi_path_tracker_tpu_torch.paths import (
        circle_course,
        dkan_course,
        filtered_square_course,
        sum_of_cosines_course,
    )

    kinds = {
        "sin": lambda: sum_of_cosines_course(
            amplitudes=(args.amplitude, 0, 0), frequencies=(args.frequency, 0, 0),
            deltas=(0, 0, 0), resolution=args.resolution, course_length=args.length),
        "circle": lambda: circle_course(radius=args.radius, resolution=args.resolution),
        "dkan": lambda: dkan_course(resolution=args.resolution),
        "square": lambda: filtered_square_course(length=args.length,
                                                 amplitude=args.amplitude),
    }
    course = kinds[args.kind]()
    np.savetxt(args.out, course, delimiter=",", header="x,y", comments="")
    print(f"{args.kind} course: {len(course)} points -> {args.out}")
    return 0


def cmd_sysid(args):
    """System-identification demo: recover actuator gains from a droopy
    plant (2048 random unicycle transitions, true gains [0.85, 1.1], 400 Adam
    steps), as the JAX package's ``sysid`` does on the same data."""
    from ccv_mppi_path_tracker_tpu_torch.diff import fit_control_gains
    from ccv_mppi_path_tracker_tpu_torch.models import get_model

    device = _device(args)
    if device is None:
        return 2
    rng = np.random.RandomState(args.seed)
    true_gains = np.array([0.85, 1.1])
    m = get_model("unicycle")
    states = torch.as_tensor(rng.randn(2048, 3), dtype=torch.float32, device=device)
    controls = torch.as_tensor(rng.randn(2048, 2), dtype=torch.float32, device=device)
    gains = torch.as_tensor(true_gains, dtype=torch.float32, device=device)
    next_states = m.step(states, controls * gains, 0.1)
    fitted, losses = fit_control_gains("unicycle", states, controls, next_states, 0.1,
                                       num_steps=400)
    print(json.dumps({
        "true_gains": true_gains.tolist(),
        "fitted_gains": fitted.gains.cpu().numpy().round(4).tolist(),
        "final_loss": float(losses[-1]),
    }))
    return 0


def cmd_fleet(args):
    """Fleet serving demo: B robots per tick, one kernel launch per tick. On
    the card a tick is two CUDA graphs' replays, the fleet step's and the
    plant's (runtime/plant.py step_fleet_plant)."""
    import time

    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime.plant import step_fleet_plant
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
    use_kernel, _ = _kernel_choice(args, cfg, device)
    step = build_fleet_step(cfg, use_kernel=use_kernel)
    ctrls = init_fleet(cfg, num_robots, seed=args.seed, device=device)
    traj = [states]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        ctrls, res = step(ctrls, states, path, dt, sp, cp)
        states = step_fleet_plant(cfg.model, states, res.u0, dt)
        traj.append(states)
    traj = torch.stack(traj).cpu().numpy()  # (steps+1, B, S); waits for the card
    wall = time.perf_counter() - t0
    rmses = [tracking_metrics(traj[:, b, :2], course, dt=args.dt)["rmse"]
             for b in range(num_robots)]
    replay = ", replayed as a CUDA graph" if torch.device(device).type == "cuda" else ""
    print(f"fleet: {num_robots} robots x K={cfg.num_samples}, {args.steps} ticks, "
          f"{'kernel' if use_kernel else 'eager'} path on {device}{replay}")
    print(f"RMSE mean={np.mean(rmses):.3f} worst={np.max(rmses):.3f}")
    print(f"wall: {wall:.2f} s = {num_robots * args.steps / wall:,.0f} robot-updates/s "
          f"(host clock)")
    return 0


def cmd_export(args):
    """Serialize the control step for deployment (torch.export)."""
    from ccv_mppi_path_tracker_tpu_torch.runtime.export import export_control_step

    device, cfg, sp, cp, course = _resolve(args)
    if device is None:
        return 2
    blob = export_control_step(cfg, path_capacity=len(course), sp=sp, cp=cp, device=device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {cfg.model} K={cfg.num_samples} T={cfg.horizon} "
          f"({len(blob)} bytes) -> {args.out}")
    return 0


def cmd_profile(args):
    """A torch.profiler trace of control cycles (a Chrome trace) and a
    host-side phase-time summary: one warm step, then --steps steps inside
    the trace."""
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.solver import MPPISolver
    from ccv_mppi_path_tracker_tpu_torch.utils.profiling import PhaseTimer, device_trace

    device, cfg, sp, cp, course = _resolve(args)
    if device is None:
        return 2
    model = get_model(cfg.model)
    path = PathBuffer.from_points(course, 0.1, device=device)
    state = torch.zeros(model.num_states, device=device)
    state[1] = float(course[0, 1])
    dt = torch.full((), args.dt, device=device)
    use_kernel, auto = _kernel_choice(args, cfg, device)
    _print_path(use_kernel, auto, device)
    solver = MPPISolver(cfg, use_kernel=use_kernel)
    ctrl = solver.init(args.seed, device=device)
    timer = PhaseTimer()
    with timer.phase("warm_step"):
        ctrl, res = solver.step(ctrl, state, path, dt, sp, cp)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    with device_trace(args.out):
        for _ in range(args.steps):
            with timer.phase("control_cycle"):
                ctrl, res = solver.step(ctrl, state, path, dt, sp, cp)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    print(json.dumps(timer.summary()))
    print(f"trace: {os.path.join(args.out, 'trace.json')} (open in Perfetto or "
          f"chrome://tracing)")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="ccv_mppi_path_tracker_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="closed-loop tracking experiment")
    _add_run_args(pr)
    _add_solver_args(pr)
    _add_plot_args(pr)
    pr.add_argument("--record", default=None, help="log dir for CSV output")
    pr.add_argument("--save-ckpt", default=None,
                    help="save the final controller state and params (.npz)")
    pr.add_argument("--resume-ckpt", default=None,
                    help="resume the warm start, seed and cycle from a checkpoint "
                         "of this port")
    pr.set_defaults(fn=cmd_run)

    pc = sub.add_parser("compare", help="MPPI vs the pure-pursuit baseline")
    _add_run_args(pc)
    pc.add_argument("--plot", default=None,
                    help="save the two-run overlay figure (graph2.py layout) to this file")
    pc.set_defaults(fn=cmd_compare)

    po = sub.add_parser("course", help="generate a course CSV")
    po.add_argument("--kind", default="sin", choices=["sin", "circle", "dkan", "square"])
    po.add_argument("--out", default="course.csv")
    po.add_argument("--length", type=float, default=10.0)
    po.add_argument("--amplitude", type=float, default=1.0)
    po.add_argument("--frequency", type=float, default=0.25)
    po.add_argument("--radius", type=float, default=10.0)
    po.add_argument("--resolution", type=float, default=0.1)
    po.set_defaults(fn=cmd_course)

    ps = sub.add_parser("sysid", help="system-identification demo")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--device", default="cuda",
                    help="torch device; a CUDA device that is not there is an error")
    ps.set_defaults(fn=cmd_sysid)

    prt = sub.add_parser("realtime", help="fixed-rate native-runtime tracking experiment")
    _add_run_args(prt)
    prt.add_argument("--record", default=None, help="log dir for CSV output")
    prt.add_argument("--hz", type=float, default=10.0)
    prt.add_argument("--pipelined", action="store_true",
                     help="asynchronous depth-1 pipelined loop: dispatch cycle "
                          "n+1 before fetching cycle n's command, actuation lag "
                          "compensated in the solver (delay=1/hz)")
    prt.add_argument("--micro-batch", type=int, default=1,
                     help="this many cycles per dispatch and per fetch "
                          "(implies --pipelined)")
    prt.set_defaults(fn=cmd_realtime)

    pf = sub.add_parser("fleet", help="batched multi-robot serving demo")
    _add_run_args(pf)
    _add_solver_args(pf)
    pf.add_argument("--robots", type=int, default=64)
    pf.set_defaults(fn=cmd_fleet)

    pp = sub.add_parser("profile", help="torch.profiler trace of control cycles")
    _add_run_args(pp)
    pp.add_argument("--out", default="ccv_trace",
                    help="directory of the trace (trace.json)")
    pp.set_defaults(fn=cmd_profile)

    pe = sub.add_parser("export", help="serialize the control step (torch.export)")
    _add_run_args(pe, kernel_flags=False)
    pe.add_argument("--out", default="control_step.pt2")
    pe.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
