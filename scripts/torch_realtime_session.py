#!/usr/bin/env python3
"""Sustained serving session of the PyTorch port on one card: the twin of
``scripts/realtime_session.py``, writing artifacts/realtime_torch.json with
the same keys (and the card's ``power_limit``).

Three arms:

1. **device arm** (:func:`device_arm`): the serving configuration
   (full_body, K=102400, T=30, fused kernel, lean) replanning at a fixed
   control rate for a stretch of simulated time, entirely on the card: the
   solver plans a 3 s horizon (dt 0.1) and the plant advances 1/hz a cycle.
   Its cycle (:func:`session_cycle`: ``mppi_step`` then the plant's step at
   dt_ctrl) is captured once as a CUDA graph and replayed for every cycle
   (``KeyedGraph.scan``, utils/cuda_graph.py ``Graphed.scan``), with one
   read-back of the stacked positions at the end; sustained rate = cycles /
   wall. The capture's own time is kept apart (``compile_s``).
2. **pipelined arm** (:func:`pipelined_arm`): ``run_pipelined_experiment``
   at a ladder of (hz, micro_batch), then the delay-compensation pairs.
3. **host arm** (:func:`host_arm`): ``run_realtime_experiment``, the paced
   host loop (native RateExecutor + InputGate + ControlLoop), at 10, 25 and
   50 Hz: deadline misses and jitter.

    python3 scripts/torch_realtime_session.py [--hz 500 --seconds 60]
        [--host-seconds 30] [--skip-device] [--skip-pipelined] [--skip-host]
        [--device cuda:0] [--out FILE]

A skipped arm is carried from the artifact at ``--out`` where it exists.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def session_cycle(carry, path, dt_solve, dt_ctrl, sp, cp, model_params, cfg, options):
    """One serving cycle: the update at the solver's dt, then the plant at
    the control interval (``simulate`` uses one dt for both). ``carry`` is
    (ctrl, state); returns (the next carry, the new position)."""
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

    ctrl, state = carry
    ctrl, res = mppi_step(cfg, ctrl, state, path, dt_solve, sp, cp,
                          model_params=model_params, **options)
    state = get_model(cfg.model).step(state, res.u0, dt_ctrl)
    return (ctrl, state), state[:2]


def device_arm(hz=500.0, seconds=60.0, num_samples=102_400, horizon=30,
               use_kernel=True, device=None):
    from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
    from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
    )
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.paths.courses import circle_course
    from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph

    device = resolve_device(device)
    cfg, sp, cp, _ = full_body_launch(num_samples=num_samples, horizon=horizon,
                                      device=device)
    course = circle_course(radius=10.0, resolution=0.1, turns=4.0, dtype=np.float32)
    path = PathBuffer.from_points(course, 0.1, dtype=torch.float32, device=device)
    model = get_model(cfg.model)
    model_params = model.default_params(device=device)
    dt_solve = torch.full((), 0.1, device=device)        # rollout step: 3 s lookahead
    dt_ctrl = torch.full((), 1.0 / hz, device=device)    # actuation interval
    n = int(seconds * hz)
    options = {"use_kernel": use_kernel, "lean": True}
    state0 = torch.tensor([float(course[0, 0]), float(course[0, 1]), float(np.pi / 2),
                           0.0, 0.0], device=device)
    graph = KeyedGraph(session_cycle)

    def run(length):
        ctrl0 = ControllerState.initial(0, cfg.horizon, model.num_controls, device=device)
        return graph.scan((ctrl0, state0), path, dt_solve, dt_ctrl, sp, cp, model_params,
                          cfg, options, length=length)

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    # the capture: the cycle's first run and its graph, on a one-cycle scan
    sync()
    t0 = time.perf_counter()
    run(1)
    sync()
    compile_s = time.perf_counter() - t0
    launches = fused_sample_rollout_cost.launches
    t0 = time.perf_counter()
    (ctrl, state), xy = run(n)
    xy = xy.cpu().numpy()   # blocks until the whole session is done
    wall = time.perf_counter() - t0
    launches = fused_sample_rollout_cost.launches - launches

    m = tracking_metrics(np.concatenate([state0[None, :2].cpu().numpy(), xy]), course,
                         dt=1.0 / hz)
    m.pop("errors", None)
    sustained_hz = n / wall
    return {
        "num_samples": num_samples, "horizon": horizon,
        "kernel": bool(use_kernel), "lean": True,
        "target_hz": hz, "cycles": n,
        "sim_seconds": round(n / hz, 1),
        "wall_seconds": round(wall, 2),
        "sustained_hz": round(sustained_hz, 1),
        "meets_target": bool(sustained_hz >= hz),
        "per_cycle_ms": round(wall / n * 1e3, 4),
        "compile_s": round(compile_s, 3),
        "captures": graph.captures,
        "kernel_launches": launches,
        "tracking": {k: round(v, 4) for k, v in m.items()},
        "course": "circle r=10 m, 4 laps available",
        "note": "solver dt=0.1 (3 s horizon), plant advances 1/hz per "
                "cycle; one CUDA graph of the cycle, captured once and "
                "replayed for every cycle, one read-back at the end",
    }


def pipelined_arm(arms=((10.0, 1), (25.0, 1), (50.0, 1), (25.0, 4),
                        (50.0, 8), (100.0, 16)),
                  seconds=30.0, num_samples=102_400, horizon=30,
                  use_kernel=True, device=None,
                  pairs=(("micro_batch8_50hz", 50.0, 8), ("depth1_10hz", 10.0, 1))):
    """``run_pipelined_experiment`` at each (hz, micro_batch) of ``arms``:
    miss accounting, fetch percentiles and tracking; then each of ``pairs``
    run with and without delay compensation (``mppi_step(delay=1/hz)`` or
    the window's predicted hand-off state) at the same rate."""
    from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu_torch.runtime.realtime import run_pipelined_experiment

    cfg, sp, cp, course = full_body_launch(num_samples=num_samples, horizon=horizon,
                                           device=device)
    out = []
    for hz, mb in arms:
        res = run_pipelined_experiment(
            cfg, sp, cp, course, hz=hz, num_cycles=int(seconds * hz),
            use_kernel=use_kernel, micro_batch=mb,
        )
        m = dict(res["metrics"])
        m.pop("errors", None)
        rs = res["rate_stats"]
        row = {
            "target_hz": hz, "micro_batch": mb, "seconds": seconds,
            "rate_stats": {k: (round(v, 6) if isinstance(v, float) else v)
                           for k, v in rs.items()},
            "miss_rate": round(res["miss_rate"], 4),
            "fetch_ms": {k: round(v, 2) for k, v in res["fetch_ms"].items()},
            "feedback_latency_cycles": res["feedback_latency_cycles"],
            "tracking": {k: round(float(v), 4) for k, v in m.items()},
        }
        out.append(row)
        print(f"pipelined {hz} Hz M={mb}: miss={row['miss_rate']} "
              f"fetch_p95={row['fetch_ms']['p95']}ms "
              f"rmse={row['tracking'].get('rmse')}", flush=True)

    comp = {}
    for tag, hz, mb in pairs:
        for name, dc in (("compensated", True), ("naive", False)):
            res = run_pipelined_experiment(
                cfg, sp, cp, course, hz=hz, num_cycles=int(seconds * hz),
                use_kernel=use_kernel, micro_batch=mb,
                delay_compensation=dc,
            )
            comp[f"{tag}_{name}"] = {
                "hz": hz, "micro_batch": mb,
                "rmse": round(float(res["metrics"]["rmse"]), 4),
                "max_error": round(float(res["metrics"]["max_error"]), 4)}
            print(f"delay-comp {tag} {name}: {comp[f'{tag}_{name}']}", flush=True)
    return out, comp


def host_arm(rates=(10.0, 25.0, 50.0), seconds=30.0, num_samples=102_400,
             horizon=30, use_kernel=True, device=None):
    from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu_torch.runtime.realtime import run_realtime_experiment

    out = []
    for hz in rates:
        cfg, sp, cp, course = full_body_launch(num_samples=num_samples, horizon=horizon,
                                               device=device)
        res = run_realtime_experiment(
            cfg, sp, cp, course, hz=hz, num_cycles=int(seconds * hz),
            lean=True, use_kernel=use_kernel,
        )
        m = dict(res["metrics"])
        m.pop("errors", None)
        rs = res["rate_stats"]
        out.append({
            "target_hz": hz, "seconds": seconds,
            "rate_stats": {k: (round(v, 6) if isinstance(v, float) else v)
                           for k, v in rs.items()},
            "miss_rate": round(
                rs.get("deadline_misses", 0) / max(rs.get("cycles", 1), 1),
                4,
            ),
            "tracking": {k: round(float(v), 4) for k, v in m.items()},
        })
        print(f"host {hz} Hz: {out[-1]['rate_stats']} "
              f"rmse={out[-1]['tracking'].get('rmse')}", flush=True)
    return out


def card_line(device):
    """The card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, or None off the card."""
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--hz", type=float, default=500.0)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--host-seconds", type=float, default=30.0)
    p.add_argument("--skip-host", action="store_true")
    p.add_argument("--skip-device", action="store_true")
    p.add_argument("--skip-pipelined", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu runs there)")
    p.add_argument("--out", default=os.path.join(ROOT, "artifacts", "realtime_torch.json"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    dev = None if args.skip_device else device_arm(hz=args.hz, seconds=args.seconds,
                                                   device=device)
    print("device arm:", json.dumps(dev, indent=1), flush=True)
    piped, comp = ([], {}) if args.skip_pipelined else pipelined_arm(
        seconds=args.host_seconds, device=device)
    hosts = [] if args.skip_host else host_arm(seconds=args.host_seconds, device=device)
    prev = None
    if (args.skip_device or args.skip_host or args.skip_pipelined) \
            and os.path.exists(args.out):
        # a partial refresh carries the arms not run this time
        with open(args.out) as f:
            prev = json.load(f)
    if dev is None and prev:
        dev = prev.get("device_resident_session")
    if not hosts and prev:
        hosts = prev.get("host_rate_ladder_synchronous", [])
    if not piped and prev:
        piped = prev.get("pipelined_host_ladder", [])
        comp = prev.get("delay_compensation_closed_loop", {})
    out = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda"
        else str(device),
        "power_limit": card_line(device),
        "device_resident_session": dev,
        "pipelined_host_ladder": piped,
        "delay_compensation_closed_loop": comp,
        "host_rate_ladder_synchronous": hosts,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"wrote": args.out, "power_limit": out["power_limit"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
