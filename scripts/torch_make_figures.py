#!/usr/bin/env python3
"""The reference's paper-figure set from the PyTorch port (the twin of
scripts/make_figures.py): the same ten figures from the same runs (presets,
K, cycles), written to examples/figures_torch/.

    python3 scripts/torch_make_figures.py                  # on the card
    python3 scripts/torch_make_figures.py --runs runs.npz  # also keep the runs
    python3 scripts/torch_make_figures.py --draw-from runs.npz   # draw only
    python3 scripts/torch_make_figures.py --quick --device cpu --out DIR

The runs go through the port on ``--device`` (default the card), each closed
loop one CUDA graph replayed a cycle there (runtime/loop.py simulate), and
each prints its RMSE in make_figures.py's line. Drawing needs matplotlib,
which is imported only to draw: where it is missing the runs are written to
``--runs`` (an npz) and nothing is drawn; ``--draw-from`` draws the figures
from such a file on a machine that has it. ``--quick`` (K=64, 10 cycles) is
for tests. Imports torch, numpy and the port only.

Each figure restates one of the reference's matplotlib scripts:
  diff_drive_tracking / full_body_tracking  <- graph2.py layout
  yaw_comparison                            <- graph3.py layout
  zmp_controlled                            <- zmp_graph.py layout
  tracking_comparison / zmp_comparison      <- graph2.py:37-41, zmp_graph2.py overlays
  solver_debug                              <- rviz candidate/optimal view
  feasible_region                           <- v_w_performance.py
  course_curvature / square_wave_course     <- calc_curveture.py / ref_path_analyze.py
"""

import argparse
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "examples" / "figures_torch"
FIGURES = ("diff_drive_tracking", "yaw_comparison", "full_body_tracking", "zmp_controlled",
           "tracking_comparison", "zmp_comparison", "solver_debug", "feasible_region",
           "course_curvature", "square_wave_course")
QUICK_K, QUICK_STEPS = 64, 10


def _tracking(result):
    """What the figures read of a run_tracking_experiment result."""
    return {"logs": result["logs"], "metrics": result["metrics"], "course": result["course"]}


def runs(device=None, quick=False):
    """make_figures.py's runs through the port on ``device``: {run name:
    NumPy result}. Each closed loop's RMSE is printed as make_figures.py
    prints it."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
    from ccv_mppi_path_tracker_tpu_torch.core.presets import (
        diff_drive_launch,
        full_body_launch,
        steering_launch,
    )
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment
    from ccv_mppi_path_tracker_tpu_torch.runtime.sim_sensors import run_full_stack_experiment
    from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

    device = resolve_device(device)

    def k(n):
        return QUICK_K if quick else n

    def steps(n):
        return QUICK_STEPS if quick else n

    def tracked(launch, course=None, **kw):
        cfg, sp, cp, own = launch(device=device, **kw)
        return _tracking(run_tracking_experiment(cfg, sp, cp, own if course is None else course,
                                                 num_steps=steps(150)))

    out = {}
    cfg, sp, cp, course = diff_drive_launch(num_samples=k(1024), device=device)
    out["diff_drive"] = _tracking(run_tracking_experiment(cfg, sp, cp, course,
                                                          num_steps=steps(120)))
    print("diff_drive RMSE:", out["diff_drive"]["metrics"]["rmse"], flush=True)
    out["full_body"] = tracked(full_body_launch, num_samples=k(4096))
    print("full_body RMSE:", out["full_body"]["metrics"]["rmse"], flush=True)

    # the full-stack sensing -> estimation -> control pipeline, controlled
    on = run_full_stack_experiment(roll_off=False, cycles=steps(80), device=device,
                                   **({"num_samples": k(256)} if quick else {}))
    out["full_stack"] = on
    print("full-stack (controlled) RMSE:", on["metrics"]["rmse"], flush=True)

    # the two-run overlays: steered against unsteered on the steered course,
    # controlled against uncontrolled (full_body_launch defaults to roll_off)
    scourse = steering_launch(num_samples=k(2048), device=device)[3]
    out["steered"] = tracked(steering_launch, num_samples=k(2048))
    out["unsteered"] = tracked(diff_drive_launch, scourse, num_samples=k(2048))
    print("steered RMSE:", out["steered"]["metrics"]["rmse"],
          "unsteered RMSE:", out["unsteered"]["metrics"]["rmse"], flush=True)
    out["controlled"] = tracked(full_body_launch, num_samples=k(4096), roll_off=False)
    ccourse = out["controlled"]["course"]
    out["uncontrolled"] = tracked(full_body_launch, ccourse, num_samples=k(4096),
                                  roll_off=True)
    print("controlled RMSE:", out["controlled"]["metrics"]["rmse"],
          "uncontrolled RMSE:", out["uncontrolled"]["metrics"]["rmse"], flush=True)

    # one cycle's internals with 48 candidate rollouts
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=12, device=device)
    path = PathBuffer.from_points(course, 0.1, device=device)
    ctrl = ControllerState.initial(0, 12, 2, device=device)
    state = torch.tensor([0.0, float(course[0, 1]), 0.0], device=device)
    _, res = mppi_step(cfg, ctrl, state, path, torch.full((), 0.1, device=device), sp, cp,
                       debug_candidates=48)
    out["solver_debug"] = {"candidates": res.stats["candidates"].cpu().numpy(),
                           "ref_xy": res.ref.xy.cpu().numpy(),
                           "opt_states": res.opt_states.cpu().numpy(), "course": course}
    return out


def save_runs(out, path):
    """``out`` (nested dicts of arrays and numbers) as one npz, keys joined
    by "/"."""
    flat = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for key, value in obj.items():
                walk(f"{prefix}/{key}" if prefix else key, value)
        else:
            flat[prefix] = np.asarray(obj)

    walk("", out)
    np.savez(path, **flat)


def load_runs(path):
    """The inverse of :func:`save_runs`; 0-d arrays become Python numbers."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            value = data[key]
            node[leaf] = value.item() if value.ndim == 0 else value
    return out


def draw(out, directory):
    """The ten figures of ``out`` (:func:`runs`) into ``directory``."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.metrics import plots
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)

    def png(name):
        return str(directory / f"{name}.png")

    plots.plot_tracking(out["diff_drive"], out=png("diff_drive_tracking"))
    plots.plot_yaw_comparison(out["diff_drive"], out=png("yaw_comparison"))
    plots.plot_tracking(out["full_body"], out=png("full_body_tracking"), label="Full-body MPPI")
    on = out["full_stack"]
    t = np.arange(len(on["zmp"])) * 0.1
    plots.plot_zmp(t, on["zmp"], v=None, roll=on["traj"][1:, 3], true_zmp=on["true_zmp"],
                   out=png("zmp_controlled"))
    plots.plot_tracking_comparison(
        {"With Steering Robot": out["steered"], "Without Steering Robot": out["unsteered"]},
        out=png("tracking_comparison"))
    plots.plot_zmp_comparison(
        {"Controlled": out["controlled"], "Not Controlled": out["uncontrolled"]},
        default_params(device="cpu", dtype=torch.float32), out=png("zmp_comparison"))
    debug = out["solver_debug"]
    res = types.SimpleNamespace(stats={"candidates": debug["candidates"]},
                                ref=types.SimpleNamespace(xy=debug["ref_xy"]),
                                opt_states=debug["opt_states"])
    plots.plot_solver_debug(res, course=debug["course"], out=png("solver_debug"))
    plots.plot_feasible_region(out=png("feasible_region"), n=40)
    plots.plot_course_curvature(debug["course"], out=png("course_curvature"))
    plots.plot_filtered_square_analysis(out=png("square_wave_course"))
    import matplotlib.pyplot as plt

    plt.close("all")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="the runs' device (default: the card)")
    p.add_argument("--quick", action="store_true", help=f"K={QUICK_K}, {QUICK_STEPS} cycles")
    p.add_argument("--out", default=str(OUT), help="the figures' directory")
    p.add_argument("--runs", default=None, help="also write the runs to this npz")
    p.add_argument("--draw-from", default=None, help="draw from this npz; run nothing")
    args = p.parse_args(argv)

    if args.draw_from:
        out = load_runs(args.draw_from)
    else:
        out = runs(args.device, args.quick)
        if args.runs:
            save_runs(out, args.runs)
            print("runs ->", args.runs, flush=True)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        if args.runs:
            print("matplotlib is not installed: no figure drawn; draw them with --draw-from "
                  f"{args.runs}", flush=True)
            return 0
        print("matplotlib is not installed: pass --runs FILE to keep the runs, then draw "
              "with --draw-from FILE where it is", file=sys.stderr)
        return 1
    draw(out, args.out)
    print("figures ->", Path(args.out).resolve(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
