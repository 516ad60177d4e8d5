#!/usr/bin/env python3
"""Tracking-quality matrix of the PyTorch port at the reference's own
operating points: the twin of ``scripts/quality_matrix.py``, on the card.

The reference's whole quantitative evaluation is nearest-point tracking
error (Time / Max Error / RMSE, src/calc_e_rmse.py:36-49) at v_ref in
{0.4, 1.2, 2.0} m/s (launch/full_body_mppi.launch:6,29-31) on its courses,
MPPI against a pure-pursuit baseline (launch/pure_pursuit.launch,
src/graph2.py:37-41), plus the controlled-vs-uncontrolled lateral-ZMP
comparison at v=2.0 (log/full_body/robo_sym/{controlled,uncontrolled}.png,
band +-0.15 m from src/zmp_graph.py:53). This script sweeps the same grid
through the port's closed loop and writes the same artifact, key for key
(plus the card's ``power_limit``), to artifacts/quality_matrix_torch.json:

    controllers {diff_drive K=1000, steering K=1000, full_body K=10000}
  x courses     {cosine A=1.0 f=0.25, cosine A=1.5 f=0.127, dkan corridor,
                 filtered square wave}
  x v_ref       {0.4, 1.2, 2.0}
  each MPPI (vanilla and Gauss-Newton refined, seeds 0-2) against the
  pure-pursuit baseline on the same course, plus full_body ZMP controlled
  (zmp_weight=10) against uncontrolled (roll_off) at v=2.0.

On the card every MPPI run is ``run_tracking_experiment``'s graphed
``simulate`` (one CUDA graph a cycle, replayed; the refined arm's refine
stage inside it) and every pure-pursuit run the graphed scan of its cycle
(runtime/pure_pursuit.py). ``--kernel auto`` resolves
``kernels.rollout_cost.should_use_kernel(model, device)``: the fused kernel
for every built-in model on the card, the eager path on the CPU. The
artifact's ``solver_path`` says which ran. Runs are cut at course
completion (the first cycle whose nearest course point is the last one,
within 0.5 m), as calc_e_rmse.py measures a recording that stops at the goal.

    python3 scripts/torch_quality_matrix.py            # full grid, the card
    python3 scripts/torch_quality_matrix.py --quick    # K=256, one seed
    python3 scripts/torch_quality_matrix.py --quick --device cpu --out F
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

V_REFS = (0.4, 1.2, 2.0)
DT = 0.1
COMPLETE_TOL = 0.5  # m, distance to the final course point that ends a run


def courses(dtype=np.float32):
    """The four courses, as ``scripts/quality_matrix.py:53`` makes them."""
    from ccv_mppi_path_tracker_tpu_torch.paths.courses import (
        dkan_course,
        filtered_square_course,
        sum_of_cosines_course,
    )
    from ccv_mppi_path_tracker_tpu_torch.paths.spline import spline_resample_course

    def cos(a, f, length):
        return sum_of_cosines_course(
            amplitudes=(a, 0.0, 0.0), frequencies=(f, 0.0, 0.0),
            deltas=(0.0, 0.0, 0.0), resolution=0.1, course_length=length,
            dtype=dtype,
        )

    return {
        # launch/diff_drive_mppi.launch:15-17 (A=1.0, f=0.25)
        "cosine_A1.0_f0.25": cos(1.0, 0.25, 10.0),
        # launch/full_body_mppi.launch:29-31 (A=1.5, f=0.127)
        "cosine_A1.5_f0.127": cos(1.5, 0.127, 20.0),
        # src/dkan_path_creator.cpp:11-35
        "dkan": dkan_course(dtype=dtype),
        # src/reference_path_creator.py:34-47 at the launch operating point
        # (launch/reference_path_creator.launch:5-11: fs=10, wave_hz=0.2,
        # len=20, cutoff=1), resampled to 0.1 m of arc by the cubic spline:
        # the raw generator's points sit up to ~0.8 m apart on the steep edges
        "filtered_square": spline_resample_course(
            filtered_square_course(
                length=20.0, amplitude=2.0, wave_hz=0.2, fs=10.0, cutoff=1.0,
            ),
            0.1,
        ).astype(dtype),
    }


def controller_configs(v_ref, quick=False, roll_off=False, device=None):
    """(cfg, sp, cp) of each controller family at its launch operating
    point with v_ref swept (launch/full_body_mppi.launch:6), on ``device``
    (None: the card). full_body is controlled (zmp_weight=10) unless
    ``roll_off``, the uncontrolled arm."""
    from ccv_mppi_path_tracker_tpu_torch.core.presets import (
        diff_drive_launch,
        full_body_launch,
        steering_launch,
    )

    def with_v_ref(cp):
        return dataclasses.replace(cp, v_ref=torch.full_like(cp.v_ref, v_ref))

    k_dd = 256 if quick else 1000
    k_fb = 256 if quick else 10000
    out = {}
    for name, fn, k in (
        ("diff_drive", diff_drive_launch, k_dd),
        ("steering", steering_launch, k_dd),
    ):
        cfg, sp, cp, _ = fn(num_samples=k, device=device)
        out[name] = (cfg, sp, with_v_ref(cp))
    cfg, sp, cp, _ = full_body_launch(num_samples=k_fb, roll_off=roll_off, device=device)
    out["full_body"] = (cfg, sp, with_v_ref(cp))
    return out


def course_length(course):
    return float(np.sum(np.hypot(*np.diff(np.asarray(course, float), axis=0).T)))


def num_steps_for(course, v_ref, quick=False):
    # 3.5x the ideal-speed time: the tight corners make the controllers slow
    # well below v_ref, which is right, not a failure to finish
    n = int(course_length(course) / (v_ref * DT) * 3.5) + 100
    return min(n, 1000 if quick else 4600)


def truncate_at_completion(xy, course):
    """(cycles used, completed): the first cycle whose nearest course point
    is the final one and lies within COMPLETE_TOL of it, else all."""
    course = np.asarray(course, float)
    end = course[-1]
    d_end = np.hypot(xy[:, 0] - end[0], xy[:, 1] - end[1])
    # the nearest point must be the last one: a course whose early segment
    # passes near its own end must not be cut there
    d2 = ((xy[:, None, :] - course[None, :, :]) ** 2).sum(-1)
    nearest_is_last = np.argmin(d2, axis=1) == len(course) - 1
    hit = np.nonzero(nearest_is_last & (d_end < COMPLETE_TOL))[0]
    if len(hit) == 0:
        return len(xy), False
    return int(hit[0]) + 1, True


# the gradient-smoothed serving configuration (the second MPPI arm)
REFINE_OPTS = {"refine_steps": 3, "refine_method": "gauss_newton"}


def eval_mppi(cfg, sp, cp, course, v_ref, seed=0, quick=False,
              use_kernel=False, zmp_params=None, solver_options=None):
    """One closed-loop MPPI run on the device of ``sp``, cut at completion."""
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.runtime.loop import run_tracking_experiment

    steps = num_steps_for(course, v_ref, quick)
    out = run_tracking_experiment(
        cfg, sp, cp, course, num_steps=steps, dt=DT, seed=seed,
        use_kernel=use_kernel, solver_options=solver_options,
    )
    states = out["logs"]["state"]
    xy = np.concatenate([out["state0"][None, :2], states[:, :2]], axis=0)
    n, completed = truncate_at_completion(xy, course)
    m = tracking_metrics(xy[:n], course, dt=DT)
    cell = {
        "steps": int(n - 1), "completed": bool(completed),
        "time_s": round(m["time"], 1),
        "max_error_m": round(m["max_error"], 4),
        "rmse_m": round(m["rmse"], 4),
    }
    if zmp_params is not None:
        from ccv_mppi_path_tracker_tpu_torch.models.full_body import zmp_chain

        full_states = np.concatenate([out["state0"][None], states], axis=0)
        zmp = zmp_chain(torch.as_tensor(full_states[:n], dtype=torch.float32),
                        torch.as_tensor(out["logs"]["u0"][: n - 1], dtype=torch.float32),
                        DT, zmp_params).numpy()
        # skip the start transient (tests/test_full_stack_sim.py)
        z = np.abs(zmp[5:, 1]) if len(zmp) > 10 else np.abs(zmp[:, 1])
        cell["zmp_y_max_m"] = round(float(z.max()), 4)
        cell["zmp_y_rms_m"] = round(float(np.sqrt(np.mean(z ** 2))), 4)
    return cell


def eval_mppi_seeds(cfg, sp, cp, course, v_ref, seeds=(0, 1, 2), **kw):
    """The cell averaged over ``seeds`` (MPPI samples, so a marginal cell
    flips on sampling noise), each seed's RMSE kept for the spread."""
    runs = [eval_mppi(cfg, sp, cp, course, v_ref, seed=s, **kw)
            for s in seeds]
    cell = {
        "seeds": list(seeds),
        "steps": int(np.mean([r["steps"] for r in runs])),
        "completed": all(r["completed"] for r in runs),
        "time_s": round(float(np.mean([r["time_s"] for r in runs])), 1),
        "max_error_m": round(
            float(np.mean([r["max_error_m"] for r in runs])), 4),
        "rmse_m": round(float(np.mean([r["rmse_m"] for r in runs])), 4),
        "rmse_per_seed": [r["rmse_m"] for r in runs],
    }
    if "zmp_y_max_m" in runs[0]:
        cell["zmp_y_max_m"] = round(
            float(np.mean([r["zmp_y_max_m"] for r in runs])), 4)
        cell["zmp_y_rms_m"] = round(
            float(np.mean([r["zmp_y_rms_m"] for r in runs])), 4)
    return cell


def eval_pure_pursuit(course, v_ref, quick=False, device=None):
    """The pure-pursuit baseline on ``course`` (float32, on ``device``)."""
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.runtime.pure_pursuit import (
        PurePursuitConfig,
        run_pure_pursuit_experiment,
    )

    steps = num_steps_for(course, v_ref, quick)
    # the lookahead scales with speed (0.8 m floor)
    cfg = PurePursuitConfig(
        lookahead=max(0.8, 0.65 * v_ref), v_ref=v_ref, w_max=2.0
    )
    out = run_pure_pursuit_experiment(course, num_steps=steps, dt=DT, cfg=cfg,
                                      device=device)
    xy = np.concatenate(
        [np.asarray(course[:1], np.float64),
         out["logs"]["state"][:, :2]], axis=0,
    )
    n, completed = truncate_at_completion(xy, course)
    m = tracking_metrics(xy[:n], course, dt=DT)
    return {
        "steps": int(n - 1), "completed": bool(completed),
        "lookahead_m": round(cfg.lookahead, 2),
        "time_s": round(m["time"], 1),
        "max_error_m": round(m["max_error"], 4),
        "rmse_m": round(m["rmse"], 4),
    }


def solver_path(model, kernel_mode, device):
    """use_kernel for ``kernel_mode`` (auto: the port's policy on ``device``)."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import should_use_kernel

    if kernel_mode == "auto":
        return should_use_kernel(model, device)
    return kernel_mode == "kernel"


def card_of(device):
    """(backend, device_kind, power_limit) of ``device``; the power limit is
    the card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``."""
    if device.type != "cuda":
        return "cpu", "cpu", None
    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True)
    return "cuda", torch.cuda.get_device_name(device), out.stdout.strip()


def run_matrix(quick=False, kernel_mode="auto", device=None):
    from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params

    device = resolve_device(device)
    zmp_params = default_params(device="cpu")
    cells = []
    pp_cache = {}
    for course_name, course in courses().items():
        for v_ref in V_REFS:
            key = (course_name, v_ref)
            if key not in pp_cache:
                pp_cache[key] = eval_pure_pursuit(course, v_ref, quick, device)
            pp = pp_cache[key]
            for ctrl_name, (cfg, sp, cp) in controller_configs(
                v_ref, quick, device=device
            ).items():
                uk = solver_path(cfg.model, kernel_mode, device)
                zp = zmp_params if ctrl_name == "full_body" else None
                seeds = (0,) if quick else (0, 1, 2)
                cell = eval_mppi_seeds(
                    cfg, sp, cp, course, v_ref, seeds=seeds, quick=quick,
                    use_kernel=uk, zmp_params=zp,
                )
                refined = eval_mppi_seeds(
                    cfg, sp, cp, course, v_ref, seeds=seeds, quick=quick,
                    use_kernel=uk, zmp_params=zp,
                    solver_options=dict(REFINE_OPTS),
                )
                best = min(cell["rmse_m"], refined["rmse_m"])
                cell.update(
                    controller=ctrl_name, course=course_name, v_ref=v_ref,
                    K=cfg.num_samples, solver_path="kernel" if uk else "eager",
                    mppi_refined=refined, refine_opts=REFINE_OPTS,
                    pure_pursuit=pp,
                    mppi_beats_pp=bool(cell["rmse_m"] <= pp["rmse_m"]),
                    framework_beats_pp=bool(best <= pp["rmse_m"]),
                )
                cells.append(cell)
                print(
                    f"{course_name:>20} v={v_ref:<4} {ctrl_name:>10} "
                    f"[{cell['solver_path']}] rmse={cell['rmse_m']:.3f} "
                    f"refined={refined['rmse_m']:.3f} "
                    f"max={cell['max_error_m']:.3f} "
                    f"(pp rmse={pp['rmse_m']:.3f}) "
                    f"{'OK' if cell['framework_beats_pp'] else 'LOSS'}"
                    f"{'' if cell['mppi_beats_pp'] else ' (vanilla loss)'}",
                    flush=True,
                )

        # controlled against uncontrolled lateral ZMP at v=2.0 (the
        # reference's log/full_body/robo_sym/{controlled,uncontrolled}.png)
        v = 2.0
        arms = {}
        for arm, roll_off in (("controlled", False), ("uncontrolled", True)):
            cfg, sp, cp = controller_configs(v, quick, roll_off=roll_off,
                                             device=device)["full_body"]
            arms[arm] = eval_mppi(
                cfg, sp, cp, course, v, quick=quick,
                use_kernel=solver_path(cfg.model, kernel_mode, device),
                zmp_params=zmp_params,
            )
        cells.append({
            "controller": "full_body", "course": course_name,
            "v_ref": v, "experiment": "zmp_controlled_vs_uncontrolled",
            "controlled": arms["controlled"],
            "uncontrolled": arms["uncontrolled"],
            "zmp_reduction_pct": round(
                100.0 * (1.0 - arms["controlled"]["zmp_y_max_m"]
                         / max(arms["uncontrolled"]["zmp_y_max_m"], 1e-9)), 1,
            ),
            "zmp_rms_reduction_pct": round(
                100.0 * (1.0 - arms["controlled"]["zmp_y_rms_m"]
                         / max(arms["uncontrolled"]["zmp_y_rms_m"], 1e-9)), 1,
            ),
            "zmp_band_held": bool(arms["controlled"]["zmp_y_max_m"] < 0.15),
        })
        if (cells[-1]["zmp_reduction_pct"] < 0
                and cells[-1]["zmp_rms_reduction_pct"] > 0):
            # the quadratic ZMP cost (src/full_body_mppi.cpp:414) lowers the
            # mean square, not the peak: a brief transient at a corner can
            # leave the controlled arm's max above the uncontrolled one's
            cells[-1]["controlled_max_note"] = (
                "controlled max|zmp_y| exceeds uncontrolled: a brief "
                "roll-rate-reversal transient at the corridor corner "
                "(Hdot_G finite difference), the optimal trade under the "
                "quadratic (mean-square) zmp cost that halves RMS; "
                "max|zmp| is not in the objective"
            )
        print(
            f"{course_name:>20} v=2.0  zmp ctrl/unctrl max "
            f"{arms['controlled']['zmp_y_max_m']:.3f}/"
            f"{arms['uncontrolled']['zmp_y_max_m']:.3f} "
            f"band={'held' if cells[-1]['zmp_band_held'] else 'EXCEEDED'}",
            flush=True,
        )

    backend, kind, power_limit = card_of(device)
    return {
        "backend": backend,
        "device_kind": kind,
        "power_limit": power_limit,
        "dt": DT, "quick": quick, "kernel_mode": kernel_mode,
        "complete_tol_m": COMPLETE_TOL,
        "v_refs": list(V_REFS),
        "metric": "nearest-point tracking error (src/calc_e_rmse.py:36-49)",
        "cells": cells,
        "summary": summarize(cells),
    }


def summarize(cells):
    track = [c for c in cells if "experiment" not in c]
    zmp = [c for c in cells if c.get("experiment")]
    losses = [
        f"{c['controller']}/{c['course']}/v={c['v_ref']}"
        for c in track if not c["framework_beats_pp"]
    ]
    return {
        "tracking_cells": len(track),
        "vanilla_mppi_wins": sum(c["mppi_beats_pp"] for c in track),
        "framework_wins": sum(c["framework_beats_pp"] for c in track),
        "framework_losses": losses,
        # cells where a controller did not reach the course end inside the
        # step budget (slowed far below v_ref at the sharp corners)
        "incomplete_cells": sorted({
            f"{c['controller']}/{c['course']}/v={c['v_ref']}"
            for c in track
            if not (c["completed"] and c["mppi_refined"]["completed"])
        }),
        "zmp_experiments": len(zmp),
        # peak or rms lateral ZMP reduced by the controller on every course
        "zmp_all_reduced": all(
            c["zmp_reduction_pct"] > 0 or c["zmp_rms_reduction_pct"] > 0
            for c in zmp
        ),
        # the reference's band experiment ran on its cosine course
        # (log/full_body/robo_sym): the +-0.15 m gate applies there
        "zmp_band_held_ref_course": all(
            c["zmp_band_held"] for c in zmp
            if c["course"] == "cosine_A1.5_f0.127"
        ),
        "zmp_band_held_by_course": {
            c["course"]: c["zmp_band_held"] for c in zmp
        },
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="K=256, one seed, at most 1000 cycles a run")
    p.add_argument("--kernel", choices=("auto", "kernel", "eager"), default="auto")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu runs there)")
    p.add_argument("--out", default=os.path.join(ROOT, "artifacts",
                                                 "quality_matrix_torch.json"))
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    out = run_matrix(quick=args.quick, kernel_mode=args.kernel, device=args.device)
    wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {args.out} in {wall:.1f} s on {out['device_kind']} "
          f"(power limit {out['power_limit']})")
    print(json.dumps(out["summary"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
