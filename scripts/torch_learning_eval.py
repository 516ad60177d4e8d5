#!/usr/bin/env python3
"""The learned-method claims of the PyTorch port: the twin of
``scripts/learning_eval.py``, on the card.

COVERAGE.md cites the JAX package's numbers for the learned sampling
distribution's cold-start gain (diff/learned_sampler.py) and the
meta-trained update rule's realized-cost reduction at an equal sample budget
(diff/learned_optimizer.py), each also scored by closed-loop tracking RMSE.
This script reruns the four studies through the port, with the same
functions, sizes, seeds and arms, on held-out poses, and writes the JAX
artifact's keys, key for key, plus the ``device``, its ``power_limit`` and
each study's ``wall_seconds``:

- ``eval_sampler``: diff_drive K=256 T=10, 96 imitation states x 6 solves,
  ``fit_sampler`` hidden 32 for 300 steps, 24 held-out cold starts
  (``RandomState(7)``); each start's first solve from the zero center and
  from the learned proposal, through ``compile_step(cfg, use_kernel=False)``;
- ``eval_l2o``: ``meta_train`` at K=64 T=8, batch 32, 120 steps, 2
  iterations; ``evaluate_rule`` vanilla and learned on the poses of seed
  1234;
- ``eval_sampler_closed_loop``: 40 trials x 50 cycles through ``simulate``;
- ``eval_l2o_closed_loop``: 150 cycles on the training course and the
  held-out cosine course, seeds 11-13, each arm's receding-horizon cycle
  (``learned_update_step`` or ``mppi_step``, then the model's step) one
  ``KeyedGraph`` scan.

Every arm is the eager one (the JAX script's ``mppi_step`` and
``build_simulate_scan`` default to ``use_kernel=False``), and on the card
every loop above, the training programs included, replays a CUDA graph. The
generators are on the CPU, so the draws do not depend on the device. The
JAX artifact was made on a CPU (``artifacts/learning_eval.json``): only the
direction of each claim carries over (:func:`directions`).

    python3 scripts/torch_learning_eval.py --out artifacts/learning_eval_torch.json
    python3 scripts/torch_learning_eval.py --quick --device cpu   # not a claim run
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

# --quick: fewer trials, steps and states (the tests and chip_smoke); the
# full sizes are the JAX script's
QUICK = {"trials": 8, "imitation_states": 96, "fit_steps": 300, "meta_steps": 120,
         "closed_trials": 16, "cycles": 50, "l2o_steps": 100}
FULL = {"trials": 24, "imitation_states": 96, "fit_steps": 300, "meta_steps": 120,
        "closed_trials": 40, "cycles": 50, "l2o_steps": 150}


def _generator(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def _sizes(quick):
    return QUICK if quick else FULL


def _learned_sampler(device, sizes):
    """scripts/learning_eval.py:44-51: the imitation data and the fitted
    proposal, on ``device``."""
    from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu_torch.diff import collect_imitation_data, fit_sampler

    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=10, device=device)
    feats, targets = collect_imitation_data(cfg, sp, cp, course, _generator(0),
                                            num_states=sizes["imitation_states"],
                                            solve_cycles=6)
    net, losses = fit_sampler(feats, targets, _generator(1), hidden=32,
                              num_steps=sizes["fit_steps"])
    return cfg, sp, cp, course, net, losses


def _held_out_start(rng, course):
    """The next held-out start of ``RandomState(7)`` (scripts/learning_eval.py
    :58-64): a course point, shifted sideways and turned by 0.3 N(0, 1)."""
    j = rng.randint(0, len(course) - 2)
    yaw0 = np.arctan2(course[j + 1, 1] - course[j, 1], course[j + 1, 0] - course[j, 0])
    return np.asarray([course[j, 0], course[j, 1] + rng.randn() * 0.3,
                       yaw0 + rng.randn() * 0.3], np.float32)


def _proposal(net, cfg, sp, cp, path, dt, state):
    """The learned sampling center at ``state``, clipped to the box."""
    from ccv_mppi_path_tracker_tpu_torch.diff import proposal_mean
    from ccv_mppi_path_tracker_tpu_torch.paths.resample import resample_reference

    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    with torch.no_grad():
        return torch.clamp(proposal_mean(net, cfg, state, ref), sp.u_min, sp.u_max)


def eval_sampler(trials: int = 24, device=None, quick: bool = False):
    """Cold-start min cost: zero-centered sampling against the learned
    proposal (scripts/learning_eval.py:26-92)."""
    from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step

    cfg, sp, cp, course, net, losses = _learned_sampler(device, _sizes(quick))
    path = PathBuffer.from_points(course, 0.1, device=device)
    dt = torch.full((), 0.1, device=device)
    step = compile_step(cfg, use_kernel=False)
    rng = np.random.RandomState(7)  # held out from the training draws
    cold_costs, warm_costs = [], []
    for i in range(trials):
        state = torch.as_tensor(_held_out_start(rng, course), device=device)
        u_net = _proposal(net, cfg, sp, cp, path, dt, state)

        def first_cost(u_prev, seed):
            _, res = step(ControllerState(u_prev, seed, 0), state, path, dt, sp, cp)
            return float(res.stats["min_cost"])

        cold_costs.append(first_cost(torch.zeros_like(u_net), 100 + i))
        warm_costs.append(first_cost(u_net, 100 + i))
    cold, warm = float(np.mean(cold_costs)), float(np.mean(warm_costs))
    return {
        "train_seed": 0,
        "fit_seed": 1,
        "eval_seed": 7,
        "trials": trials,
        "imitation_loss_first": float(losses[0]),
        "imitation_loss_last": float(losses[-1]),
        "cold_start_mean_min_cost": round(cold, 4),
        "learned_proposal_mean_min_cost": round(warm, 4),
        "cold_start_cost_ratio": round(cold / warm, 3),
        "wins": int(sum(w <= c for w, c in zip(warm_costs, cold_costs))),
    }


def _meta_trained(device, sizes):
    """scripts/learning_eval.py:103-107: the meta-trained rule, on ``device``."""
    from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu_torch.diff import meta_train

    cfg, sp, cp, course = diff_drive_launch(num_samples=64, horizon=8, device=device)
    rule, losses = meta_train(cfg, sp, cp, course, _generator(0),
                              num_steps=sizes["meta_steps"], batch=32, iterations=2)
    return cfg, sp, cp, course, rule, losses


def eval_l2o(device=None, quick: bool = False):
    """The meta-trained update rule against vanilla at an equal sample and
    iteration budget (scripts/learning_eval.py:95-121)."""
    from ccv_mppi_path_tracker_tpu_torch.diff import evaluate_rule

    cfg, sp, cp, course, rule, losses = _meta_trained(device, _sizes(quick))
    vanilla = evaluate_rule(cfg, None, sp, cp, course, _generator(1234), iterations=2)
    learned = evaluate_rule(cfg, rule, sp, cp, course, _generator(1234), iterations=2)
    return {
        "train_seed": 0,
        "eval_seed": 1234,
        "meta_loss_first": float(losses[0]),
        "meta_loss_last": float(losses[-1]),
        "vanilla_realized_cost": round(vanilla, 4),
        "learned_realized_cost": round(learned, 4),
        "cost_reduction_pct": round(100.0 * (1.0 - learned / vanilla), 2),
    }


def _wilson_ci(wins: int, n: int, z: float = 1.959964):
    """95% Wilson score interval for a binomial proportion."""
    if n == 0:
        return (0.0, 1.0)
    p = wins / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * ((p * (1 - p) / n + z * z / (4 * n * n)) ** 0.5) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def eval_sampler_closed_loop(trials: int = 40, cycles: int = 50, device=None,
                             quick: bool = False):
    """The learned proposal's closed-loop cold-start value, paired trials
    (the same start pose and seed, only the first sampling center differs),
    a Wilson 95 % CI on the win rate (scripts/learning_eval.py:135-224).
    Every run is ``simulate``: on the card one CUDA graph of its cycle."""
    from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime import simulate

    cfg, sp, cp, course, net, _ = _learned_sampler(device, _sizes(quick))
    path = PathBuffer.from_points(course, 0.1, device=device)
    dt = torch.full((), 0.1, device=device)
    rng = np.random.RandomState(7)  # held out from the training draws
    cold_rmse, warm_rmse = [], []
    for i in range(trials):
        state0 = _held_out_start(rng, course)
        start = torch.as_tensor(state0, device=device)
        u_net = _proposal(net, cfg, sp, cp, path, dt, start)
        for u0, acc in ((torch.zeros_like(u_net), cold_rmse), (u_net, warm_rmse)):
            _, logs = simulate(cfg, ControllerState(u0, 100 + i, 0), start, path, dt, sp,
                               cp, num_steps=cycles, with_stats=False)
            xy = np.concatenate([state0[None, :2], logs["state"][:, :2].cpu().numpy()])
            acc.append(float(tracking_metrics(xy, course, dt=0.1)["rmse"]))
    cold, warm = np.asarray(cold_rmse), np.asarray(warm_rmse)
    diff = cold - warm  # > 0: the learned proposal tracks better
    wins = int((diff > 0).sum())
    lo, hi = _wilson_ci(wins, trials)
    return {
        "trials": trials, "cycles": cycles, "eval_seed": 7,
        "cold_start_closed_loop_rmse": round(float(cold.mean()), 4),
        "cold_std": round(float(cold.std(ddof=1)), 4),
        "learned_proposal_closed_loop_rmse": round(float(warm.mean()), 4),
        "warm_std": round(float(warm.std(ddof=1)), 4),
        "rmse_reduction_pct": round(100.0 * (1.0 - float(warm.mean()) / float(cold.mean())),
                                    1),
        "paired_diff_mean": round(float(diff.mean()), 4),
        "paired_diff_std": round(float(diff.std(ddof=1)), 4),
        "paired_t_stat": round(float(diff.mean() / (diff.std(ddof=1) / np.sqrt(trials))), 2),
        "wins": wins,
        "win_rate": round(wins / trials, 3),
        "win_rate_wilson95": [round(lo, 3), round(hi, 3)],
        "per_trial_rmse": {
            "cold": [round(v, 4) for v in cold_rmse],
            "learned": [round(v, 4) for v in warm_rmse],
        },
    }


def l2o_cycle(carry, path, dt, cfg, sp, cp, rule):
    """One receding-horizon cycle of scripts/learning_eval.py:273-282:
    ``mppi_step`` (``rule`` None) or ``learned_update_step`` with the rule's
    tensors, then the model's step on u0."""
    from ccv_mppi_path_tracker_tpu_torch.diff.learned_optimizer import (
        RuleTensors,
        learned_update_step,
    )
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

    ctrl, state = carry
    if rule is None:
        ctrl, res = mppi_step(cfg, ctrl, state, path, dt, sp, cp)
    else:
        ctrl, res = learned_update_step(cfg, RuleTensors(*rule), ctrl, state, path, dt, sp,
                                        cp)
    state = get_model(cfg.model).step(state, res.u0, dt)
    return (ctrl, state), state


def _cycle_graph():
    from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph

    return KeyedGraph(l2o_cycle, max_graphs=4)


def eval_l2o_closed_loop(num_steps: int = 150, device=None, quick: bool = False):
    """The meta-trained rule's closed-loop value: ``learned_update_step``
    against ``mppi_step`` on the training course and a held-out course, the
    same seeds, executed RMSE (scripts/learning_eval.py:227-303). Each run is
    one scan of :func:`l2o_cycle`: on the card one CUDA graph an arm."""
    from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, sum_of_cosines_course

    cfg, sp, cp, course, rule, _ = _meta_trained(device, _sizes(quick))
    held_out = sum_of_cosines_course(
        amplitudes=(0.8, 0.0, 0.0), frequencies=(0.2, 0.0, 0.0), deltas=(0.0, 0.0, 0.0),
        resolution=0.1, course_length=10.0, dtype=np.float32)
    u_dim = get_model(cfg.model).num_controls
    arms = {None: _cycle_graph(), "learned": _cycle_graph()}
    tensors = rule.tensors()

    def closed_loop_rmse(learned, course_pts, seed):
        path = PathBuffer.from_points(np.asarray(course_pts, np.float32), 0.1, device=device)
        yaw0 = float(np.arctan2(course_pts[1, 1] - course_pts[0, 1],
                                course_pts[1, 0] - course_pts[0, 0]))
        state0 = torch.tensor([course_pts[0, 0], course_pts[0, 1], yaw0],
                              dtype=torch.float32, device=device)
        ctrl = ControllerState.initial(seed, cfg.horizon, u_dim, device=device)
        _, states = arms[learned].scan(
            (ctrl, state0), path, torch.full((), 0.1, device=device), cfg, sp, cp,
            tensors if learned else None, length=num_steps)
        xy = np.concatenate([state0[None, :2].cpu().numpy(), states[:, :2].cpu().numpy()])
        return tracking_metrics(xy, course_pts, dt=0.1)["rmse"]

    out = {"num_steps": num_steps, "eval_seeds": [11, 12, 13]}
    for name, pts in (("train_course", course), ("held_out_course", held_out)):
        v = float(np.mean([closed_loop_rmse(None, pts, s) for s in (11, 12, 13)]))
        lr = float(np.mean([closed_loop_rmse("learned", pts, s) for s in (11, 12, 13)]))
        out[name] = {
            "vanilla_rmse": round(v, 4),
            "learned_rmse": round(lr, 4),
            "rmse_reduction_pct": round(100.0 * (1.0 - lr / v), 1),
        }
    return out


def directions(out) -> dict:
    """Whether each claim points the JAX artifact's way: claim -> (held,
    the numbers it rests on). The learned proposal lowers the cold-start
    cost (ratio > 1) and wins the closed loop on more than half the trials
    with a lower mean RMSE; the meta-trained rule lowers the realized cost,
    and the closed-loop RMSE on both courses."""
    s, o = out["learned_sampler"], out["learned_optimizer"]
    sc, oc = out["learned_sampler_closed_loop"], out["learned_optimizer_closed_loop"]
    return {
        "learned_sampler.cold_start_cost_ratio > 1": (
            s["cold_start_cost_ratio"] > 1.0, s["cold_start_cost_ratio"]),
        "learned_optimizer.cost_reduction_pct > 0": (
            o["cost_reduction_pct"] > 0.0, o["cost_reduction_pct"]),
        "learned_sampler_closed_loop: win_rate > 0.5 and rmse_reduction_pct > 0": (
            sc["win_rate"] > 0.5 and sc["rmse_reduction_pct"] > 0.0,
            [sc["win_rate"], sc["rmse_reduction_pct"]]),
        "learned_optimizer_closed_loop: rmse_reduction_pct > 0 on both courses": (
            oc["train_course"]["rmse_reduction_pct"] > 0.0
            and oc["held_out_course"]["rmse_reduction_pct"] > 0.0,
            [oc["train_course"]["rmse_reduction_pct"],
             oc["held_out_course"]["rmse_reduction_pct"]]),
    }


def card_of(device):
    """(device name, power limit) of ``device``: the power limit is the
    card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``; ("cpu", None) off the card."""
    if device.type != "cuda":
        return "cpu", None
    index = torch.cuda.current_device() if device.index is None else device.index
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True).stdout.strip()
    return torch.cuda.get_device_name(device), line


def run(trials: int = 24, device=None, quick: bool = False) -> dict:
    """The four studies on ``device`` (None: the card), each with its wall
    seconds (host clock, ending in the study's own reads of the results)."""
    from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    sizes = _sizes(quick)
    if quick:
        trials = min(trials, sizes["trials"])
    studies = (
        ("learned_sampler", lambda: eval_sampler(trials, device, quick)),
        ("learned_optimizer", lambda: eval_l2o(device, quick)),
        # closed-loop evidence: the same components scored by executed
        # tracking RMSE through the receding-horizon loop
        ("learned_sampler_closed_loop", lambda: eval_sampler_closed_loop(
            sizes["closed_trials"], sizes["cycles"], device, quick)),
        ("learned_optimizer_closed_loop", lambda: eval_l2o_closed_loop(
            sizes["l2o_steps"], device, quick)),
    )
    name, power_limit = card_of(device)
    out = {"device": name, "power_limit": power_limit}
    for key, study in studies:
        t0 = time.perf_counter()
        out[key] = study()
        out[key]["wall_seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=24)
    p.add_argument("--out", default=None,
                   help="also write the JSON to this path "
                        "(e.g. artifacts/learning_eval_torch.json)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu runs there)")
    p.add_argument("--quick", action="store_true",
                   help=f"fewer trials, steps and states ({QUICK}): not a claim run")
    args = p.parse_args(argv)
    out = run(args.trials, args.device, args.quick)
    print(json.dumps(out, indent=2))
    print(json.dumps({claim: held for claim, (held, _) in directions(out).items()}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
