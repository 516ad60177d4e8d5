#!/usr/bin/env python3
"""One process of a sample-sharded run of the PyTorch port over
``torch.distributed`` (the port's twin of scripts/multiprocess_worker.py).

Launched N times with one coordinator address; the processes join one group
(parallel/multihost.py initialize_multihost) and each runs K/N of the samples
(parallel/sharded.py). Each writes what it computed to ``--out`` as npz.
Imports torch and numpy only.

    python3 scripts/torch_multiprocess_worker.py --mode parity \\
        --coordinator localhost:29511 --world-size 4 --rank R \\
        --problem problem.npz --out rR.npz --device cpu

Modes:

- ``parity`` (CPU, gloo; tests/test_torch_parallel.py): the eager sharded
  step of each model under the injected noise of ``--problem`` (written by
  the test from the JAX package's parameters), elite, stale elite and
  adapt_sigma; the kernel's plain version in RNG mode at this rank's
  ``first_sample`` and the sharded kernel-path step; an 80-cycle sharded
  closed loop; the divisibility error; and the system-identification
  gradient and fits on this rank's share of a batch.
- ``custom`` (CPU, gloo; tests/test_torch_custom_model.py): the sharded
  step of examples/custom_model_torch.py's kinematic bicycle.
- ``card`` (one CUDA card shared by the ranks, gloo; chip_smoke.py phase
  25): the sharded kernel update at the flagship (K=102400, T=30) with its
  per-sample costs, elite 0.1, a 200-cycle sharded closed loop with its
  launch count, and CUDA-event times of the sharded update.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, SolverConfig  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.parallel import (  # noqa: E402
    build_sharded_simulate,
    build_sharded_step,
    initialize_multihost,
    samples_group,
)

MODELS = ("full_body", "unicycle", "steering_unicycle", "rate_limited_steering")
ELITE, STALE = 0.25, 40.0
LOOP_K, LOOP_T, LOOP_STEPS = 512, 15, 80
GRAD_B, GRAD_T, FIT_B, FIT_STEPS = 128, 16, 256, 100
DT = 0.1


def problem(data, model, device, dtype):
    """(cfg, sp, cp, mp, u_prev, path, state, noise) of ``model`` from the
    problem file's arrays, on ``device``."""
    def fields(prefix):
        return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}

    mp = fields(f"{model}/mp/") or None
    path = {"xy": data["path/xy"], "num_valid": data["path/num_valid"],
            "resolution": data["path/resolution"]}
    sp, cp, mp, u_prev, path = from_numpy(fields(f"{model}/sp/"), fields(f"{model}/cp/"),
                                          mp, data[f"{model}/u_prev"], path,
                                          device=device, dtype=dtype)
    k = data[f"{model}/noise"].shape[1]
    cfg = SolverConfig(model=model, num_samples=k, horizon=u_prev.shape[0] + 1)

    def tensor(name):
        return torch.as_tensor(data[f"{model}/{name}"], device=device).to(dtype)

    return cfg, sp, cp, mp, u_prev, path, tensor("state"), tensor("noise")


def grad_data(dtype=np.float64):
    """The system-ID batches, the same in every process and in the test:
    rollout-gradient data (state0 (B, 3), controls (T, B, 2), observed
    (T, B, 3)); one-step fit data (states, controls) of a unicycle, whose
    next states come from gains [0.9, 1.2]; and ZMP-fit data (states
    (12, 64, 5), controls (11, 64, 5)), tests/test_diff.py:71-88's."""
    rng = np.random.RandomState(3)
    grad = (np.zeros((GRAD_B, 3), dtype), rng.randn(GRAD_T, GRAD_B, 2).astype(dtype) * 0.5,
            rng.randn(GRAD_T, GRAD_B, 3).astype(dtype) * 0.1)
    rng = np.random.RandomState(4)
    fit = (rng.randn(FIT_B, 3).astype(dtype), rng.randn(FIT_B, 2).astype(dtype))
    rng = np.random.RandomState(2)
    zmp = (rng.randn(12, 64, 5).astype(dtype) * 0.2, rng.randn(11, 64, 5).astype(dtype) * 0.5)
    return grad, fit, zmp


def run_parity(args, group, device, out):
    from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu_torch.diff import (
        ControlGains,
        fit_control_gains,
        fit_full_body_params,
        rollout_prediction_value_and_grad,
    )
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
        pack_scalars,
    )
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params, zmp_chain
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference

    data = np.load(args.problem)
    f64 = torch.float64
    for model in MODELS:
        cfg, sp, cp, mp, u_prev, path, state, noise = problem(data, model, device, f64)
        ctrl = ControllerState(u_prev=u_prev, seed=0, step=0)
        step = build_sharded_step(cfg, group)
        _, res = step(ctrl, state, path, DT, sp, cp, model_params=mp, noise=noise)
        for name in ("min_cost", "mean_cost", "ess"):
            out[f"{model}/{name}"] = res.stats[name]
        out[f"{model}/u_opt"] = res.u_opt
        if model != "full_body":
            continue
        for tag, opts in (("elite", {"elite_frac": ELITE}),
                          ("stale", {"elite_frac": ELITE,
                                     "elite_stale_thresh": torch.tensor(STALE, dtype=f64)}),
                          ("sigma", {"adapt_sigma": True}),
                          ("elite_sigma", {"elite_frac": ELITE, "adapt_sigma": True})):
            step = build_sharded_step(cfg, group, solver_options=opts)
            _, res = step(ctrl, state, path, DT, sp, cp, model_params=mp, noise=noise)
            out[f"{tag}/u_opt"] = res.u_opt
            for name, value in res.stats.items():
                out[f"{tag}/{name}"] = value
        # the kernel's plain version in RNG mode at this rank's first sample,
        # and the sharded kernel-path step, at float32
        cfg32, sp32, cp32, mp32, u32, path32, state32, _ = problem(data, model, device,
                                                                  torch.float32)
        k_local = cfg32.num_samples // args.world_size
        first = args.rank * k_local
        ref = resample_reference(path32, state32[:2], cp32.v_ref, DT, cfg32.horizon)
        scal = pack_scalars(torch.tensor(DT), cp32, ref.yaw[0], mp32, sp32.noise_beta,
                            sp32.lam)
        costs, u_num, norm = fused_sample_rollout_cost(
            u32, sp32.control_noise, sp32.u_min, sp32.u_max, ref.xy, state32, scal,
            seed=11, step=3, num_samples=k_local, model=model, first_sample=first)
        out["kernel/costs"] = costs
        ctrl32 = ControllerState(u_prev=u32, seed=11, step=3)
        for tag, opts in (("kernel", {}), ("kernel_elite", {"elite_frac": ELITE})):
            step = build_sharded_step(cfg32, group, use_kernel=True, solver_options=opts)
            _, res = step(ctrl32, state32, path32, DT, sp32, cp32, model_params=mp32)
            out[f"{tag}/u_opt"] = res.u_opt
            for name, value in res.stats.items():
                out[f"{tag}/{name}"] = value

    # an 80-cycle sharded closed loop, diff_drive (tests/test_sharding.py:79-93)
    cfg, sp, cp, course = diff_drive_launch(num_samples=LOOP_K, horizon=LOOP_T, device=device)
    sim = build_sharded_simulate(cfg, group, num_steps=LOOP_STEPS)
    slope = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    state0 = torch.tensor([course[0, 0], course[0, 1], slope], dtype=torch.float32,
                          device=device)
    ctrl, logs = sim(ControllerState.initial(0, LOOP_T, 2, device=device), state0,
                     PathBuffer.from_points(course, 0.1, device=device),
                     torch.tensor(DT, device=device), sp, cp)
    out["loop/state"] = logs["state"]
    out["loop/course"] = course
    out["loop/steps"] = ctrl.step
    try:
        build_sharded_step(SolverConfig(model="unicycle", num_samples=LOOP_K + 2), group)
        out["divisibility_error"] = ""
    except ValueError as e:
        out["divisibility_error"] = str(e)

    # system identification on this rank's share of the batch
    (state0, controls, observed), (states, u), (zs, zc) = grad_data()
    b = GRAD_B // args.world_size
    sl = slice(args.rank * b, (args.rank + 1) * b)

    def t(x):
        return torch.as_tensor(x, device=device)

    gains = ControlGains(gains=torch.tensor([1.1, 0.9], dtype=f64, device=device))
    for c in (1, 4, 8):
        loss, grad = rollout_prediction_value_and_grad(
            "unicycle", gains, t(state0[sl]), t(controls[:, sl]), t(observed[:, sl]), DT,
            num_chunks=c, group=group)
        out[f"grad_loss_{c}"], out[f"grad_gains_{c}"] = loss, grad.gains
    b = FIT_B // args.world_size
    sl = slice(args.rank * b, (args.rank + 1) * b)
    true = torch.tensor([0.9, 1.2], dtype=f64, device=device)
    nxt = get_model("unicycle").step(t(states[sl]), t(u[sl]) * true, DT)
    fitted, losses = fit_control_gains("unicycle", t(states[sl]), t(u[sl]), nxt, DT,
                                       num_steps=FIT_STEPS, group=group)
    out["fit/gains"], out["fit/losses"] = fitted.gains, losses
    b = zs.shape[1] // args.world_size
    sl = slice(args.rank * b, (args.rank + 1) * b)
    true = default_params(device=device, dtype=f64)
    observed = zmp_chain(t(zs[:, sl]), t(zc[:, sl]), DT, true)[..., 1]
    init = dataclasses.replace(true, base2com=torch.full((), 0.6, dtype=f64, device=device))
    fitted, losses = fit_full_body_params(t(zs[:, sl]), t(zc[:, sl]), observed, DT, init,
                                          num_steps=FIT_STEPS, group=group)
    out["zmp_fit/mass"], out["zmp_fit/base2com"] = fitted.mass, fitted.base2com
    out["zmp_fit/losses"] = losses


def run_custom(args, group, device, out):
    sys.path.insert(0, str(ROOT / "examples"))
    import custom_model_torch as cm

    k, t = 256, 10
    cfg, sp, cp, course, path = cm.make_problem(num_samples=k, horizon=t, device=device)
    ctrl = ControllerState.initial(0, t, 2, device=device)
    state = torch.tensor([0.0, float(course[0, 1]), 0.0], device=device)
    noise = torch.as_tensor(np.random.RandomState(3).randn(t - 1, k, 2),
                            dtype=torch.float32, device=device)
    _, res = build_sharded_step(cfg, group)(ctrl, state, path, DT, sp, cp, noise=noise)
    out["custom/u_opt"] = res.u_opt
    out["custom/rmse"] = cm.closed_loop_rmse(steps=30, num_samples=1024, horizon=16,
                                             device=device, group=group)["rmse"]


def run_card(args, group, device, out):
    import chip_smoke as smoke

    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
    )
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer

    s = smoke.kernel_case("full_body", smoke.K_MAIN, smoke.T_MAIN, seed=25,
                          device=str(device))
    cfg = s["cfg"]
    k_local = cfg.num_samples // args.world_size
    kw = dict(seed=7, step=9, model=s["model"])
    costs = fused_sample_rollout_cost(*s["kargs"], num_samples=k_local,
                                      first_sample=args.rank * k_local, **kw)[0]
    out["costs"] = costs
    ctrl = ControllerState(u_prev=s["u_prev"], seed=7, step=9)
    args6 = (ctrl, s["state"], s["path"], s["dt"], s["sp"], s["cp"])
    steps = {tag: build_sharded_step(cfg, group, use_kernel=True, solver_options=opts)
             for tag, opts in (("vanilla", {}), ("elite", {"elite_frac": 0.1}))}
    for tag, step in steps.items():
        _, res = step(*args6, model_params=s["mp"])
        out[f"{tag}/u_opt"] = res.u_opt
        for name, value in res.stats.items():
            out[f"{tag}/{name}"] = value

    # the sharded update's time, CUDA events (the ranks meet in every
    # collective, so each rank's time is the group's)
    carry = [ctrl]

    def update():
        carry[0], _ = steps["vanilla"](carry[0], *args6[1:], model_params=s["mp"])

    times = smoke.time_interleaved({"sharded": (update, 10)}, 5)["sharded"]
    out["update_ms"] = np.array(times)

    # a 200-cycle sharded closed loop on the kernel path
    cfg, sp, cp, course = PRESETS["full_body"](num_samples=smoke.K_MAIN,
                                               horizon=smoke.T_MAIN, device=device)
    sim = build_sharded_simulate(cfg, group, num_steps=smoke.STEPS, use_kernel=True)
    start = np.zeros(5)
    start[:2] = course[0]
    start[2] = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    fused_sample_rollout_cost.launches = 0
    t0 = time.perf_counter()
    _, logs = sim(ControllerState.initial(0, cfg.horizon, 5, device=device),
                  torch.tensor(start, dtype=torch.float32, device=device),
                  PathBuffer.from_points(course, 0.1, device=device),
                  torch.full((), 0.1, device=device), sp, cp)
    states = logs["state"].cpu().numpy()
    out["loop/wall_s"] = time.perf_counter() - t0
    out["loop/launches"] = fused_sample_rollout_cost.launches
    out["loop/xy"] = np.concatenate([start[None, :2], states[:, :2]])
    out["loop/course"] = course


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["parity", "custom", "card"], required=True)
    p.add_argument("--coordinator", required=True, help="host:port of rank 0's store")
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--problem", help="the parity mode's npz of inputs")
    p.add_argument("--device", default=None,
                   help="this rank's device (default cuda:{local rank}; cpu for the "
                        "parity and custom modes' CPU runs)")
    p.add_argument("--backend", default="gloo")
    p.add_argument("--timeout", type=float, default=120.0)
    args = p.parse_args()
    if args.mode == "card" and args.device and torch.device(args.device).type != "cuda":
        raise SystemExit(f"--mode card runs on a CUDA device, not {args.device}")
    torch.set_num_threads(1)  # N ranks share the host's cores
    initialize_multihost(args.coordinator, args.world_size, args.rank,
                         backend=args.backend, timeout_s=args.timeout)
    group, device = samples_group(device=args.device)
    out = {}
    {"parity": run_parity, "custom": run_custom, "card": run_card}[args.mode](
        args, group, device, out)
    out.update(world_size=torch.distributed.get_world_size(),
               rank=torch.distributed.get_rank())
    np.savez(args.out, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v) for k, v in out.items()})
    torch.distributed.destroy_process_group()
    print(f"rank {args.rank} of {args.world_size}: ok ({args.mode})", flush=True)


if __name__ == "__main__":
    main()
