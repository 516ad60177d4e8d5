#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ccv_mppi_path_tracker_tpu_torch only (no JAX) through its main path:
the full-body MPPI control update through the fused CUDA kernel at the
benchmark's size (K=102400 samples, T=30 horizon, float32) and the closed
loop that repeats it against the plant. Phases, each printed on one line,
the first failure ending the run with a non-zero exit:

  1. build the kernel from csrc/ with nvcc; print the card and its power limit;
  2. kernel vs its plain PyTorch version, injected noise, at K=102400 T=30
     and K=10000 T=15 (masked tail), roll_off=False weights;
  3. in-kernel RNG mode: vs the plain version on the same (seed, step),
     determinism, finiteness, box, and the sample mean at lambda=1e30;
  4. mppi_step(use_kernel=True, lean=True) vs the eager path, same noise;
  5. 200-cycle closed loop through run_tracking_experiment on the kernel
     path: finite states, RMSE < 0.15 m, exactly 200 kernel launches;
  6. CUDA-event timings (median of repetitions after warm-up).

The last two lines are the card's name and power limit as nvidia-smi prints
them and {"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

K_MAIN, T_MAIN = 102_400, 30   # bench.py's flagship control update
K_REF, T_REF = 10_000, 15      # full_body_launch defaults (reference node)
COST_RTOL = 2e-5               # tests/test_kernel.py costs tolerance
STEPS = 200


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def u_bound(u_ref):
    """scripts/tpu_smoke.py's parity bound on u_opt."""
    return 5e-4 * float(u_ref.abs().max()) + 5e-5


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import ccv_mppi_path_tracker_tpu_torch as port
    except ImportError as e:
        print(f"chip_smoke: the port package is not next to this script: {e}",
              file=sys.stderr)
        return 1
    if Path(port.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: imported the port from {port.__file__}, not from "
              f"this checkout", file=sys.stderr)
        return 1

    from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        SOURCE,
        KernelLaunch,
        fused_sample_rollout_cost,
        fused_sample_rollout_cost_reference,
        pack_scalars,
    )
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
    from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment
    from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")

    # --- 1. build -------------------------------------------------------
    lib_path, build_s, log = build.build("rollout_cost")
    ptxas = [ln.strip() for ln in (log or "").splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[1 build] {lib_path.name} in {build_s:.2f} s; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; ptxas: {' | '.join(ptxas) or 'cached'}",
          flush=True)
    print(f"[1 card] {card}", flush=True)

    def setup(k, t, roll_off=False, seed=0):
        cfg, sp, cp, course = full_body_launch(num_samples=k, horizon=t,
                                               roll_off=roll_off, device=dev)
        path = PathBuffer.from_points(course, 0.1, device=dev)
        rng = np.random.RandomState(seed)
        state = torch.tensor([0.05, course[0, 1] + 0.1, 0.1, 0.02, -0.03],
                             dtype=torch.float32, device=dev)
        u_prev = torch.tensor(rng.randn(t - 1, 5) * 0.2, dtype=torch.float32,
                              device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        noise = torch.randn((t - 1, k, 5), generator=gen, device=dev)
        dt = torch.full((), 0.1, device=dev)
        mp = default_params(device=dev)
        ref = resample_reference(path, state[:2], cp.v_ref, dt, t)
        scal = pack_scalars(dt, cp, ref.yaw[0], mp, sp.noise_beta, sp.lam)
        kargs = (u_prev, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state, scal)
        return dict(cfg=cfg, sp=sp, cp=cp, course=course, path=path,
                    state=state, u_prev=u_prev, noise=noise, dt=dt, mp=mp,
                    kargs=kargs)

    def compare(tag, kern, plain):
        (ck, uk, nk), (cr, ur, nr) = kern, plain
        torch.cuda.synchronize()
        uo_k, uo_r = uk / nk, ur / nr
        cost_rel = float(((ck - cr).abs() / cr.abs()).max())
        u_err = float((uo_k - uo_r).abs().max())
        bound = u_bound(uo_r)
        print(f"  {tag}: costs max rel err {cost_rel:.3e} (rtol {COST_RTOL}); "
              f"u_opt max abs err {u_err:.3e} (bound {bound:.3e})", flush=True)
        require(bool(torch.isfinite(ck).all()) and bool(torch.isfinite(uo_k).all()),
                f"{tag}: non-finite kernel output")
        require(cost_rel <= COST_RTOL, f"{tag}: costs differ by {cost_rel}")
        require(u_err <= bound, f"{tag}: u_opt differs by {u_err} > {bound}")
        return u_err

    # --- 2. kernel vs plain version, injected noise ------------------------
    print("[2 noise-input mode] kernel vs plain version", flush=True)
    max_abs_err = None
    for k, t in ((K_MAIN, T_MAIN), (K_REF, T_REF)):
        s = setup(k, t)
        kw = dict(seed=0, step=0, num_samples=k, noise=s["noise"])
        err = compare(f"K={k} T={t}",
                      fused_sample_rollout_cost(*s["kargs"], **kw),
                      fused_sample_rollout_cost_reference(*s["kargs"], **kw))
        if k == K_MAIN:
            max_abs_err = err

    # --- 3. RNG mode ---------------------------------------------------
    print("[3 RNG mode]", flush=True)
    s = setup(K_MAIN, T_MAIN)
    kw = dict(num_samples=K_MAIN)
    a = fused_sample_rollout_cost(*s["kargs"], seed=123, step=7, **kw)
    compare(f"K={K_MAIN} T={T_MAIN} seed=123 step=7", a,
            fused_sample_rollout_cost_reference(*s["kargs"], seed=123, step=7, **kw))
    b = fused_sample_rollout_cost(*s["kargs"], seed=123, step=7, **kw)
    c = fused_sample_rollout_cost(*s["kargs"], seed=124, step=7, **kw)
    ua, ub, uc = a[1] / a[2], b[1] / b[2], c[1] / c[2]
    sp = s["sp"]
    same = bool(torch.equal(ua, ub) and torch.equal(a[0], b[0]))
    differs = bool((ua - uc).abs().max() > 1e-7)
    finite = bool(torch.isfinite(ua).all())
    in_box = bool((ua <= sp.u_max + 1e-6).all() and (ua >= sp.u_min - 1e-6).all())
    print(f"  same (seed, step) bit-identical {same}; other seed differs {differs}; "
          f"finite {finite}; inside box {in_box}", flush=True)
    require(same and differs and finite and in_box, "RNG-mode determinism/box")
    # lambda = 1e30: every weight is 1, u_opt is the mean of the clamped draws
    sigma = 0.5
    box = torch.ones(5, device=dev)
    scal = s["kargs"][6].clone()
    scal[16] = 1e30
    zeros = torch.zeros_like(s["u_prev"])
    _, un, nm = fused_sample_rollout_cost(
        zeros, torch.full((5,), sigma, device=dev), -box, box, s["kargs"][4],
        s["state"], scal, seed=99, step=1, num_samples=K_MAIN)
    mean_max = float((un / nm).abs().max())
    lim = 5 * sigma / K_MAIN ** 0.5
    print(f"  lambda=1e30 sample mean: max |u_opt| {mean_max:.3e} < {lim:.3e}; "
          f"norm {float(nm):.1f} (K={K_MAIN})", flush=True)
    require(mean_max < lim, "RNG-mode sample mean off zero")

    # --- 4. mppi_step kernel-lean vs eager-lean --------------------------
    s = setup(K_MAIN, T_MAIN, seed=3)
    ctrl = ControllerState(u_prev=s["u_prev"], seed=0, step=0)
    step_args = (s["cfg"], ctrl, s["state"], s["path"], s["dt"], s["sp"], s["cp"])
    _, rk = mppi_step(*step_args, model_params=s["mp"], noise=s["noise"],
                      use_kernel=True, lean=True)
    _, re = mppi_step(*step_args, model_params=s["mp"], noise=s["noise"],
                      use_kernel=False, lean=True)
    err = float((rk.u_opt - re.u_opt).abs().max())
    bound = u_bound(re.u_opt)
    print(f"[4 mppi_step] kernel-lean vs eager-lean K={K_MAIN} T={T_MAIN}: "
          f"u_opt max abs err {err:.3e} (bound {bound:.3e})", flush=True)
    require(err <= bound, f"mppi_step kernel vs eager differ by {err}")
    # no host sync inside mppi_step: under this mode any sync raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for use_kernel in (True, False):
            for lean in (True, False):
                mppi_step(*step_args, use_kernel=use_kernel, lean=lean)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  no host sync inside mppi_step (kernel and eager, lean and full, "
          "RNG mode, default model params)", flush=True)

    # --- 5. closed loop through the user entry point ---------------------
    cfg, sp, cp, course = full_body_launch(num_samples=K_MAIN, horizon=T_MAIN,
                                           device=dev)
    fused_sample_rollout_cost.launches = 0
    t0 = time.perf_counter()
    out = run_tracking_experiment(cfg, sp, cp, course, num_steps=STEPS, dt=0.1,
                                  use_kernel=True)
    wall = time.perf_counter() - t0
    launches = fused_sample_rollout_cost.launches
    m = out["metrics"]
    finite = bool(np.isfinite(out["logs"]["state"]).all())
    print(f"[5 closed loop] {STEPS} cycles K={K_MAIN} T={T_MAIN}: RMSE "
          f"{m['rmse']:.4f} m, max error {m['max_error']:.4f} m, finite {finite}, "
          f"kernel launches {launches}; wall {wall:.3f} s = "
          f"{STEPS / wall:.1f} cycles/s (host clock) on {card}", flush=True)
    require(finite, "closed-loop states not finite")
    require(m["rmse"] < 0.15, f"closed-loop RMSE {m['rmse']} >= 0.15")
    require(launches == STEPS, f"kernel launched {launches} times, not {STEPS}")

    # --- 6. timing --------------------------------------------------------
    def event_ms(fn, inner):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner

    s = setup(K_MAIN, T_MAIN, roll_off=True, seed=5)
    carry = {"kernel": ControllerState(s["u_prev"], 0, 0),
             "eager": ControllerState(s["u_prev"], 0, 0)}

    def update(kind):
        def fn():
            carry[kind], _ = mppi_step(
                s["cfg"], carry[kind], s["state"], s["path"], s["dt"], s["sp"],
                s["cp"], model_params=s["mp"], use_kernel=kind == "kernel",
                lean=True)
        return fn

    kw = dict(seed=1, step=2, num_samples=K_MAIN)
    # kernel_alone: launches of prepared operands only (the host enqueues
    # faster than the card runs them, so the events time the device);
    # kernel_wrapper: the whole wrapper, operand preparation and finish too
    launch = KernelLaunch(*s["kargs"], steer_off=False, noise=None, **kw)
    arms = {
        "update_kernel_lean": (update("kernel"), 20),
        "update_eager_lean": (update("eager"), 5),
        "kernel_alone": (launch.run, 50),
        "kernel_wrapper": (lambda: fused_sample_rollout_cost(*s["kargs"], **kw), 20),
        "plain_alone": (
            lambda: fused_sample_rollout_cost_reference(*s["kargs"], **kw), 3),
    }
    for fn, inner in arms.values():  # warm-up
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in arms}
    reps = 7
    for r in range(reps):  # interleaved, order alternating between reps
        order = list(arms) if r % 2 == 0 else list(reversed(arms))
        for name in order:
            fn, inner = arms[name]
            times[name].append(event_ms(fn, inner))
    med = {name: statistics.median(v) for name, v in times.items()}
    props = K_MAIN * (T_MAIN - 1)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"[6 timing] K={K_MAIN} T={T_MAIN}, median of {reps} CUDA-event reps, "
          f"on {card} (after: sm clock, draw, limit, temp = {clocks})", flush=True)
    for name, ms in med.items():
        rate = (f"; {props / (ms * 1e-3):.4e} propagations/s"
                if name.startswith("update") else "")
        spread = f"[{min(times[name]):.4f}, {max(times[name]):.4f}]"
        print(f"  {name}: {ms:.4f} ms {spread}{rate}", flush=True)

    kernels = [{
        "name": "rollout_cost_full_body",
        "route": "cuda",
        "source": SOURCE,
        "replaces": "ccv_mppi_path_tracker_tpu/kernels/rollout_cost.py:1034",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": med["kernel_alone"],
        "plain_ms": med["plain_alone"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
