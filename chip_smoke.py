#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ccv_mppi_path_tracker_tpu_torch only (no JAX) through its main paths:
the MPPI control update of each of the four models through the fused CUDA
kernel at the benchmark's size (K=102400 samples, T=30 horizon, float32),
elite sampling (two-pass and stale-threshold), and the closed loops that
repeat them. Phases, each printed on one line, the first failure ending the
run with a non-zero exit:

  1. build the kernel from csrc/ with nvcc; print the card and its power limit;
  2. kernel vs its plain PyTorch version, injected noise, every model at
     K=102400 T=30 and at K=10000 (masked tail): full_body at T=15 with
     roll_off=False weights, the others at T=30; steer_off for full_body and
     rate_limited_steering;
  3. in-kernel RNG mode: every model vs the plain version on the same (seed,
     step); for full_body also determinism, finiteness, box, and the sample
     mean at lambda=1e30;
  4. elite, full_body and unicycle at K=102400 T=30: the two-pass kernel
     update (costs only, threshold, costs in) vs the plain version's, the
     threshold vs elite_threshold of the plain costs, a stale pass at +inf
     equal to the unmasked update, a stale pass below every cost holding
     the sampling mean;
  5. mppi_step(use_kernel=True, lean=True) vs the eager path, same noise,
     every model and elite; then no host sync inside mppi_step for every
     model, kernel and eager, lean and full, vanilla and both elite modes;
  6. 200-cycle closed loops through run_tracking_experiment on the kernel
     path, the launch count set to 0 just before each and read just after:
     full_body, diff_drive, steering_diff_drive, rate_limited_steering,
     full_body with elite 0.1 (two launches a cycle) and full_body with
     stale elite 0.1; finite states, RMSE < 0.15 m, exact launch counts;
  7. the command line: `run` for each preset on the kernel and the eager
     path, and full_body with --elite-frac 0.1;
  8. CUDA-event timings (median of repetitions after warm-up).

The last three lines are the kernels JSON line, the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}. Without
a CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

import contextlib
import io
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
ELITE = 0.1
REPLACES = "ccv_mppi_path_tracker_tpu/kernels/rollout_cost.py:1034"
# preset -> (model, the model's states after x, y: yaw, then the others)
PRESET_MODELS = {
    "full_body": ("full_body", (0.1, 0.02, -0.03)),
    "diff_drive": ("unicycle", (0.1,)),
    "steering_diff_drive": ("steering_unicycle", (0.1,)),
    "rate_limited_steering": ("rate_limited_steering", (0.1, 0.2)),
}
NEW_PRESETS = ("diff_drive", "steering_diff_drive", "rate_limited_steering")


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

    from ccv_mppi_path_tracker_tpu_torch import cli
    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        SOURCE,
        KernelLaunch,
        fused_sample_rollout_cost,
        fused_sample_rollout_cost_reference,
        pack_scalars,
    )
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import elite_threshold
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
    from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment
    from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    kernel_fn = fused_sample_rollout_cost
    plain_fn = fused_sample_rollout_cost_reference

    # --- 1. build -------------------------------------------------------
    lib_path, build_s, log = build.build("rollout_cost")
    ptxas = [ln.strip() for ln in (log or "").splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[1 build] {lib_path.name} in {build_s:.2f} s; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; ptxas: {' | '.join(ptxas) or 'cached'}",
          flush=True)
    print(f"[1 card] {card}", flush=True)

    def setup(preset, k, t, roll_off=False, seed=0):
        model, rest = PRESET_MODELS[preset]
        kw = {"roll_off": roll_off} if model == "full_body" else {}
        cfg, sp, cp, course = PRESETS[preset](num_samples=k, horizon=t,
                                              device=dev, **kw)
        m = get_model(model)
        path = PathBuffer.from_points(course, 0.1, device=dev)
        rng = np.random.RandomState(seed)
        state = torch.tensor([0.05, course[0, 1] + 0.1, *rest],
                             dtype=torch.float32, device=dev)
        u_prev = torch.tensor(rng.randn(t - 1, m.num_controls) * 0.2,
                              dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        noise = torch.randn((t - 1, k, m.num_controls), generator=gen, device=dev)
        dt = torch.full((), 0.1, device=dev)
        mp = m.default_params(device=dev) if m.default_params else None
        ref = resample_reference(path, state[:2], cp.v_ref, dt, t)

        def scal(thresh=None):
            return pack_scalars(dt, cp, ref.yaw[0], mp, sp.noise_beta, sp.lam,
                                cost_thresh=thresh)

        kargs = (u_prev, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state)
        return dict(cfg=cfg, sp=sp, cp=cp, course=course, path=path, model=model,
                    state=state, u_prev=u_prev, noise=noise, dt=dt, mp=mp,
                    scal=scal, kargs=kargs + (scal(),))

    def u_err(tag, uo_k, uo_r):
        err = float((uo_k - uo_r).abs().max())
        bound = u_bound(uo_r)
        require(bool(torch.isfinite(uo_k).all()), f"{tag}: non-finite kernel u_opt")
        require(err <= bound, f"{tag}: u_opt differs by {err} > {bound}")
        return err, bound

    def compare(tag, kern, plain):
        (ck, uk, nk), (cr, ur, nr) = kern, plain
        torch.cuda.synchronize()
        cost_rel = float(((ck - cr).abs() / cr.abs()).max())
        require(bool(torch.isfinite(ck).all()), f"{tag}: non-finite kernel costs")
        err, bound = u_err(tag, uk / nk, ur / nr)
        print(f"  {tag}: costs max rel err {cost_rel:.3e} (rtol {COST_RTOL}); "
              f"u_opt max abs err {err:.3e} (bound {bound:.3e})", flush=True)
        require(cost_rel <= COST_RTOL, f"{tag}: costs differ by {cost_rel}")
        return err

    max_abs_err = {}

    # --- 2. kernel vs plain version, injected noise ------------------------
    print("[2 noise-input mode] kernel vs plain version", flush=True)
    cases = [("full_body", K_MAIN, T_MAIN, False), ("full_body", K_REF, T_REF, False),
             ("full_body", K_REF, T_REF, True)]
    cases += [(p, k, T_MAIN, False) for p in NEW_PRESETS for k in (K_MAIN, K_REF)]
    # steer_off zeroes channel 2 of any model with U > 2: the steer rate here
    cases.append(("rate_limited_steering", K_REF, T_MAIN, True))
    for preset, k, t, steer_off in cases:
        s = setup(preset, k, t)
        kw = dict(seed=0, step=0, num_samples=k, model=s["model"], noise=s["noise"],
                  steer_off=steer_off)
        err = compare(f"{s['model']} K={k} T={t}{' steer_off' if steer_off else ''}",
                      kernel_fn(*s["kargs"], **kw), plain_fn(*s["kargs"], **kw))
        if k == K_MAIN:
            max_abs_err[s["model"]] = err

    # --- 3. RNG mode ---------------------------------------------------
    print("[3 RNG mode]", flush=True)
    for preset in NEW_PRESETS + ("full_body",):
        s = setup(preset, K_MAIN, T_MAIN)
        kw = dict(seed=123, step=7, num_samples=K_MAIN, model=s["model"])
        a = kernel_fn(*s["kargs"], **kw)
        compare(f"{s['model']} K={K_MAIN} T={T_MAIN} seed=123 step=7", a,
                plain_fn(*s["kargs"], **kw))
    b = kernel_fn(*s["kargs"], **kw)
    c = kernel_fn(*s["kargs"], **dict(kw, seed=124))
    ua, ub, uc = a[1] / a[2], b[1] / b[2], c[1] / c[2]
    sp = s["sp"]
    same = bool(torch.equal(ua, ub) and torch.equal(a[0], b[0]))
    differs = bool((ua - uc).abs().max() > 1e-7)
    finite = bool(torch.isfinite(ua).all())
    in_box = bool((ua <= sp.u_max + 1e-6).all() and (ua >= sp.u_min - 1e-6).all())
    print(f"  full_body: same (seed, step) bit-identical {same}; other seed "
          f"differs {differs}; finite {finite}; inside box {in_box}", flush=True)
    require(same and differs and finite and in_box, "RNG-mode determinism/box")
    # lambda = 1e30: every weight is 1, u_opt is the mean of the clamped draws
    sigma = 0.5
    box = torch.ones(5, device=dev)
    scal = s["kargs"][6].clone()
    scal[16] = 1e30
    zeros = torch.zeros_like(s["u_prev"])
    _, un, nm = kernel_fn(
        zeros, torch.full((5,), sigma, device=dev), -box, box, s["kargs"][4],
        s["state"], scal, seed=99, step=1, num_samples=K_MAIN, model="full_body")
    mean_max = float((un / nm).abs().max())
    lim = 5 * sigma / K_MAIN ** 0.5
    print(f"  lambda=1e30 sample mean: max |u_opt| {mean_max:.3e} < {lim:.3e}; "
          f"norm {float(nm):.1f} (K={K_MAIN})", flush=True)
    require(mean_max < lim, "RNG-mode sample mean off zero")

    # --- 4. elite passes ---------------------------------------------------
    print(f"[4 elite] elite_frac={ELITE}, K={K_MAIN} T={T_MAIN}, RNG mode", flush=True)
    for preset in ("full_body", "diff_drive"):
        s = setup(preset, K_MAIN, T_MAIN, seed=4)
        model = s["model"]
        kw = dict(seed=5, step=6, num_samples=K_MAIN, model=model)
        costs, u_none, _ = kernel_fn(*s["kargs"], accumulate=False, **kw)
        require(u_none is None, "costs-only pass returned an update")
        thresh = elite_threshold(costs, ELITE)
        _, un, nm = kernel_fn(*s["kargs"][:6], s["scal"](thresh), costs_in=costs, **kw)
        pcosts = plain_fn(*s["kargs"], accumulate=False, **kw)[0]
        pthresh = elite_threshold(pcosts, ELITE)
        _, pun, pnm = plain_fn(*s["kargs"][:6], s["scal"](pthresh), **kw)
        torch.cuda.synchronize()
        err, bound = u_err(f"{model} two-pass elite", un / nm, pun / pnm)
        th_rel = float(((thresh - pthresh) / pthresh).abs())
        require(th_rel <= COST_RTOL, f"{model} elite threshold differs by {th_rel}")
        max_abs_err[f"{model}_elite"] = err
        # one pass masked at a given threshold (the stale mode's kernel call)
        _, sun, snm = kernel_fn(*s["kargs"][:6], s["scal"](thresh), **kw)
        _, psun, psnm = plain_fn(*s["kargs"][:6], s["scal"](thresh), **kw)
        torch.cuda.synchronize()
        max_abs_err[f"{model}_stale"], _ = u_err(f"{model} threshold pass",
                                                 sun / snm, psun / psnm)
        # stale: +inf equals the unmasked update; below every cost holds u_mean
        ctrl = ControllerState(u_prev=s["u_prev"], seed=5, step=6)
        args = (s["cfg"], ctrl, s["state"], s["path"], s["dt"], s["sp"], s["cp"])
        inf = torch.full((), float("inf"), device=dev)
        low = torch.full((), -1.0, device=dev)
        _, vanilla = mppi_step(*args, use_kernel=True, lean=True)
        _, at_inf = mppi_step(*args, use_kernel=True, lean=True, elite_frac=ELITE,
                              elite_stale_thresh=inf)
        _, empty = mppi_step(*args, use_kernel=True, elite_frac=ELITE,
                             elite_stale_thresh=low)
        inf_same = bool(torch.equal(at_inf.u_opt, vanilla.u_opt))
        held = bool(torch.equal(empty.u_opt, s["u_prev"]))
        flagged = bool(empty.stats["elite_stale_empty"])
        print(f"  {model}: two-pass u_opt max abs err {err:.3e} (bound {bound:.3e}); "
              f"threshold pass {max_abs_err[f'{model}_stale']:.3e}; "
              f"threshold {float(thresh):.6f} vs plain {float(pthresh):.6f} "
              f"(rel {th_rel:.2e}); stale +inf == unmasked {inf_same}; stale below "
              f"min holds u_mean {held}, elite_stale_empty {flagged}", flush=True)
        require(inf_same and held and flagged, f"{model} stale elite")

    # --- 5. mppi_step kernel-lean vs eager-lean, and no host sync ----------
    print(f"[5 mppi_step] kernel-lean vs eager-lean K={K_MAIN} T={T_MAIN}", flush=True)
    step_cases = {}
    for preset in PRESET_MODELS:
        s = setup(preset, K_MAIN, T_MAIN, seed=3)
        ctrl = ControllerState(u_prev=s["u_prev"], seed=0, step=0)
        step_args = (s["cfg"], ctrl, s["state"], s["path"], s["dt"], s["sp"], s["cp"])
        step_cases[preset] = step_args
        for opts in ({}, {"elite_frac": ELITE}):
            _, rk = mppi_step(*step_args, model_params=s["mp"], noise=s["noise"],
                              use_kernel=True, lean=True, **opts)
            _, re = mppi_step(*step_args, model_params=s["mp"], noise=s["noise"],
                              use_kernel=False, lean=True, **opts)
            err, bound = u_err(f"{s['model']} {opts}", rk.u_opt, re.u_opt)
            print(f"  {s['model']} {opts or 'vanilla'}: u_opt max abs err {err:.3e} "
                  f"(bound {bound:.3e})", flush=True)
    stale = torch.full((), 50.0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync now raises
    try:
        for step_args in step_cases.values():
            for use_kernel in (True, False):
                for lean in (True, False):
                    for opts in ({}, {"elite_frac": ELITE},
                                 {"elite_frac": ELITE, "elite_stale_thresh": stale}):
                        mppi_step(*step_args, use_kernel=use_kernel, lean=lean, **opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  no host sync inside mppi_step (every model; kernel and eager, lean "
          "and full, vanilla, two-pass and stale elite; RNG mode)", flush=True)

    # --- 6. closed loops through the user entry point ----------------------
    loops = [("full_body", {}, 1), ("diff_drive", {}, 1),
             ("steering_diff_drive", {}, 1), ("rate_limited_steering", {}, 1),
             ("full_body", {"elite_frac": ELITE}, 2),
             ("full_body", {"elite_frac": ELITE, "elite_stale": True}, 1)]
    launches, loop_rate = {}, {}
    for preset, opts, per_cycle in loops:
        cfg, sp, cp, course = PRESETS[preset](num_samples=K_MAIN, horizon=T_MAIN,
                                              device=dev)
        fused_sample_rollout_cost.launches = 0
        t0 = time.perf_counter()
        out = run_tracking_experiment(cfg, sp, cp, course, num_steps=STEPS, dt=0.1,
                                      use_kernel=True, solver_options=opts or None)
        wall = time.perf_counter() - t0
        n = fused_sample_rollout_cost.launches
        name = cfg.model + ("_elite_stale" if opts.get("elite_stale")
                            else "_elite" if opts else "")
        launches[name] = n
        loop_rate[name] = STEPS / wall
        m = out["metrics"]
        finite = bool(np.isfinite(out["logs"]["state"]).all())
        print(f"[6 closed loop] {preset} {opts or ''} {STEPS} cycles K={K_MAIN} "
              f"T={T_MAIN}: RMSE {m['rmse']:.4f} m, max error {m['max_error']:.4f} m, "
              f"finite {finite}, kernel launches {n}; wall {wall:.3f} s = "
              f"{STEPS / wall:.1f} cycles/s (host clock) on {card}", flush=True)
        require(finite, f"{name} closed-loop states not finite")
        require(m["rmse"] < 0.15, f"{name} closed-loop RMSE {m['rmse']} >= 0.15")
        require(n == per_cycle * STEPS,
                f"{name}: kernel launched {n} times, not {per_cycle * STEPS}")

    # --- 7. the command line -------------------------------------------
    runs = [[p] + extra for p in ("diff_drive", "steering_diff_drive", "full_body")
            for extra in ([], ["--no-kernel"])]
    runs.append(["full_body", "--elite-frac", str(ELITE)])
    for p, *extra in runs:
        argv = ["run", "--preset", p, "--steps", str(STEPS), "--num-samples",
                str(K_MAIN), "--horizon", str(T_MAIN), *extra]
        fused_sample_rollout_cost.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        lines = buf.getvalue().splitlines()
        n = fused_sample_rollout_cost.launches
        expect = 0 if "--no-kernel" in extra else STEPS * (2 if "--elite-frac" in extra else 1)
        rmse = float(lines[-1].split(": ")[1])
        print(f"[7 cli] {' '.join(argv)}: rc {rc}, {lines[0]}, {lines[-1]}, "
              f"kernel launches {n}", flush=True)
        require(rc == 0 and rmse < 0.15 and n == expect, f"cli {' '.join(argv)}")

    # --- 8. timing --------------------------------------------------------
    def event_ms(fn, inner):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner

    def updater(s, kind, **opts):
        carry = [ControllerState(s["u_prev"], 0, 0)]

        def fn():
            carry[0], _ = mppi_step(
                s["cfg"], carry[0], s["state"], s["path"], s["dt"], s["sp"], s["cp"],
                model_params=s["mp"], use_kernel=kind == "kernel", lean=True, **opts)
        return fn

    arms = {}
    kw = dict(seed=1, step=2, num_samples=K_MAIN)
    for preset in ("full_body",) + NEW_PRESETS:
        s = setup(preset, K_MAIN, T_MAIN, roll_off=True, seed=5)
        model, mkw = s["model"], dict(kw, model=s["model"])
        # kernel_alone: launches of prepared operands only (the host enqueues
        # faster than the card runs them, so the events time the device)
        launch = KernelLaunch(*s["kargs"], **mkw)
        arms[f"{model}/update_kernel_lean"] = (updater(s, "kernel"), 20)
        arms[f"{model}/update_eager_lean"] = (updater(s, "eager"), 5)
        arms[f"{model}/kernel_alone"] = (launch.run, 50)
        arms[f"{model}/plain_alone"] = (lambda s=s, mkw=mkw: plain_fn(*s["kargs"], **mkw), 3)
        if preset == "full_body":
            arms[f"{model}/kernel_wrapper"] = (
                lambda s=s, mkw=mkw: kernel_fn(*s["kargs"], **mkw), 20)
        if preset in ("full_body", "diff_drive"):
            costs = kernel_fn(*s["kargs"], accumulate=False, **mkw)[0]
            thresh = elite_threshold(costs, ELITE)
            pass1 = KernelLaunch(*s["kargs"], accumulate=False, **mkw)
            pass2 = KernelLaunch(*s["kargs"][:6], s["scal"](thresh), costs_in=costs,
                                 **mkw)
            stale1 = KernelLaunch(*s["kargs"][:6], s["scal"](thresh), **mkw)

            def plain_elite(s=s, mkw=mkw):
                c = plain_fn(*s["kargs"], accumulate=False, **mkw)[0]
                th = elite_threshold(c, ELITE)
                plain_fn(*s["kargs"][:6], s["scal"](th), costs_in=c, **mkw)

            arms[f"{model}/update_kernel_lean_elite"] = (
                updater(s, "kernel", elite_frac=ELITE), 20)
            arms[f"{model}/update_eager_lean_elite"] = (
                updater(s, "eager", elite_frac=ELITE), 5)
            arms[f"{model}/elite_pass1_alone"] = (pass1.run, 50)
            arms[f"{model}/elite_pass2_alone"] = (pass2.run, 50)
            arms[f"{model}/elite_select"] = (lambda c=costs: elite_threshold(c, ELITE), 50)
            arms[f"{model}/elite_plain"] = (plain_elite, 3)
            arms[f"{model}/stale_kernel_alone"] = (stale1.run, 50)
            arms[f"{model}/stale_plain"] = (
                lambda s=s, mkw=mkw, th=thresh: plain_fn(*s["kargs"][:6], s["scal"](th),
                                                         **mkw), 3)
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
    print(f"[8 timing] K={K_MAIN} T={T_MAIN}, median of {reps} CUDA-event reps, "
          f"on {card} (after: sm clock, draw, limit, temp = {clocks})", flush=True)
    for name, ms in med.items():
        rate = (f"; {props / (ms * 1e-3):.4e} propagations/s"
                if "/update" in name else "")
        spread = f"[{min(times[name]):.4f}, {max(times[name]):.4f}]"
        print(f"  {name}: {ms:.4f} ms {spread}{rate}", flush=True)

    def entry(name, path_key, err_key, ms, plain_ms):
        n = launches[path_key]
        require(n > 0, f"{name}: no launch in its main path's run")
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                "launches": n, "max_abs_err": max_abs_err[err_key], "ms": ms,
                "plain_ms": plain_ms}

    kernels = [
        entry(f"rollout_cost_{m}", m, m, med[f"{m}/kernel_alone"],
              med[f"{m}/plain_alone"])
        for m in ("full_body", "unicycle", "steering_unicycle", "rate_limited_steering")
    ]
    kernels.append(entry(
        "rollout_cost_full_body_elite_two_pass", "full_body_elite", "full_body_elite",
        med["full_body/elite_pass1_alone"] + med["full_body/elite_pass2_alone"],
        med["full_body/elite_plain"]))
    kernels.append(entry(
        "rollout_cost_full_body_cost_threshold", "full_body_elite_stale",
        "full_body_stale",
        med["full_body/stale_kernel_alone"], med["full_body/stale_plain"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
