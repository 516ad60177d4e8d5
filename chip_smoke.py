#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ccv_mppi_path_tracker_tpu_torch only (no JAX) through its main paths:
the MPPI control update of each of the four models through the fused CUDA
kernel at the benchmark's size (K=102400 samples, T=30 horizon, float32),
elite sampling (two-pass and stale-threshold), adaptive sigma through
ControlLoop, the fleet (B=256 robots in one launch), the closed loops that
repeat them, the live-robot serving path (the paced and pipelined loops,
the sensing and estimation stack, checkpoint/resume), and the differentiable
side (refinement after the kernel, system identification, the learned
sampler and update rule). Phases, each printed on one line, the first
failure ending the run with a non-zero exit:

  1. build the kernel from csrc/ with nvcc; print the card and its power limit,
     each instantiation's ptxas registers (held equal to the launch-shape
     model's table), spills and stack, and the launch shape's occupancy
     model, held equal to the CUDA occupancy calculator's;
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
  6. 200-cycle lean closed loops (run_tracking_experiment's loop through
     simulate(with_stats=False)) on the kernel path, the launch count set to
     0 just before each and read just after:
     full_body, diff_drive, steering_diff_drive, rate_limited_steering,
     full_body with elite 0.1 (two launches a cycle) and full_body with
     stale elite 0.1; finite states, RMSE < 0.15 m, exact launch counts;
  7. the command line: `run` for each preset on the kernel and the eager
     path, and full_body with --elite-frac 0.1;
  8. CUDA-event timings (median of repetitions after warm-up);
  9. second moment (adaptive sigma), every model at K=102400 T=30 and at
     K=10000: the kernel vs its plain version in noise-input and RNG mode,
     and in the two-pass and stale elite flows; u2_num/norm under the
     u_opt bound's form, sigma_suggest at the JAX tests' rtol 2e-4 atol 1e-6;
 10. mppi_step(adapt_sigma=True) kernel-lean vs eager-lean, same noise,
     every model (phase 5's no-host-sync sweep also runs adapt_sigma and the
     fleet step's kernel arm);
 11. ControlLoop(sigma_adapt=0.2), 200 cycles at K=102400 T=30 on the kernel
     path with the plant fed back: full_body, diff_drive, full_body with
     elite 0.1 (two launches a cycle), diff_drive with stale elite and a
     set_path swap at cycle 100; RMSE < 0.15 m, sigma inside its bounds and
     moved from sigma0, exact launch counts;
 12. the fleet kernel at B=256 K=1024 T=15 (scripts/bench_suite.py's fleet
     shape): every model vs the plain version in noise and RNG mode, robot
     b of the launch bit-equal to a single launch of robot b, and one robot's
     costs offset by 1e3 (each robot's own baseline);
 13. fleet closed loops, 200 ticks of build_fleet_step(use_kernel=True) at
     B=256 K=1024 T=15, diff_drive and full_body, robots fanned +-0.4 m:
     every robot within 0.3 m of the course, exactly 200 launches;
 14. the `fleet` command, 64 robots, 200 ticks, kernel and eager arm;
 15. CUDA-event timings of the new modes: the second-moment kernel vs the
     vanilla one, the fleet kernel, the fleet tick on both arms;
 16. the kernel's two forms and its finish: the regenerate form (where the
     launch shape picks it, full_body at T=400, and forced at each model's
     flagship) and the store form's costs-in pass (forced) vs the plain
     version; the kernel's own finish vs the plain finish
     (kernels/rollout_cost.py finish_reference) on the partial rows of the
     same launch, every model, with the second moment, and the fleet;
 17. torch.profiler over 20 kernel-lean updates (full_body and unicycle,
     vanilla and elite): device launches per update and the device's busy
     share;
 18. the entry points called with no device (presets, config builders,
     PathBuffer.from_points, ControllerState.initial, MPPISolver.init,
     init_fleet, default_params, load_checkpoint) give cuda tensors;
     command_from_solution on the card bit-equal to its CPU run (NaN where
     NaN) for every model, w=0, v=w=0, the roll clamp, roll_off, steer_off;
     no host sync in it nor in steering_mode;
 19. the paced loop, run_realtime_experiment through the kernel at K=102400
     T=30: full_body at 10 Hz for 50 cycles (RMSE < 0.15 m), diff_drive at
     50 Hz for 100 cycles with the native recorder (101 CSV lines); rate
     stats, stale cycles, launches (the cycles + the warm-up) and host syncs
     (one a cycle) exact; then full_body unpaced at 1000 Hz: the cycle's own
     time, and its device launches by torch.profiler;
 20. the pipelined loop, diff_drive at K=102400 T=30, 50 Hz, 96 cycles:
     micro_batch 1, and 8 with and without delay compensation (compensated
     RMSE below uncompensated); fetch ms, miss rate, launches (the cycles +
     the warm-up window) exact;
 21. run_full_stack_experiment at K=102400 T=30, 80 cycles, roll_off True and
     False (the ZMP cost lowers the peak lateral ZMP; RMSE < 0.15 m); resume
     on the kernel path in RNG mode (200 cycles against 100 + checkpoint +
     100, u0 bit-equal); the serving commands: realtime, realtime
     --pipelined --micro-batch 4, compare, course --kind dkan, run --record
     --course dkan --save-ckpt, run --resume-ckpt;
 22. refinement after the kernel, full_body and diff_drive at K=102400 T=30:
     the refine stage of mppi_step (both methods) on the card against the CPU
     on the kernel's update (float64 rtol 1e-8; float32 printed only: a
     Levenberg-Marquardt accept can flip on round-off), the Gauss-Newton
     refined trajectory cost at most the unrefined one, no host sync in
     mppi_step(refine_steps=3) (both methods, kernel and eager, lean and
     full); a 200-cycle Gauss-Newton-refined full_body run_tracking_experiment
     (RMSE < 0.15 m, exactly 200 launches, finite ess logged); CUDA-event
     times and profiled device launches of the kernel-lean update with and
     without each refinement, the Gauss-Newton one under the 100 ms period;
 23. the training side on the card at the JAX package's script sizes: the
     sysid command (gains within rtol 1e-3), fit_full_body_params (base2com
     within 2 %), the chunked rollout gradient (num_chunks 1, 4, 8 equal at
     float64), collect_imitation_data + fit_sampler (the loss halves, the
     proposal wins 5 of 6 cold starts), meta_train (the loss falls, the rule
     beats vanilla on held-out poses); the wall time of each.

After every phase that launches the kernel, the finish's ticket counters are
back at 0.

Phases 19-21 end with a JSON line of the serving runs' numbers
({"serving": ...}), phases 22-23 with one of theirs ({"refine": ...,
"training": ...}). The last three lines are the kernels JSON line (each entry with its bound:
kernels/rollout_cost.py rollout_cost_bound_ms, and its launches per update:
the main-path run's count over its cycles), the card's name and power limit
as nvidia-smi prints them, and {"ok": true, "device": {...}}. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

import contextlib
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

K_MAIN, T_MAIN = 102_400, 30   # bench.py's flagship control update
K_REF, T_REF = 10_000, 15      # full_body_launch defaults (reference node)
B_FLEET, K_FLEET, T_FLEET = 256, 1024, 15  # scripts/bench_suite.py's fleet shape
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


def event_ms(fn, inner):
    """Milliseconds per call of fn: CUDA events around `inner` calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def time_interleaved(arms, reps, warm=2):
    """{name: [ms per call] * reps} of arms {name: (fn, inner)}: `warm` calls
    of each, then `reps` rounds of event_ms over every arm, the order
    alternating between rounds."""
    import torch

    for fn, _ in arms.values():
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in arms}
    for r in range(reps):
        for name in (list(arms) if r % 2 == 0 else list(reversed(arms))):
            fn, inner = arms[name]
            times[name].append(event_ms(fn, inner))
    return times


def kernel_case(preset, k, t, robots=None, roll_off=False, seed=0, device="cuda:0"):
    """The fused kernel's operands for one preset at K=k, T=t, made from
    `seed`: one robot just off the course start, or `robots` robots
    scattered along its first 8 m. A dict of the preset's cfg, sp, cp,
    course and path, the model name, state, u_prev, noise (standard
    normals, (..., T-1, K, U)), dt, mp, scal (thresh -> the scalar vector
    with that elite threshold) and kargs (the kernel's seven leading
    arguments). scripts/torch_kernel_ab.py uses it too."""
    import numpy as np
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import pack_scalars
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths import (
        PathBuffer,
        resample_reference,
        resample_references,
    )

    dev = torch.device(device)
    model, rest = PRESET_MODELS[preset]
    kw = {"roll_off": roll_off} if model == "full_body" else {}
    cfg, sp, cp, course = PRESETS[preset](num_samples=k, horizon=t, device=dev, **kw)
    m = get_model(model)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    rng = np.random.RandomState(seed)
    dt = torch.full((), 0.1, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if robots is None:
        state = torch.tensor([0.05, course[0, 1] + 0.1, *rest], dtype=torch.float32,
                             device=dev)
        u_prev = torch.tensor(rng.randn(t - 1, m.num_controls) * 0.2,
                              dtype=torch.float32, device=dev)
        noise = torch.randn((t - 1, k, m.num_controls), generator=gen, device=dev)
        ref = resample_reference(path, state[:2], cp.v_ref, dt, t)
        yaw0 = ref.yaw[0]
    else:
        st = np.zeros((robots, m.num_states))
        st[:, 0] = rng.uniform(0.0, 8.0, robots)
        st[:, 1] = np.interp(st[:, 0], course[:, 0], course[:, 1]) + 0.3 * rng.randn(robots)
        st[:, 2:] = np.asarray(rest) + 0.05 * rng.randn(robots, len(rest))
        state = torch.tensor(st, dtype=torch.float32, device=dev)
        u_prev = torch.tensor(rng.randn(robots, t - 1, m.num_controls) * 0.2,
                              dtype=torch.float32, device=dev)
        noise = torch.randn((robots, t - 1, k, m.num_controls), generator=gen,
                            device=dev)
        ref = resample_references(path, state[:, :2], cp.v_ref, dt, t)
        yaw0 = ref.yaw[:, 0]
    mp = m.default_params(device=dev) if m.default_params else None

    def scal(thresh=None):
        return pack_scalars(dt, cp, yaw0, mp, sp.noise_beta, sp.lam, cost_thresh=thresh)

    kargs = (u_prev, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state, scal())
    return dict(cfg=cfg, sp=sp, cp=cp, course=course, path=path, model=model,
                state=state, u_prev=u_prev, noise=noise, dt=dt, mp=mp, scal=scal,
                kargs=kargs)


SIGMA_RTOL, SIGMA_ATOL = 2e-4, 1e-6  # tests/test_solver_options.py:137-139
# the kernel's finish vs the plain finish on the same partial rows: float32
# sums of up to a few thousand rows in another order, and the two-level
# rescaling exp(a)*exp(b) for exp(a+b)
FINISH_RTOL = 1e-5


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
    from ccv_mppi_path_tracker_tpu_torch.kernels import rollout_cost as kernel_mod
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        KERNEL_MODELS,
        REGISTERS,
        SOURCE,
        KernelLaunch,
        finish_reference,
        fused_sample_rollout_cost,
        fused_sample_rollout_cost_reference,
        instantiations,
        launch_shape,
        rollout_cost_bound_ms,
    )
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import elite_threshold
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime import (
        ControlLoop,
        run_tracking_experiment,
        simulate,
    )
    from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, init_fleet, mppi_step
    from ccv_mppi_path_tracker_tpu_torch.solver.mppi import _refine, _sigma_suggest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    kernel_fn = fused_sample_rollout_cost
    plain_fn = fused_sample_rollout_cost_reference

    # --- 1. build -------------------------------------------------------
    lib_path, build_s, log = build.build("rollout_cost")
    print(f"[1 build] {lib_path.name} in {build_s:.2f} s; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(f"[1 card] {card}", flush=True)
    ptxas = instantiations(build.ptxas_summary(log or ""))
    for (model, m2, form), p in sorted(ptxas.items()):
        print(f"  ptxas {model} second_moment={int(m2)} {form}: {p['registers']} "
              f"registers, {p['spill_stores']} B spill stores, {p['spill_loads']} B "
              f"spill loads, {p['stack']} B stack, {p['smem']} B static smem", flush=True)
    require(not log or len(ptxas) == 4 * 2 * 2, "not every instantiation was built")
    # the chooser's register table is what ptxas gave (a fresh build only:
    # a reused library leaves no report)
    for (model, m2, form), p in ptxas.items():
        require(p["registers"] == REGISTERS[model, form],
                f"ptxas gave {model} second_moment={int(m2)} {form} {p['registers']} "
                f"registers, the launch-shape model assumes {REGISTERS[model, form]}")
    lib = build.load_library("rollout_cost")
    kernel_mod._bind(lib)
    for model in KERNEL_MODELS:
        for k, t, m2, opts in ((K_MAIN, T_MAIN, False, {}), (K_MAIN, T_MAIN, True, {}),
                               (K_MAIN, T_MAIN, False, {"accumulate": False}),
                               (K_MAIN, T_MAIN, False, {"costs_in": True}),
                               (K_FLEET, T_FLEET, False, {}), (K_REF, 400, False, {})):
            if model != "full_body" and t == 400:
                continue
            sh = launch_shape(model, k, t, t, m2, **opts)
            cuda_bps = lib.rollout_cost_blocks_per_sm(KERNEL_MODELS.index(model),
                                                      sh.form == "store", m2,
                                                      sh.threads, sh.smem)
            print(f"  launch shape {model} K={k} T={t} second_moment={int(m2)} "
                  f"{opts or ''}: {sh.form}, {sh.threads} threads, {sh.blocks} blocks, "
                  f"{sh.smem} B shared; blocks per SM {sh.blocks_per_sm} by the model "
                  f"at {REGISTERS[model, sh.form]} registers, {cuda_bps} by the CUDA "
                  f"occupancy calculator", flush=True)
            require(cuda_bps == sh.blocks_per_sm,
                    f"{model} K={k} T={t} {opts}: the occupancy model says "
                    f"{sh.blocks_per_sm} blocks per SM, the CUDA calculator {cuda_bps}")

    def counters_zero(tag):
        """Every ticket counter of the in-kernel finish is back at 0."""
        torch.cuda.synchronize()
        bad = [key for key, buf in kernel_mod._COUNTERS.items() if bool((buf != 0).any())]
        require(not bad, f"{tag}: finish counters not reset: {bad}")

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
        counters_zero(tag)
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
        s = kernel_case(preset, k, t)
        kw = dict(seed=0, step=0, num_samples=k, model=s["model"], noise=s["noise"],
                  steer_off=steer_off)
        err = compare(f"{s['model']} K={k} T={t}{' steer_off' if steer_off else ''}",
                      kernel_fn(*s["kargs"], **kw), plain_fn(*s["kargs"], **kw))
        if k == K_MAIN:
            max_abs_err[s["model"]] = err

    # --- 3. RNG mode ---------------------------------------------------
    print("[3 RNG mode]", flush=True)
    for preset in NEW_PRESETS + ("full_body",):
        s = kernel_case(preset, K_MAIN, T_MAIN)
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
        s = kernel_case(preset, K_MAIN, T_MAIN, seed=4)
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
        counters_zero(f"{model} elite")

    # --- 5. mppi_step kernel-lean vs eager-lean, and no host sync ----------
    print(f"[5 mppi_step] kernel-lean vs eager-lean K={K_MAIN} T={T_MAIN}", flush=True)
    step_cases = {}
    for preset in PRESET_MODELS:
        s = kernel_case(preset, K_MAIN, T_MAIN, seed=3)
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

    def fan(course, num_robots, s_dim):
        """num_robots start states on the course start, fanned +-0.4 m in y."""
        st = torch.zeros((num_robots, s_dim), device=dev)
        st[:, 1] = float(course[0, 1]) + torch.linspace(-0.4, 0.4, num_robots, device=dev)
        return st

    fcfg, fsp, fcp, fcourse = PRESETS["diff_drive"](num_samples=K_FLEET, horizon=T_FLEET,
                                                    device=dev)
    fleet_args = (init_fleet(fcfg, B_FLEET, device=dev), fan(fcourse, B_FLEET, 3),
                  PathBuffer.from_points(fcourse, 0.1, device=dev),
                  torch.full((), 0.1, device=dev), fsp, fcp)
    fleet_kernel_step = build_fleet_step(fcfg, use_kernel=True)
    fleet_kernel_step(*fleet_args)  # warm-up outside the sync check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync now raises
    try:
        for step_args in step_cases.values():
            for use_kernel in (True, False):
                for lean in (True, False):
                    for opts in ({}, {"elite_frac": ELITE},
                                 {"elite_frac": ELITE, "elite_stale_thresh": stale}):
                        for adapt in (False, True):
                            mppi_step(*step_args, use_kernel=use_kernel, lean=lean,
                                      adapt_sigma=adapt, **opts)
        fleet_kernel_step(*fleet_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  no host sync inside mppi_step (every model; kernel and eager, lean "
          "and full, vanilla, two-pass and stale elite, each with and without "
          "adapt_sigma; RNG mode) nor in the fleet step's kernel arm "
          f"(B={B_FLEET} K={K_FLEET} T={T_FLEET})", flush=True)

    # --- 6. the lean closed loops -----------------------------------------
    def lean_loop(cfg, sp, cp, course, opts):
        """run_tracking_experiment's loop on the lean step (simulate with
        with_stats=False), from the course start; (logs, metrics)."""
        m = get_model(cfg.model)
        start = np.zeros(m.num_states)
        start[:2] = course[0]
        start[2] = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
        _, logs = simulate(
            cfg, ControllerState.initial(0, cfg.horizon, m.num_controls, device=dev),
            torch.tensor(start, dtype=torch.float32, device=dev),
            PathBuffer.from_points(course, 0.1, device=dev), torch.full((), 0.1, device=dev),
            sp, cp, num_steps=STEPS, use_kernel=True, solver_options=opts or None,
            with_stats=False)
        states = logs["state"].cpu().numpy()
        xy = np.concatenate([start[None, :2], states[:, :2]])
        return {"state": states}, tracking_metrics(xy, course, dt=0.1)

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
        logs, m = lean_loop(cfg, sp, cp, course, opts)
        wall = time.perf_counter() - t0
        n = fused_sample_rollout_cost.launches
        name = cfg.model + ("_elite_stale" if opts.get("elite_stale")
                            else "_elite" if opts else "")
        launches[name] = n
        loop_rate[name] = STEPS / wall
        finite = bool(np.isfinite(logs["state"]).all())
        print(f"[6 closed loop] {preset} {opts or ''} {STEPS} cycles K={K_MAIN} "
              f"T={T_MAIN}: RMSE {m['rmse']:.4f} m, max error {m['max_error']:.4f} m, "
              f"finite {finite}, kernel launches {n}; wall {wall:.3f} s = "
              f"{STEPS / wall:.1f} cycles/s (host clock) on {card}", flush=True)
        require(finite, f"{name} closed-loop states not finite")
        require(m["rmse"] < 0.15, f"{name} closed-loop RMSE {m['rmse']} >= 0.15")
        require(n == per_cycle * STEPS,
                f"{name}: kernel launched {n} times, not {per_cycle * STEPS}")
        counters_zero(name)

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
        counters_zero(f"cli {' '.join(argv)}")

    # --- 8. timing --------------------------------------------------------
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
        s = kernel_case(preset, K_MAIN, T_MAIN, roll_off=True, seed=5)
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
    reps = 7
    times = time_interleaved(arms, reps)
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
    counters_zero("timing")

    # --- 9. second moment (adaptive sigma) ------------------------------
    def m2_check(tag, kern, plain):
        """u_opt under the u_opt bound, u2_num/norm under the same form, and
        sigma_suggest at the JAX tests' tolerance; returns the larger of the
        two absolute errors."""
        (_, uk, nk, u2k), (_, ur, nr, u2r) = kern, plain
        torch.cuda.synchronize()
        err_u, bound_u = u_err(tag, uk / nk, ur / nr)
        err_2, bound_2 = u_err(f"{tag} u2_num/norm", u2k / nk, u2r / nr)
        sk = _sigma_suggest(u2k / nk, uk / nk)
        sr = _sigma_suggest(u2r / nr, ur / nr)
        excess = float(((sk - sr).abs() - (SIGMA_ATOL + SIGMA_RTOL * sr.abs())).max())
        rel = float(((sk - sr).abs() / sr.abs()).max())
        print(f"  {tag}: u_opt max abs err {err_u:.3e} (bound {bound_u:.3e}); "
              f"u2_num/norm {err_2:.3e} (bound {bound_2:.3e}); sigma_suggest max rel "
              f"err {rel:.3e} (rtol {SIGMA_RTOL}, atol {SIGMA_ATOL})", flush=True)
        require(excess <= 0.0, f"{tag}: sigma_suggest differs beyond rtol/atol")
        counters_zero(tag)
        return max(err_u, err_2)

    print(f"[9 second moment] kernel vs plain version, T={T_MAIN}", flush=True)
    for preset in PRESET_MODELS:
        for k in (K_MAIN, K_REF):
            s = kernel_case(preset, k, T_MAIN, seed=6)
            model = s["model"]
            kw = dict(num_samples=k, model=model, second_moment=True)
            nkw = dict(kw, seed=0, step=0, noise=s["noise"])
            rkw = dict(kw, seed=7, step=8)
            m2_check(f"{model} K={k} noise", kernel_fn(*s["kargs"], **nkw),
                     plain_fn(*s["kargs"], **nkw))
            err = m2_check(f"{model} K={k} RNG", kernel_fn(*s["kargs"], **rkw),
                           plain_fn(*s["kargs"], **rkw))
            if k != K_MAIN:
                continue
            max_abs_err[f"{model}_m2"] = err
            # two-pass elite: costs only, threshold, costs in with u^2
            costs = kernel_fn(*s["kargs"], accumulate=False, **rkw)[0]
            thresh = elite_threshold(costs, ELITE)
            pthresh = elite_threshold(plain_fn(*s["kargs"], accumulate=False, **rkw)[0],
                                      ELITE)
            max_abs_err[f"{model}_m2_elite"] = m2_check(
                f"{model} K={k} two-pass elite",
                kernel_fn(*s["kargs"][:6], s["scal"](thresh), costs_in=costs, **rkw),
                plain_fn(*s["kargs"][:6], s["scal"](pthresh), **rkw))
            # stale elite: one pass masked at a given threshold
            max_abs_err[f"{model}_m2_stale"] = m2_check(
                f"{model} K={k} threshold pass",
                kernel_fn(*s["kargs"][:6], s["scal"](thresh), **rkw),
                plain_fn(*s["kargs"][:6], s["scal"](thresh), **rkw))

    # --- 10. mppi_step(adapt_sigma=True), kernel-lean vs eager-lean ---------
    print(f"[10 adapt_sigma] kernel-lean vs eager-lean K={K_MAIN} T={T_MAIN}", flush=True)
    for preset in PRESET_MODELS:
        s = kernel_case(preset, K_MAIN, T_MAIN, seed=3)
        ctrl = ControllerState(u_prev=s["u_prev"], seed=0, step=0)
        step_args = (s["cfg"], ctrl, s["state"], s["path"], s["dt"], s["sp"], s["cp"])
        for opts in ({}, {"elite_frac": ELITE}):
            kw = dict(model_params=s["mp"], noise=s["noise"], lean=True, adapt_sigma=True,
                      **opts)
            _, rk = mppi_step(*step_args, use_kernel=True, **kw)
            _, re = mppi_step(*step_args, use_kernel=False, **kw)
            err, bound = u_err(f"{s['model']} adapt_sigma {opts}", rk.u_opt, re.u_opt)
            sk, se = rk.stats["sigma_suggest"], re.stats["sigma_suggest"]
            rel = float(((sk - se).abs() / se.abs()).max())
            print(f"  {s['model']} {opts or 'vanilla'}: u_opt max abs err {err:.3e} "
                  f"(bound {bound:.3e}); sigma_suggest max rel err {rel:.3e}; lean "
                  f"stats {sorted(rk.stats)}", flush=True)
            require(bool(((sk - se).abs() <= SIGMA_ATOL + SIGMA_RTOL * se.abs()).all()),
                    f"{s['model']} adapt_sigma {opts}: sigma_suggest differs")

    # --- 11. ControlLoop with adaptive sigma ------------------------------
    controls = [("full_body", {}, 1, False), ("diff_drive", {}, 1, False),
                ("full_body", {"elite_frac": ELITE}, 2, False),
                ("diff_drive", {"elite_frac": ELITE, "elite_stale": True}, 1, True)]
    for preset, opts, per_cycle, swap in controls:
        cfg, sp, cp, course = PRESETS[preset](num_samples=K_MAIN, horizon=T_MAIN,
                                              device=dev)
        m = get_model(cfg.model)
        loop = ControlLoop(cfg=cfg, sp=sp, cp=cp,
                           path=PathBuffer.from_points(course, 0.1, device=dev),
                           sigma_adapt=0.2, solver_options=dict(opts, use_kernel=True))
        start = np.zeros(m.num_states)
        start[:2] = course[0]
        start[2] = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
        state = torch.tensor(start, dtype=torch.float32, device=dev)
        states, reset = [], None
        fused_sample_rollout_cost.launches = 0
        t0 = time.perf_counter()
        for i in range(STEPS):
            if swap and i == STEPS // 2:
                loop.set_path(PathBuffer.from_points(course, 0.1, device=dev))
                reset = bool(torch.isinf(loop._thresh))
            res = loop.step(state, dt=0.1)
            state = m.step(state, res.u0, 0.1)
            states.append(state)
        xy = torch.stack(states)[:, :2].cpu().numpy()
        wall = time.perf_counter() - t0
        n = fused_sample_rollout_cost.launches
        name = f"{cfg.model}_sigma" + ("_elite_stale" if opts.get("elite_stale")
                                       else "_elite" if opts else "")
        launches[name] = n
        loop_rate[name] = STEPS / wall
        rmse = tracking_metrics(np.concatenate([start[None, :2], xy]), course,
                                dt=0.1)["rmse"]
        sigma, sigma0 = loop.sp.control_noise, sp.control_noise
        inside = bool(((sigma >= 0.25 * sigma0 - 1e-7) & (sigma <= 4.0 * sigma0 + 1e-7)).all())
        moved = not bool(torch.allclose(sigma, sigma0))
        finite = bool(np.isfinite(xy).all())
        print(f"[11 ControlLoop] {preset} sigma_adapt=0.2 {opts or ''}"
              f"{' set_path at cycle 100' if swap else ''}: {STEPS} cycles K={K_MAIN} "
              f"T={T_MAIN}: RMSE {rmse:.4f} m, sigma {sigma.cpu().numpy().round(4).tolist()} "
              f"(sigma0 {sigma0.cpu().numpy().round(4).tolist()}), inside bounds {inside}, "
              f"moved {moved}, kernel launches {n}"
              f"{'' if reset is None else f', threshold reset to +inf by set_path {reset}'}; "
              f"{STEPS / wall:.1f} cycles/s (host clock)", flush=True)
        require(finite and rmse < 0.15, f"{name}: RMSE {rmse} (finite {finite})")
        require(inside and moved, f"{name}: sigma not adapted inside its bounds")
        require(n == per_cycle * STEPS, f"{name}: {n} launches, not {per_cycle * STEPS}")
        require(reset is not False, f"{name}: set_path kept the stale threshold")
        counters_zero(name)

    # --- 12. fleet kernel vs plain version ----------------------------------
    def fleet_compare(tag, kern, plain):
        (ck, uk, nk), (cr, ur, nr) = kern, plain
        torch.cuda.synchronize()
        cost_rel = float(((ck - cr).abs() / cr.abs()).max())
        require(bool(torch.isfinite(ck).all()), f"{tag}: non-finite kernel costs")
        err, bound = u_err(tag, uk / nk[:, None, None], ur / nr[:, None, None])
        print(f"  {tag}: costs max rel err {cost_rel:.3e} (rtol {COST_RTOL}); u_opt "
              f"max abs err over robots {err:.3e} (bound {bound:.3e})", flush=True)
        require(cost_rel <= COST_RTOL, f"{tag}: costs differ by {cost_rel}")
        counters_zero(tag)
        return err

    print(f"[12 fleet kernel] B={B_FLEET} K={K_FLEET} T={T_FLEET}, one launch", flush=True)
    fleet_cases = {}
    for preset in PRESET_MODELS:
        c = kernel_case(preset, K_FLEET, T_FLEET, robots=B_FLEET, seed=8)
        model, fargs, fnoise = c["model"], c["kargs"], c["noise"]
        fleet_cases[model] = fargs
        kw = dict(num_samples=K_FLEET, model=model)
        nkw, rkw = dict(kw, seed=0, step=0, noise=fnoise), dict(kw, seed=11, step=12)
        fleet_compare(f"{model} noise", kernel_fn(*fargs, **nkw), plain_fn(*fargs, **nkw))
        batched = kernel_fn(*fargs, **rkw)
        max_abs_err[f"{model}_fleet"] = fleet_compare(f"{model} RNG", batched,
                                                      plain_fn(*fargs, **rkw))
        same = []
        for b in (0, 1, 128, B_FLEET - 1):
            one = kernel_fn(*(a[b] if i in (0, 4, 5, 6) else a for i, a in enumerate(fargs)),
                            robot=b, **rkw)
            same.append(all(bool(torch.equal(x[b], y)) for x, y in zip(batched, one)))
        # one robot's costs 1e3 higher: under a baseline shared across robots
        # its weights would underflow to 0 (exp(-1e3/lambda)) and u_opt be NaN
        off = batched[0].clone()
        off[5] += 1e3
        okern = kernel_fn(*fargs, costs_in=off, **rkw)
        fleet_compare(f"{model} robot 5 costs +1e3", (off,) + okern[1:],
                      (off,) + plain_fn(*fargs, costs_in=off, **rkw)[1:])
        u5_err, _ = u_err(f"{model} robot 5 offset vs not", okern[1][5] / okern[2][5],
                          batched[1][5] / batched[2][5])
        print(f"  {model}: robot b of the launch bit-equal to a launch of robot b alone "
              f"(b = 0, 1, 128, {B_FLEET - 1}): {same}; robot 5 with costs +1e3 keeps "
              f"its update (max abs change {u5_err:.3e})", flush=True)
        require(all(same), f"{model}: fleet robot differs from its own launch")

    # --- 13. fleet closed loops -------------------------------------------
    for preset in ("diff_drive", "full_body"):
        cfg, sp, cp, course = PRESETS[preset](num_samples=K_FLEET, horizon=T_FLEET,
                                              device=dev)
        m = get_model(cfg.model)
        path = PathBuffer.from_points(course, 0.1, device=dev)
        states = fan(course, B_FLEET, m.num_states)
        step_fn = build_fleet_step(cfg, use_kernel=True)
        ctrls = init_fleet(cfg, B_FLEET, seed=1, device=dev)
        dt = torch.full((), 0.1, device=dev)
        fused_sample_rollout_cost.launches = 0
        t0 = time.perf_counter()
        for _ in range(STEPS):
            ctrls, res = step_fn(ctrls, states, path, dt, sp, cp)
            states = m.step(states, res.u0, dt)
        final = states.cpu().numpy()
        wall = time.perf_counter() - t0
        n = fused_sample_rollout_cost.launches
        launches[f"{cfg.model}_fleet"] = n
        d = np.min(np.linalg.norm(final[:, None, :2] - course[None, :, :], axis=-1), axis=1)
        progress = bool((final[:, 0] > 0.5 * course[-1, 0]).all())
        print(f"[13 fleet closed loop] {preset} B={B_FLEET} K={K_FLEET} T={T_FLEET}, "
              f"{STEPS} ticks: distance to the course at the end max {d.max():.4f} m, "
              f"mean {d.mean():.4f} m; past half the course {progress}; kernel launches "
              f"{n}; {B_FLEET * STEPS / wall:.1f} robot-updates/s (host clock)", flush=True)
        require(bool(np.isfinite(final).all()) and bool((d < 0.3).all()) and progress,
                f"{preset} fleet: a robot ended {d.max()} m from the course")
        require(n == STEPS, f"{preset} fleet: {n} launches, not {STEPS}")
        counters_zero(f"{preset} fleet")

    # --- 14. the fleet command --------------------------------------------
    for extra in ([], ["--no-kernel"]):
        argv = ["fleet", "--preset", "diff_drive", "--robots", "64", "--steps", str(STEPS),
                *extra]
        fused_sample_rollout_cost.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        lines = buf.getvalue().splitlines()
        n = fused_sample_rollout_cost.launches
        worst = float(lines[1].split("worst=")[1])
        print(f"[14 cli] {' '.join(argv)}: rc {rc}, {' | '.join(lines)}, kernel "
              f"launches {n}", flush=True)
        require(rc == 0 and worst < 0.15 and n == (0 if extra else STEPS),
                f"cli {' '.join(argv)}")
        counters_zero(f"cli {' '.join(argv)}")

    # --- 15. timing of the new modes ----------------------------------------
    arms = {}
    for preset in PRESET_MODELS:
        s = kernel_case(preset, K_MAIN, T_MAIN, roll_off=True, seed=5)
        model = s["model"]
        mkw = dict(seed=1, step=2, num_samples=K_MAIN, model=model)
        arms[f"{model}/vanilla_alone"] = (KernelLaunch(*s["kargs"], **mkw).run, 50)
        arms[f"{model}/m2_alone"] = (
            KernelLaunch(*s["kargs"], second_moment=True, **mkw).run, 50)
        arms[f"{model}/m2_plain"] = (
            lambda s=s, mkw=mkw: plain_fn(*s["kargs"], second_moment=True, **mkw), 3)
        arms[f"{model}/update_kernel_lean_adapt"] = (
            updater(s, "kernel", adapt_sigma=True), 20)
        if preset in ("full_body", "diff_drive"):
            costs = kernel_fn(*s["kargs"], accumulate=False, **mkw)[0]
            thresh = elite_threshold(costs, ELITE)

            def plain_elite_m2(s=s, mkw=mkw):
                c = plain_fn(*s["kargs"], accumulate=False, **mkw)[0]
                plain_fn(*s["kargs"][:6], s["scal"](elite_threshold(c, ELITE)),
                         costs_in=c, second_moment=True, **mkw)

            arms[f"{model}/m2_elite_pass2_alone"] = (KernelLaunch(
                *s["kargs"][:6], s["scal"](thresh), costs_in=costs, second_moment=True,
                **mkw).run, 50)
            arms[f"{model}/m2_elite_plain"] = (plain_elite_m2, 3)
            arms[f"{model}/m2_stale_alone"] = (KernelLaunch(
                *s["kargs"][:6], s["scal"](thresh), second_moment=True, **mkw).run, 50)
            arms[f"{model}/m2_stale_plain"] = (
                lambda s=s, mkw=mkw, th=thresh: plain_fn(
                    *s["kargs"][:6], s["scal"](th), second_moment=True, **mkw), 3)
    for model, fargs in fleet_cases.items():
        fkw = dict(seed=1, step=2, num_samples=K_FLEET, model=model)
        arms[f"fleet/{model}/kernel_alone"] = (KernelLaunch(*fargs, **fkw).run, 50)
        arms[f"fleet/{model}/plain_alone"] = (
            lambda fargs=fargs, fkw=fkw: plain_fn(*fargs, **fkw), 3)
    for preset in ("diff_drive", "full_body"):
        cfg, sp, cp, course = PRESETS[preset](num_samples=K_FLEET, horizon=T_FLEET,
                                              device=dev)
        args = (fan(course, B_FLEET, cfg.num_states),
                PathBuffer.from_points(course, 0.1, device=dev),
                torch.full((), 0.1, device=dev), sp, cp)
        for arm, use_kernel, inner in (("kernel", True, 20), ("eager", False, 3)):
            carry = [init_fleet(cfg, B_FLEET, device=dev)]
            step_fn = build_fleet_step(cfg, use_kernel=use_kernel)

            def tick(carry=carry, step_fn=step_fn, args=args):
                carry[0], _ = step_fn(carry[0], *args)
            arms[f"fleet/{cfg.model}/tick_{arm}"] = (tick, inner)
    times = time_interleaved(arms, reps)
    med.update({name: statistics.median(v) for name, v in times.items()})
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"[15 timing] second moment at K={K_MAIN} T={T_MAIN}; fleet at B={B_FLEET} "
          f"K={K_FLEET} T={T_FLEET}; median of {reps} CUDA-event reps, on {card} (after: "
          f"sm clock, draw, limit, temp = {clocks})", flush=True)
    for name in arms:
        rate = ""
        if "/tick_" in name:
            rate = f"; {B_FLEET / (med[name] * 1e-3):.4e} robot-updates/s"
        spread = f"[{min(times[name]):.4f}, {max(times[name]):.4f}]"
        print(f"  {name}: {med[name]:.4f} ms {spread}{rate}", flush=True)
    counters_zero("timing of the new modes")

    # --- 16. the two forms and the finish ---------------------------------
    print("[16 forms and finish]", flush=True)
    s = kernel_case("full_body", K_REF, 400, seed=9)
    shape = launch_shape("full_body", K_REF, 400, 400, False)
    require(shape.form == "regen", f"full_body T=400: the {shape.form} form was chosen")
    kw = dict(seed=14, step=15, num_samples=K_REF, model="full_body")
    compare(f"full_body K={K_REF} T=400 RNG, chosen {shape.form}/{shape.threads}",
            kernel_fn(*s["kargs"], **kw), plain_fn(*s["kargs"], **kw))
    # the second moment with the noise injected: in RNG mode at T=400 the
    # weights sit on a few samples, and the 1-ulp differences of the two
    # Box-Mullers move sigma_suggest's weighted variance past its rtol
    kw = dict(seed=0, step=0, num_samples=K_REF, model="full_body", noise=s["noise"],
              second_moment=True)
    m2_check(f"full_body K={K_REF} T=400 noise second moment, chosen "
             f"{launch_shape('full_body', K_REF, 400, 400, True).form}",
             kernel_fn(*s["kargs"], **kw), plain_fn(*s["kargs"], **kw))

    def finish_check(tag, launch):
        """The kernel's finish vs finish_reference on the launch's own
        partial rows: norm within FINISH_RTOL, u_num/norm (and u2_num/norm)
        within FINISH_RTOL of its largest entry."""
        out = launch.finish()
        ref = finish_reference(launch.partials, launch.lam, launch.tm1, launch.u_dim,
                               launch.second_moment)
        torch.cuda.synchronize()
        norm_rel = float(((out[1] - ref[1]).abs() / ref[1].abs()).max())
        nk, nr = out[1][..., None, None], ref[1][..., None, None]
        errs = []
        for i in range(0, len(out), 2):
            a, b = out[i] / nk, ref[i] / nr
            errs.append(float((a - b).abs().max()) / float(b.abs().max()))
        print(f"  {tag}: kernel finish vs plain finish over {launch.shape.blocks} rows "
              f"({launch.shape.form}/{launch.shape.threads}): norm rel err {norm_rel:.2e}, "
              f"u_num/norm{' and u2_num/norm' if len(out) > 2 else ''} err / max "
              f"{max(errs):.2e} (rtol {FINISH_RTOL})", flush=True)
        require(norm_rel <= FINISH_RTOL and max(errs) <= FINISH_RTOL,
                f"{tag}: the kernel's finish differs from the plain finish")

    for preset in PRESET_MODELS:
        s = kernel_case(preset, K_MAIN, T_MAIN, seed=10)
        model = s["model"]
        kw = dict(seed=12, step=13, num_samples=K_MAIN, model=model)
        plain = plain_fn(*s["kargs"], **kw)
        for form in ("store", "regen"):
            launch = KernelLaunch(*s["kargs"], form=form, **kw)
            launch.run()
            chosen = " (chosen)" if launch_shape(model, K_MAIN, T_MAIN, T_MAIN).form == form \
                else " (forced)"
            compare(f"{model} K={K_MAIN} T={T_MAIN} RNG {form}/{launch.shape.threads}{chosen}",
                    (launch.costs,) + launch.finish(), plain)
            finish_check(f"{model} {form}", launch)
        # the costs-in pass in the store form, which the chooser never picks
        # (its tile is filled from the RNG with no rollout)
        launch = KernelLaunch(*s["kargs"], costs_in=plain[0], form="store", **kw)
        launch.run()
        compare(f"{model} K={K_MAIN} T={T_MAIN} RNG costs-in pass, store/"
                f"{launch.shape.threads} (forced)", (launch.costs,) + launch.finish(), plain)
        launch = KernelLaunch(*s["kargs"], second_moment=True, **kw)
        launch.run()
        finish_check(f"{model} second moment", launch)
        launch = KernelLaunch(*fleet_cases[model], seed=12, step=13, num_samples=K_FLEET,
                              model=model)
        launch.run()
        finish_check(f"{model} fleet B={B_FLEET} K={K_FLEET} T={T_FLEET}", launch)
    counters_zero("forms and finish")

    # --- 17. launches per update and busy share, torch.profiler -------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_update(fn, n):
        """fn's event-timed ms a call (median of 5 runs of n, after 3 warm
        calls) and, by torch.profiler over n calls, its device launches, its
        fused-kernel launches and its device ms a call; the last three None
        where the profiler recorded no device activity."""
        for _ in range(3):
            fn()
        step_ms = statistics.median(event_ms(fn, n) for _ in range(5))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not dev_events:
            return step_ms, None, None, None
        kern = [e for e in dev_events if "rollout_cost_kernel" in e.name]
        dev_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / n
        return step_ms, len(dev_events) / n, len(kern) / n, dev_ms

    prof_cases = [("full_body", {}), ("full_body", {"elite_frac": ELITE}),
                  ("full_body", {"adapt_sigma": True}), ("diff_drive", {})]
    for preset, opts in prof_cases:
        s = kernel_case(preset, K_MAIN, T_MAIN, roll_off=True, seed=5)
        step_ms, n_dev, n_kern, dev_ms = profile_update(updater(s, "kernel", **opts), 20)
        name = f"{s['model']}{''.join('_' + k for k in opts)}"
        if n_dev is None:
            print(f"[17 profile] {name}: the profiler recorded no device activity: "
                  f"launches and busy share not measured", flush=True)
            continue
        print(f"[17 profile] {name} kernel-lean update K={K_MAIN} T={T_MAIN}: "
              f"{n_dev:.1f} device launches per update "
              f"({n_kern:.1f} of the fused kernel), device time {dev_ms:.4f} ms "
              f"per update over an event-timed update of {step_ms:.4f} ms: busy "
              f"{100 * dev_ms / step_ms:.1f} % on {card}", flush=True)
    counters_zero("profile")

    # --- 18. entry points on the card --------------------------------------
    from ccv_mppi_path_tracker_tpu_torch.core import config as port_config
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params
    from ccv_mppi_path_tracker_tpu_torch.runtime import load_checkpoint, save_checkpoint
    from ccv_mppi_path_tracker_tpu_torch.runtime.realtime import (
        run_pipelined_experiment,
        run_realtime_experiment,
    )
    from ccv_mppi_path_tracker_tpu_torch.runtime.sim_sensors import run_full_stack_experiment
    from ccv_mppi_path_tracker_tpu_torch.solver import MPPISolver
    from ccv_mppi_path_tracker_tpu_torch.solver.command import (
        command_from_solution,
        steering_mode,
    )

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    small = dict(num_samples=8, horizon=4)
    cfg_s, sp_s, cp_s = port_config.diff_drive_config(**small)
    save_checkpoint(str(tmp / "defaults.npz"), cfg_s, ControllerState.initial(0, 4, 2),
                    sp=sp_s, cp=cp_s)
    made = {f"{name} preset": fn(**small)[1].lam for name, fn in PRESETS.items()}
    made.update({name: getattr(port_config, name)(**small)[2].v_ref
                 for name in ("diff_drive_config", "steering_diff_drive_config",
                              "rate_limited_steering_config", "full_body_config")})
    made["PathBuffer.from_points"] = PathBuffer.from_points(PRESETS["diff_drive"]()[3],
                                                            0.1).xy
    made["ControllerState.initial"] = ControllerState.initial(0, 4, 2).u_prev
    made["MPPISolver.init"] = MPPISolver(cfg_s).init(0).u_prev
    made["init_fleet"] = init_fleet(cfg_s, 3).u_prev
    made["default_params"] = default_params().inertia
    made["load_checkpoint"] = load_checkpoint(str(tmp / "defaults.npz"))[2]["cp"].v_ref
    not_cuda = sorted(k for k, v in made.items() if v.device.type != "cuda")
    print(f"[18 default device] {len(made)} entry points called with no device: "
          f"{len(made) - len(not_cuda)} gave cuda tensors; not cuda: {not_cuda}", flush=True)
    require(not not_cuda, f"entry points that did not default to the card: {not_cuda}")
    # command_from_solution on the card against its CPU run: bit-equal where
    # finite, NaN where NaN, on random commands and the quirk rows
    cmd_cases = [(m, {}) for m in KERNEL_MODELS] + [
        ("unicycle", {"pitch_offset": 0.05}), ("full_body", {"current_roll": 0.45}),
        ("full_body", {"current_roll": 0.1, "roll_off": True}),
        ("full_body", {"steer_off": True}), ("steering_unicycle", {"steer_off": True}),
        ("rate_limited_steering", {"current_steer": 0.3})]
    rng = np.random.RandomState(18)
    fields = ("v", "w", "steer_l", "steer_r", "roll", "fore", "rear")
    compared = nan = 0
    for model, kw in cmd_cases:
        u_dim = get_model(model).num_controls
        rows = rng.uniform(-1.0, 1.0, (16, u_dim))
        rows[:, 0] *= 2.0
        quirks = np.zeros((4, u_dim))
        quirks[:3, 0] = 1.0  # w = 0: pi/4 where the direction is not 0
        if u_dim > 2:
            quirks[:3, 2] = (0.2, -0.2, 0.0)
        for u0 in torch.tensor(np.concatenate([rows, quirks]), dtype=torch.float32):
            on_cpu = command_from_solution(model, u0, 0.1, **kw)
            on_card = command_from_solution(model, u0.to(dev), 0.1, **kw)
            for f in fields:
                a, b = getattr(on_cpu, f), getattr(on_card, f).cpu()
                same = bool(torch.isnan(a) == torch.isnan(b)) and (
                    bool(torch.isnan(a)) or bool(a == b))
                require(same, f"command {model} {kw} {f}: card {float(b)!r} vs cpu "
                              f"{float(a)!r} for u0 {u0.tolist()}")
                compared += 1
                nan += bool(torch.isnan(a))
    u0_card = torch.tensor([1.0, 0.3, 0.1, 0.2, 0.0], device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cmd = command_from_solution("full_body", u0_card, 0.1, pitch_offset=0.05,
                                    current_roll=0.2)
        steering_mode(cmd.steer_r, cmd.steer_l)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"  command_from_solution: {len(cmd_cases)} model/option cases x 20 commands, "
          f"{compared} values bit-equal on the card and the CPU ({nan} NaN in both); "
          f"no host sync in command_from_solution and steering_mode", flush=True)

    # --- 19. the paced loop, full width -----------------------------------
    serving = {}
    # run_realtime_experiment's copies to the card before its first cycle,
    # each a synchronizing copy from pageable host memory: the path's points
    # and resolution (PathBuffer.from_points) and the start pose
    SETUP_COPIES = 3

    def count_syncs(fn):
        """fn() with every host sync counted (torch's sync debug mode warns
        once per synchronizing call)."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, sum("synchroniz" in str(w.message) for w in caught)

    def rate_line(rs):
        return (f"{rs['cycles']} cycles, mean dt {rs['mean_dt'] * 1e3:.4f} ms, "
                f"{rs['deadline_misses']} deadline misses, max jitter "
                f"{rs['max_abs_jitter'] * 1e3:.4f} ms")

    for preset, hz, cycles, record in (("full_body", 10.0, 50, False),
                                       ("diff_drive", 50.0, 100, True)):
        cfg, sp, cp, course = PRESETS[preset](num_samples=K_MAIN, horizon=T_MAIN)
        rec_path = tmp / f"{preset}_realtime.csv" if record else None
        fused_sample_rollout_cost.launches = 0
        out, syncs = count_syncs(lambda: run_realtime_experiment(
            cfg, sp, cp, course, hz=hz, num_cycles=cycles,
            record_path=None if rec_path is None else str(rec_path), use_kernel=True))
        n = fused_sample_rollout_cost.launches
        rs, m = out["rate_stats"], out["metrics"]
        lines = len(rec_path.read_text().strip().split("\n")) if record else None
        serving[f"realtime_{cfg.model}"] = dict(
            rs, hz=hz, launches=n, rmse=m["rmse"], host_syncs=syncs,
            stale_cycles=out["stale_cycles"])
        print(f"[19 realtime] {preset} K={K_MAIN} T={T_MAIN} at {hz:g} Hz: RMSE "
              f"{m['rmse']:.4f} m; rate {rate_line(rs)}; stale cycles "
              f"{out['stale_cycles']}; kernel launches {n} ({cycles} cycles + warm-up); "
              f"host syncs {syncs} (one read a cycle, the warm-up's, and {SETUP_COPIES} "
              f"copies of the course and the start pose to the card)"
              f"{'' if lines is None else f'; CSV lines {lines}'} on {card}", flush=True)
        require(bool(np.isfinite(out["logs"]["state"]).all()), f"{preset} realtime: not finite")
        require(n == cycles + 1, f"{preset} realtime: {n} launches, not {cycles + 1}")
        require(syncs == cycles + 1 + SETUP_COPIES,
                f"{preset} realtime: {syncs} host syncs, not one a cycle")
        require(rs["cycles"] == cycles, f"{preset} realtime: {rs['cycles']} paced cycles")
        require(m["rmse"] < (0.15 if preset == "full_body" else 0.5),
                f"{preset} realtime: RMSE {m['rmse']}")
        require(lines in (None, cycles + 1), f"{preset} realtime: {lines} CSV lines")
        counters_zero(f"{preset} realtime")

    # the cycle's own time: at 1000 Hz every deadline is missed, so the mean
    # dt is the time one cycle takes; then its device launches, profiled
    cfg, sp, cp, course = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN)
    fused_sample_rollout_cost.launches = 0
    out = run_realtime_experiment(cfg, sp, cp, course, hz=1000.0, num_cycles=100,
                                  use_kernel=True)
    n, rs = fused_sample_rollout_cost.launches, out["rate_stats"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_realtime_experiment(cfg, sp, cp, course, hz=1000.0, num_cycles=20,
                                use_kernel=True)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / 21
    serving["realtime_full_body_unpaced"] = dict(
        cycles=rs["cycles"], cycle_ms=rs["mean_dt"] * 1e3, launches=n,
        device_launches_per_cycle=len(dev_events) / 21, device_ms_per_cycle=dev_ms)
    print(f"[19 unpaced] full_body K={K_MAIN} T={T_MAIN} at 1000 Hz, {rs['cycles']} cycles, "
          f"{rs['deadline_misses']} deadline missed: one cycle takes {rs['mean_dt'] * 1e3:.4f} "
          f"ms (mean dt; max jitter {rs['max_abs_jitter'] * 1e3:.4f} ms), "
          f"{100 * rs['mean_dt'] / 0.1:.2f} % of the 10 Hz period and "
          f"{100 * rs['mean_dt'] / 0.02:.2f} % of the 50 Hz one; kernel launches {n}; "
          f"profiled over 20 cycles + warm-up: {len(dev_events) / 21:.1f} device launches "
          f"and {dev_ms:.4f} ms device time a cycle (the setup's copies included) on {card}",
          flush=True)
    require(n == 101, f"unpaced realtime: {n} launches, not 101")
    counters_zero("unpaced realtime")

    # --- 20. the pipelined loop -------------------------------------------
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=K_MAIN, horizon=T_MAIN)
    piped = {}
    for micro_batch, comp in ((1, True), (8, True), (8, False)):
        fused_sample_rollout_cost.launches = 0
        out = run_pipelined_experiment(cfg, sp, cp, course, hz=50.0, num_cycles=96,
                                       use_kernel=True, micro_batch=micro_batch,
                                       delay_compensation=comp)
        n = fused_sample_rollout_cost.launches
        rs, fm, dm, m = out["rate_stats"], out["fetch_ms"], out["dispatch_ms"], out["metrics"]
        piped[micro_batch, comp] = m["rmse"]
        serving[f"pipelined_m{micro_batch}_{'comp' if comp else 'nocomp'}"] = dict(
            rs, hz=50.0, launches=n, rmse=m["rmse"], miss_rate=out["miss_rate"], fetch_ms=fm,
            dispatch_ms=dm)
        print(f"[20 pipelined] diff_drive K={K_MAIN} T={T_MAIN} at 50 Hz, micro_batch "
              f"{micro_batch}, delay compensation {comp}: RMSE {m['rmse']:.4f} m; rate "
              f"{rate_line(rs)}, miss rate {out['miss_rate']:.4f}; fetch ms mean "
              f"{fm['mean']:.4f} p95 {fm['p95']:.4f} max {fm['max']:.4f}; a window's dispatch "
              f"ms mean {dm['mean']:.4f} p95 {dm['p95']:.4f} max {dm['max']:.4f}; kernel launches {n} "
              f"({rs['cycles']} cycles + {micro_batch} warm-up) on {card}", flush=True)
        require(rs["cycles"] == 96 and n == 96 + micro_batch,
                f"pipelined M={micro_batch}: {rs['cycles']} cycles, {n} launches")
        require(m["rmse"] < 0.5, f"pipelined M={micro_batch} comp={comp}: RMSE {m['rmse']}")
        counters_zero(f"pipelined M={micro_batch}")
    require(piped[8, True] < piped[8, False],
            f"pipelined M=8: compensated RMSE {piped[8, True]} not below uncompensated "
            f"{piped[8, False]}")

    # --- 21. full stack, resume, and the serving commands ----------------
    stack = {}
    for roll_off in (True, False):
        fused_sample_rollout_cost.launches = 0
        out = run_full_stack_experiment(roll_off=roll_off, cycles=80, num_samples=K_MAIN,
                                        horizon=T_MAIN, use_kernel=True)
        n = fused_sample_rollout_cost.launches
        stack[roll_off] = out
        peak = float(np.max(np.abs(out["true_zmp"][5:])))
        print(f"[21 full stack] full_body roll_off={roll_off} K={K_MAIN} T={T_MAIN}, 80 "
              f"cycles on the estimated state: RMSE {out['metrics']['rmse']:.4f} m, peak "
              f"lateral |true ZMP| {peak:.4f} m, estimate vs force-sensor ZMP after cycle "
              f"20 within {np.max(np.abs(out['zmp'][20:] - out['true_zmp'][20:])):.4f} m; "
              f"kernel launches {n}", flush=True)
        require(n == 80, f"full stack roll_off={roll_off}: {n} launches, not 80")
        require(out["metrics"]["rmse"] < 0.15,
                f"full stack roll_off={roll_off}: RMSE {out['metrics']['rmse']}")
        counters_zero("full stack")
    peak_u = np.max(np.abs(stack[True]["true_zmp"][5:]))
    peak_c = np.max(np.abs(stack[False]["true_zmp"][5:]))
    require(peak_c < peak_u, f"the ZMP cost did not lower the lateral ZMP: {peak_c} vs {peak_u}")

    cfg, sp, cp, course = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN)
    path = PathBuffer.from_points(course, 0.1)
    m = get_model(cfg.model)
    start = torch.tensor([course[0, 0], course[0, 1], 0.3, 0.0, 0.0], device=dev)

    def drive(ctrl, state, n, sp, cp):
        u0s = []
        for _ in range(n):
            ctrl, res = mppi_step(cfg, ctrl, state, path, 0.1, sp, cp, use_kernel=True,
                                  lean=True)
            state = m.step(state, res.u0, 0.1)
            u0s.append(res.u0)
        return ctrl, state, torch.stack(u0s)

    fused_sample_rollout_cost.launches = 0
    _, _, whole = drive(ControllerState.initial(21, T_MAIN, 5), start, 2 * 100, sp, cp)
    ctrl_a, state_a, first = drive(ControllerState.initial(21, T_MAIN, 5), start, 100, sp, cp)
    save_checkpoint(str(tmp / "resume.npz"), cfg, ctrl_a, sp=sp, cp=cp)
    cfg_b, ctrl_b, params = load_checkpoint(str(tmp / "resume.npz"))
    _, _, rest = drive(ctrl_b, state_a, 100, params["sp"], params["cp"])
    n = fused_sample_rollout_cost.launches
    same = bool(torch.equal(torch.cat([first, rest]), whole))
    print(f"[21 resume] full_body K={K_MAIN} T={T_MAIN}, kernel RNG mode: 200 cycles vs 100 "
          f"+ save_checkpoint + load_checkpoint (on {ctrl_b.u_prev.device}, cycle "
          f"{ctrl_b.step}) + 100: u0 logs bit-equal {same}; kernel launches {n}", flush=True)
    require(same and n == 400 and cfg_b == cfg, "resume on the kernel path")
    counters_zero("resume")

    def cli_run(argv, expect_launches):
        fused_sample_rollout_cost.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        lines = buf.getvalue().splitlines()
        n = fused_sample_rollout_cost.launches
        print(f"[21 cli] {' '.join(argv)}: rc {rc}, {' | '.join(lines)}; kernel launches "
              f"{n}", flush=True)
        require(rc == 0 and n == expect_launches,
                f"cli {' '.join(argv)}: rc {rc}, {n} launches, not {expect_launches}")
        counters_zero(f"cli {' '.join(argv)}")
        return lines

    lines = cli_run(["realtime", "--preset", "full_body", "--hz", "10", "--steps", "30",
                     "--num-samples", str(K_MAIN), "--horizon", str(T_MAIN)], 31)
    require(float(lines[3].split(": ")[1]) < 0.15 and lines[4].startswith("rate: 30 cycles"),
            "cli realtime full_body")
    lines = cli_run(["realtime", "--pipelined", "--micro-batch", "4", "--hz", "50", "--steps",
                     "48"], 52)
    require(lines[1].startswith("pipelined: micro_batch=4") and
            lines[-1].startswith("rate: 48 cycles"), "cli realtime --pipelined")
    lines = cli_run(["compare", "--steps", str(STEPS)], STEPS)
    rmse_mppi, rmse_pp = (float(line.split("RMSE=")[1].split()[0]) for line in lines)
    require(rmse_mppi < rmse_pp, f"cli compare: MPPI {rmse_mppi} vs pure pursuit {rmse_pp}")
    lines = cli_run(["course", "--kind", "dkan", "--out", str(tmp / "dkan.csv")], 0)
    require(lines[0].startswith("dkan course: "), "cli course")
    ck = tmp / "cli.npz"
    lines = cli_run(["run", "--record", str(tmp / "log"), "--course", "dkan", "--save-ckpt",
                     str(ck), "--steps", str(STEPS)], STEPS)
    require(lines[-1].startswith("recorded: ") and float(lines[-2].split(": ")[1]) < 0.15,
            "cli run --record --course dkan --save-ckpt")
    lines = cli_run(["run", "--resume-ckpt", str(ck), "--steps", str(STEPS)], STEPS)
    require(lines[0] == f"resumed from {ck} (cycle {STEPS})", "cli run --resume-ckpt")
    shutil.rmtree(tmp)
    print(json.dumps({"serving": serving}))

    # --- 22. refinement after the kernel, full width ------------------------
    from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
    from ccv_mppi_path_tracker_tpu_torch.diff import make_trajectory_cost

    methods = ("gradient", "gauss_newton")
    refine_opts = {m: dict(refine_steps=3, refine_method=m) for m in methods}
    cpu = torch.device("cpu")

    def cast(obj, dtype, device):
        """A parameter dataclass (or None) with its tensors on device, dtype."""
        if obj is None:
            return None
        return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device, dtype)
                                           for f in dataclasses.fields(obj)})

    refined = {}
    for preset in ("full_body", "diff_drive"):
        s = kernel_case(preset, K_MAIN, T_MAIN, seed=22)
        cfg, model = s["cfg"], s["model"]
        ctrl = ControllerState(s["u_prev"], 0, 0)
        step_args = (cfg, ctrl, s["state"], s["path"], s["dt"], s["sp"], s["cp"])
        _, res = mppi_step(*step_args, model_params=s["mp"], use_kernel=True)

        def stage_inputs(dtype, device):
            return (res.u_opt.to(device, dtype), s["state"].to(device, dtype),
                    RefWindow(res.ref.xy.to(device, dtype), res.ref.yaw.to(device, dtype)),
                    s["dt"].to(device, dtype), cast(s["sp"], dtype, device),
                    cast(s["cp"], dtype, device), cast(s["mp"], dtype, device))

        # (a) the refine stage of mppi_step on the card against the CPU
        errs = {}
        for m in methods:
            out = {(dtype, device.type): _refine(cfg, *stage_inputs(dtype, device), 3, 0.02, m)
                   for dtype in (torch.float64, torch.float32) for device in (dev, cpu)}
            a, b = out[torch.float64, "cuda"].cpu(), out[torch.float64, "cpu"]
            excess = float(((a - b).abs() - (1e-8 * b.abs() + 1e-12)).max())
            errs[m] = (float((a - b).abs().max()),
                       float((out[torch.float32, "cuda"].cpu() - out[torch.float32, "cpu"])
                             .abs().max()),
                       float((a - res.u_opt.double().cpu()).abs().max()))
            require(excess <= 0.0, f"{model} {m} refine stage: card and CPU differ beyond "
                                   f"rtol 1e-8 at float64 (max |d| {errs[m][0]})")
        # (b) the trajectory cost of the update, unrefined and refined, on the card
        args32 = stage_inputs(torch.float32, dev)
        cost_fn = make_trajectory_cost(cfg)
        costs = {"unrefined": float(cost_fn(args32[0], *args32[1:4], args32[5], args32[6]))}
        for m in methods:
            u = _refine(cfg, *args32, 3, 0.02, m)
            costs[m] = float(cost_fn(u, *args32[1:4], args32[5], args32[6]))
        print(f"[22 refine stage] {model} K={K_MAIN} T={T_MAIN}, the kernel's update: "
              + "; ".join(f"{m} card vs CPU max |d| {e64:.3e} at float64 (rtol 1e-8), "
                          f"{e32:.3e} at float32 (printed only), moved the update by "
                          f"{moved:.3e}" for m, (e64, e32, moved) in errs.items())
              + f"; trajectory cost unrefined {costs['unrefined']:.6f}, gradient "
                f"{costs['gradient']:.6f}, gauss_newton {costs['gauss_newton']:.6f}",
              flush=True)
        require(costs["gauss_newton"] <= costs["unrefined"],
                f"{model}: the Gauss-Newton refinement raised the cost")
        refined[f"{model}_cost"] = costs
        # (c) no host sync in the refined step: kernel and eager, lean and full
        combos = [dict(refine_opts[m], use_kernel=uk, lean=lean)
                  for m in methods for uk in (True, False) for lean in (True, False)]
        for kw in combos:  # warm-up outside the check
            mppi_step(*step_args, model_params=s["mp"], **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for kw in combos:
                mppi_step(*step_args, model_params=s["mp"], **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print(f"  {model}: no host sync inside mppi_step(refine_steps=3), both methods, "
              f"kernel and eager, lean and full", flush=True)
    counters_zero("refine stage")

    # (d) the refined closed loop through the user entry point
    cfg, sp, cp, course = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN, device=dev)
    fused_sample_rollout_cost.launches = 0
    t0 = time.perf_counter()
    out = run_tracking_experiment(cfg, sp, cp, course, num_steps=STEPS, dt=0.1,
                                  use_kernel=True, solver_options=refine_opts["gauss_newton"])
    wall = time.perf_counter() - t0
    n = fused_sample_rollout_cost.launches
    launches["full_body_refined"] = n
    logs, m = out["logs"], out["metrics"]
    finite = bool(np.isfinite(logs["state"]).all() and np.isfinite(logs["ess"]).all())
    refined["loop"] = dict(rmse=m["rmse"], launches=n, cycles_per_s=STEPS / wall,
                           ess_mean=float(np.mean(logs["ess"])))
    print(f"[22 refined loop] full_body refine_steps=3 gauss_newton, {STEPS} cycles K={K_MAIN} "
          f"T={T_MAIN}: RMSE {m['rmse']:.4f} m, max error {m['max_error']:.4f} m, logged "
          f"{sorted(logs)}, ess finite {finite} (mean {np.mean(logs['ess']):.1f}), kernel "
          f"launches {n}; {STEPS / wall:.2f} cycles/s (host clock, stats logged) on {card}",
          flush=True)
    require(finite and m["rmse"] < 0.15, f"refined loop: RMSE {m['rmse']}, finite {finite}")
    require(n == STEPS, f"refined loop: {n} launches, not {STEPS}")
    counters_zero("refined loop")

    # (e) the refined update's time and launches beside the unrefined one
    arms = {}
    for preset in ("full_body", "diff_drive"):
        s = kernel_case(preset, K_MAIN, T_MAIN, roll_off=True, seed=5)
        model = s["model"]
        arms[f"{model}/update_kernel_lean"] = (updater(s, "kernel"), 20)
        for meth in methods:
            arms[f"{model}/update_kernel_lean_{meth}"] = (
                updater(s, "kernel", **refine_opts[meth]), 3)
    times = time_interleaved(arms, 5, warm=1)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"[22 timing] kernel-lean update K={K_MAIN} T={T_MAIN}, median of 5 CUDA-event reps "
          f"on {card} (after: sm clock, draw, limit, temp = {clocks})", flush=True)
    for name, v in times.items():
        ms = statistics.median(v)
        step_ms, n_dev, n_kern, dev_ms = profile_update(arms[name][0], 3)
        refined[name] = dict(ms=ms, spread=[min(v), max(v)], device_launches=n_dev,
                             device_ms=dev_ms)
        prof = ("device launches not measured (the profiler recorded nothing)" if n_dev is None
                else f"{n_dev:.1f} device launches ({n_kern:.1f} of the fused kernel), "
                     f"device time {dev_ms:.4f} ms, busy {100 * dev_ms / step_ms:.1f} %")
        print(f"  {name}: {ms:.4f} ms [{min(v):.4f}, {max(v):.4f}]; {prof}", flush=True)
    gn_ms = refined["full_body/update_kernel_lean_gauss_newton"]["ms"]
    require(gn_ms < 100.0, f"the Gauss-Newton-refined full_body update takes {gn_ms} ms, "
                           f"over the 100 ms control period")
    counters_zero("refine timing")

    # --- 23. the training side on the card ----------------------------------
    from ccv_mppi_path_tracker_tpu_torch.diff import (
        ControlGains,
        collect_imitation_data,
        evaluate_rule,
        fit_full_body_params,
        fit_sampler,
        meta_train,
        proposal_mean,
        rollout_prediction_value_and_grad,
    )
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import zmp_chain
    from ccv_mppi_path_tracker_tpu_torch.paths import resample_reference

    training = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        training[name] = {"wall_s": time.perf_counter() - t0}
        return result

    def generator(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return gen

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = timed("sysid", lambda: cli.main(["sysid"]))
    sysid = json.loads(buf.getvalue().strip().splitlines()[-1])
    gains_rel = float(np.max(np.abs(np.subtract(sysid["fitted_gains"], sysid["true_gains"]))
                             / np.asarray(sysid["true_gains"])))
    training["sysid"].update(sysid)
    print(f"[23 sysid] rc {rc}: {sysid}; fitted vs true max rel err {gains_rel:.2e} (rtol "
          f"1e-3); {training['sysid']['wall_s']:.2f} s on {card}", flush=True)
    require(rc == 0 and gains_rel <= 1e-3, "sysid: the gains were not recovered")

    # fit_full_body_params on tests/test_diff.py:71-88's data, float64
    f64 = dict(dtype=torch.float64, device=dev)
    rng = np.random.RandomState(2)
    zstates = torch.tensor(rng.randn(12, 64, 5) * 0.2, **f64)
    zcontrols = torch.tensor(rng.randn(11, 64, 5) * 0.5, **f64)
    true = default_params(**f64)
    observed = zmp_chain(zstates, zcontrols, 0.1, true)[..., 1]
    init = dataclasses.replace(true, base2com=torch.full((), 0.6, **f64))
    fit, losses = timed("fit_full_body_params", lambda: fit_full_body_params(
        zstates, zcontrols, observed, 0.1, init, num_steps=500, learning_rate=0.02))
    com_rel = abs(float(fit.base2com) / float(true.base2com) - 1.0)
    training["fit_full_body_params"].update(base2com=float(fit.base2com), rel_err=com_rel)
    print(f"[23 fit_full_body_params] 500 Adam steps: base2com {float(fit.base2com):.6f} vs "
          f"{float(true.base2com):.6f} (rel err {com_rel:.2e}, limit 0.02); loss "
          f"{float(losses[0]):.3e} -> {float(losses[-1]):.3e}; "
          f"{training['fit_full_body_params']['wall_s']:.2f} s", flush=True)
    require(com_rel <= 0.02 and float(losses[-1]) < 1e-2 * float(losses[0]),
            "fit_full_body_params: base2com not recovered")

    # the chunked rollout gradient, tests/test_diff.py:222-228's data, float64
    rng = np.random.RandomState(3)
    rargs = (torch.zeros((128, 3), **f64), torch.tensor(rng.randn(16, 128, 2) * 0.5, **f64),
             torch.tensor(rng.randn(16, 128, 3) * 0.1, **f64))
    gains = ControlGains(gains=torch.tensor([1.1, 0.9], **f64))
    chunked = {nc: rollout_prediction_value_and_grad("unicycle", gains, *rargs, 0.1,
                                                     num_chunks=nc) for nc in (1, 4, 8)}
    l1, g1 = chunked[1]
    chunk_rel = max(max(abs(float(lc) / float(l1) - 1.0),
                        float(((gc.gains - g1.gains).abs() / g1.gains.abs()).max()))
                    for lc, gc in chunked.values())
    print(f"[23 rollout gradient] num_chunks 1, 4, 8 at float64: loss {float(l1):.6e}, "
          f"gradient {g1.gains.cpu().numpy().tolist()}; max rel difference {chunk_rel:.2e} "
          f"(rtol 1e-12)", flush=True)
    require(chunk_rel <= 1e-12, "the chunked rollout gradient depends on num_chunks")

    # the learned sampler: scripts/learning_eval.py:44-50's sizes
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=256, horizon=10, device=dev)
    feats, targets = timed("collect_imitation_data", lambda: collect_imitation_data(
        cfg, sp, cp, course, generator(0), num_states=96, solve_cycles=6))
    net, losses = timed("fit_sampler", lambda: fit_sampler(feats, targets, generator(1),
                                                           hidden=32, num_steps=300))
    path = PathBuffer.from_points(course, 0.1, device=dev)
    dt = torch.full((), 0.1, device=dev)
    rng = np.random.RandomState(7)
    wins = 0
    for i in range(6):
        j = rng.randint(0, len(course) - 2)
        yaw0 = np.arctan2(course[j + 1, 1] - course[j, 1], course[j + 1, 0] - course[j, 0])
        state = torch.tensor([course[j, 0], course[j, 1] + rng.randn() * 0.3,
                              yaw0 + rng.randn() * 0.3], dtype=torch.float32, device=dev)
        ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
        with torch.no_grad():
            u_net = torch.clamp(proposal_mean(net, cfg, state, ref), sp.u_min, sp.u_max)
        first = [float(mppi_step(cfg, ControllerState(u, 100 + i, 0), state, path, dt, sp,
                                 cp)[1].stats["min_cost"])
                 for u in (u_net, torch.zeros_like(u_net))]
        wins += first[0] <= first[1]
    training["fit_sampler"].update(loss_first=float(losses[0]), loss_last=float(losses[-1]),
                                   wins=wins)
    print(f"[23 learned sampler] diff_drive K=256 T=10, 96 states x 6 solves "
          f"({training['collect_imitation_data']['wall_s']:.2f} s), hidden 32, 300 steps "
          f"({training['fit_sampler']['wall_s']:.2f} s): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; the proposal won {wins} of 6 cold starts", flush=True)
    require(losses[-1] < 0.5 * losses[0] and wins >= 5, "the learned sampler")

    # the learned update rule: scripts/learning_eval.py:103-106's sizes
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=64, horizon=8, device=dev)
    rule, losses = timed("meta_train", lambda: meta_train(
        cfg, sp, cp, course, generator(0), num_steps=120, batch=32, iterations=2))
    vanilla = evaluate_rule(cfg, None, sp, cp, course, generator(1234), iterations=2)
    learned = evaluate_rule(cfg, rule, sp, cp, course, generator(1234), iterations=2)
    first20, last20 = float(losses[:20].mean()), float(losses[-20:].mean())
    training["meta_train"].update(loss_first20=first20, loss_last20=last20,
                                  vanilla=vanilla, learned=learned)
    print(f"[23 meta_train] diff_drive K=64 T=8, batch 32, 120 steps, 2 iterations "
          f"({training['meta_train']['wall_s']:.2f} s): mean loss of the first 20 steps "
          f"{first20:.4f}, of the last 20 {last20:.4f}; held-out realized cost vanilla "
          f"{vanilla:.4f}, learned {learned:.4f} on {card}", flush=True)
    require(last20 < first20 and learned < vanilla, "meta_train")
    print(json.dumps({"refine": refined, "training": training}))

    def entry(name, path_key, err_key, ms, plain_ms, bound):
        """One kernels entry; launches and launches_per_update are those of
        path_key's STEPS-cycle (or -tick) main-path run."""
        n = launches[path_key]
        require(n > 0 and n % STEPS == 0,
                f"{name}: {n} launches in its main path's {STEPS}-cycle run")
        bound_ms, which = bound
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                "launches": n, "launches_per_update": n // STEPS,
                "max_abs_err": max_abs_err[err_key], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes" if which == "bytes"
                else "operations", "library_ms": None}

    def bound(model, m2=False, k=K_MAIN, t=T_MAIN, b=1, two_pass=False):
        """rollout_cost_bound_ms at this run's shapes (R = T reference
        points, RNG mode); two-pass elite: the costs-only pass plus the
        costs-in pass."""
        if not two_pass:
            return rollout_cost_bound_ms(model, k, t, t, m2, num_robots=b)
        p1 = rollout_cost_bound_ms(model, k, t, t, False, accumulate=False)
        p2 = rollout_cost_bound_ms(model, k, t, t, m2, costs_in=True)
        return p1[0] + p2[0], max(p1, p2)[1]

    kernels = [
        entry(f"rollout_cost_{m}", m, m, med[f"{m}/kernel_alone"],
              med[f"{m}/plain_alone"], bound(m))
        for m in ("full_body", "unicycle", "steering_unicycle", "rate_limited_steering")
    ]
    # the same launch on the Gauss-Newton-refined loop's path (phase 22)
    kernels.append(entry("rollout_cost_full_body_refined_loop", "full_body_refined",
                         "full_body", med["full_body/kernel_alone"],
                         med["full_body/plain_alone"], bound("full_body")))
    kernels.append(entry(
        "rollout_cost_full_body_elite_two_pass", "full_body_elite", "full_body_elite",
        med["full_body/elite_pass1_alone"] + med["full_body/elite_pass2_alone"],
        med["full_body/elite_plain"], bound("full_body", two_pass=True)))
    kernels.append(entry(
        "rollout_cost_full_body_cost_threshold", "full_body_elite_stale",
        "full_body_stale",
        med["full_body/stale_kernel_alone"], med["full_body/stale_plain"],
        bound("full_body")))
    for m, key in (("full_body", "full_body_sigma"), ("unicycle", "unicycle_sigma")):
        kernels.append(entry(f"rollout_cost_{m}_second_moment", key, f"{m}_m2",
                             med[f"{m}/m2_alone"], med[f"{m}/m2_plain"],
                             bound(m, m2=True)))
    kernels.append(entry(
        "rollout_cost_full_body_second_moment_elite_two_pass", "full_body_sigma_elite",
        "full_body_m2_elite",
        med["full_body/elite_pass1_alone"] + med["full_body/m2_elite_pass2_alone"],
        med["full_body/m2_elite_plain"], bound("full_body", m2=True, two_pass=True)))
    kernels.append(entry(
        "rollout_cost_unicycle_second_moment_cost_threshold", "unicycle_sigma_elite_stale",
        "unicycle_m2_stale", med["unicycle/m2_stale_alone"], med["unicycle/m2_stale_plain"],
        bound("unicycle", m2=True)))
    for m in ("unicycle", "full_body"):
        kernels.append(entry(f"rollout_cost_{m}_fleet", f"{m}_fleet", f"{m}_fleet",
                             med[f"fleet/{m}/kernel_alone"], med[f"fleet/{m}/plain_alone"],
                             bound(m, k=K_FLEET, t=T_FLEET, b=B_FLEET)))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
