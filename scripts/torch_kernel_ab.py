#!/usr/bin/env python3
"""Times the PyTorch port's fused CUDA kernel (csrc/rollout_cost.cu) on one
NVIDIA card, at the shapes chip_smoke.py runs: each model's flagship
(K=102400, T=30, RNG mode), the second moment, two-pass elite, and the fleet
(B=256, K=1024, T=15). Each kernel arm is one launch of prepared operands
and its finish (``KernelLaunch.run`` then ``.finish``), so a checkout whose
finish runs as PyTorch ops and one whose kernel finishes the update itself
time the same work. Four arms time whole updates instead, full_body and
diff_drive at the flagship: the eager-lean ``mppi_step`` (no kernel, 10
calls a repetition), and for full_body the kernel-lean one (20 calls) and
the kernel-lean one refined by three Gauss-Newton steps (3 calls). CUDA
events over 50 calls unless stated, median of 9 repetitions. The
operands and the timing loop are chip_smoke.py's (kernel_case,
time_interleaved).

    python3 scripts/torch_kernel_ab.py sweep [--out FILE]
        every form and block size of the launch shape at each shape, each
        held once against the plain version; the shape launch_shape picks;
        the occupancy model against the CUDA occupancy calculator; the rows
        as JSON to FILE (default build/kernel_sweep.json)
    python3 scripts/torch_kernel_ab.py arms --repo DIR
        one JSON line of the arm times of the checkout at DIR, and the host
        time of one fused_sample_rollout_cost call (full_body, unicycle)
    python3 scripts/torch_kernel_ab.py ab PARENT CHANGE
        the arms of two checkouts in turns (parent, change, change, parent),
        one process each, on one card

Prints the card's name and power limit beside the numbers.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (the operands and the timing loop)

REPS, INNER = 9, 50


def card():
    return smoke.nvidia_smi("name,power.limit")


def case(preset, k, t, robots=None):
    """(model, the kernel's six leading arguments, scal) in RNG mode,
    full_body with roll_off=True."""
    c = smoke.kernel_case(preset, k, t, robots=robots, roll_off=True, seed=5)
    return c["model"], c["kargs"][:6], c["scal"]


def time_arms(arms):
    """{name: (median ms, min, max)} of arms {name: fn or (fn, calls a
    repetition)}, interleaved; a bare fn is called INNER times."""
    times = smoke.time_interleaved(
        {n: fn if isinstance(fn, tuple) else (fn, INNER) for n, fn in arms.items()}, REPS,
        warm=3)
    return {n: (statistics.median(v), min(v), max(v)) for n, v in times.items()}


def launch_arm(launch):
    def fn():
        launch.run()
        launch.finish()
    return fn


def update_arm(preset, use_kernel, **opts):
    """One lean mppi_step of the preset's flagship case, its warm start
    carried from call to call."""
    from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

    c = smoke.kernel_case(preset, smoke.K_MAIN, smoke.T_MAIN, roll_off=True, seed=5)
    carry = [ControllerState(c["u_prev"], 0, 0)]

    def fn():
        carry[0], _ = mppi_step(c["cfg"], carry[0], c["state"], c["path"], c["dt"], c["sp"],
                                c["cp"], model_params=c["mp"], use_kernel=use_kernel,
                                lean=True, **opts)
    return c["model"], fn


def build_arms():
    """The arms every checkout since the fleet grid can run."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import KernelLaunch
    from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import elite_threshold

    arms = {}
    for preset in smoke.PRESET_MODELS:
        model, kargs, scal = case(preset, smoke.K_MAIN, smoke.T_MAIN)
        kw = dict(seed=1, step=2, num_samples=smoke.K_MAIN, model=model)
        arms[f"{model}/kernel"] = launch_arm(KernelLaunch(*kargs, scal(), **kw))
        if model in ("full_body", "unicycle"):
            arms[f"{model}/second_moment"] = launch_arm(
                KernelLaunch(*kargs, scal(), second_moment=True, **kw))
            pass1 = KernelLaunch(*kargs, scal(), accumulate=False, **kw)
            pass1.run()
            thresh = elite_threshold(pass1.costs, smoke.ELITE)
            pass2 = KernelLaunch(*kargs, scal(thresh), costs_in=pass1.costs.clone(), **kw)

            def elite(pass1=pass1, pass2=pass2):
                pass1.run()
                pass2.run()
                pass2.finish()
            arms[f"{model}/elite_two_pass"] = elite
    for preset in ("diff_drive", "full_body"):
        model, kargs, scal = case(preset, smoke.K_FLEET, smoke.T_FLEET,
                                  robots=smoke.B_FLEET)
        arms[f"fleet/{model}/kernel"] = launch_arm(KernelLaunch(
            *kargs, scal(), seed=1, step=2, num_samples=smoke.K_FLEET, model=model))
        name, fn = update_arm(preset, False)
        arms[f"{name}/update_eager_lean"] = (fn, 10)
    arms["full_body/update_kernel_lean"] = (update_arm("full_body", True)[1], 20)
    arms["full_body/update_kernel_lean_gauss_newton"] = (update_arm(
        "full_body", True, refine_steps=3, refine_method="gauss_newton")[1], 3)
    return arms


def host_us():
    """{model: median microseconds of host clock per fused_sample_rollout_cost
    call}: INNER calls enqueued back to back (the card runs behind), REPS
    times, flagship shape, RNG mode."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
    )

    out = {}
    for preset in ("full_body", "diff_drive"):
        model, kargs, scal = case(preset, smoke.K_MAIN, smoke.T_MAIN)
        args, kw = kargs + (scal(),), dict(seed=1, step=2, num_samples=smoke.K_MAIN,
                                           model=model)
        for _ in range(3):
            fused_sample_rollout_cost(*args, **kw)
        reps = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(INNER):
                fused_sample_rollout_cost(*args, **kw)
            reps.append((time.perf_counter() - t0) / INNER * 1e6)
        torch.cuda.synchronize()
        out[model] = statistics.median(reps)
    return out


def cmd_arms(repo):
    sys.path.insert(0, str(Path(repo).resolve()))
    import torch

    import ccv_mppi_path_tracker_tpu_torch as port

    res = time_arms(build_arms())
    print(json.dumps({"repo": str(Path(port.__file__).resolve().parents[1]),
                      "device": torch.cuda.get_device_name(0), "card": card(),
                      "ms": res, "host_us": host_us()}), flush=True)


def cmd_ab(parent, change):
    runs = []
    for label, repo in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        out = subprocess.run([sys.executable, __file__, "arms", "--repo", repo],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            raise SystemExit(f"the {label} run failed ({out.returncode})")
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
        runs.append((label, json.loads(line)))
        print(f"[{label}] {line}", flush=True)
    print(f"parent, change, change, parent on {runs[0][1]['card']}; median ms of "
          f"{REPS} reps of {INNER} calls (a kernel and its finish) or of 3-20 updates:")
    for name in runs[0][1]["ms"]:
        cells = [f"{r['ms'][name][0]:.4f}" for _, r in runs]
        p = (runs[0][1]["ms"][name][0] + runs[3][1]["ms"][name][0]) / 2
        c = (runs[1][1]["ms"][name][0] + runs[2][1]["ms"][name][0]) / 2
        print(f"  {name}: {', '.join(cells)}; change/parent {c / p:.4f}")
    print(f"host clock per fused_sample_rollout_cost call, median us of {REPS} reps x "
          f"{INNER} calls:")
    for name in runs[0][1]["host_us"]:
        cells = [f"{r['host_us'][name]:.1f}" for _, r in runs]
        print(f"  {name}: {', '.join(cells)}")


def cmd_sweep(out):
    import torch

    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        KERNEL_MODELS,
        MAX_DYNAMIC_SMEM,
        MAX_THREADS,
        REGISTERS,
        KernelLaunch,
        fused_sample_rollout_cost_reference,
        instantiations,
        launch_shape,
        smem_bytes,
    )
    from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import elite_threshold

    _, seconds, log = build.build("rollout_cost")
    print(f"built in {seconds:.1f} s on {torch.cuda.get_device_name(0)}; {card()}")
    for (model, m2, form), p in sorted(instantiations(build.ptxas_summary(log or "")).items()):
        print(f"  ptxas {model} second_moment={m2} {form}: {p}")
    k_main, t_main = smoke.K_MAIN, smoke.T_MAIN
    cases = [(p, k_main, t_main, None, False) for p in smoke.PRESET_MODELS]
    cases += [("full_body", k_main, t_main, None, True),
              ("full_body", smoke.K_REF, smoke.T_REF, None, False),
              ("diff_drive", smoke.K_FLEET, smoke.T_FLEET, smoke.B_FLEET, False),
              ("full_body", smoke.K_FLEET, smoke.T_FLEET, smoke.B_FLEET, False)]
    rows = []
    for preset, k, t, b, m2 in cases:
        model, kargs, scal = case(preset, k, t, robots=b)
        kw = dict(seed=1, step=2, num_samples=k, model=model, second_moment=m2)
        ref = fused_sample_rollout_cost_reference(*kargs, scal(), **kw)
        u_ref = ref[1] / (ref[2] if b is None else ref[2][:, None, None])
        bound = smoke.u_bound(u_ref)
        arms, shapes = {}, {}
        for form in ("store", "regen"):
            for threads in range(32, MAX_THREADS + 1, 32):
                smem = smem_bytes(model, form, m2, True, threads, t, t)
                if smem > MAX_DYNAMIC_SMEM:
                    continue
                launch = KernelLaunch(*kargs, scal(), form=form, threads=threads, **kw)
                launch.run()
                res = launch.finish()
                torch.cuda.synchronize()
                u = res[0] / (res[1] if b is None else res[1][:, None, None])
                err = float((u - u_ref).abs().max())
                if not err <= bound:
                    raise SystemExit(f"{model} {form} {threads}: u_opt err {err} > {bound}")
                cuda_bps = launch.lib.rollout_cost_blocks_per_sm(
                    KERNEL_MODELS.index(model), form == "store", m2, threads, smem)
                shapes[(form, threads)] = (launch.shape, cuda_bps, err)
                arms[(form, threads)] = launch_arm(launch)
        timed = {f"{f}/{n}": fn for (f, n), fn in arms.items()}
        if not m2 and b is None:
            # the rollout alone (the costs-only pass), and the costs-in pass of
            # two-pass elite in both forms
            pass1 = KernelLaunch(*kargs, scal(), accumulate=False, **kw)
            pass1.run()
            costs = pass1.costs.clone()
            thresh = elite_threshold(costs, smoke.ELITE)
            for threads in range(32, MAX_THREADS + 1, 32):
                timed[f"costs_only/{threads}"] = launch_arm(KernelLaunch(
                    *kargs, scal(), accumulate=False, threads=threads, **kw))
                for form in ("store", "regen"):
                    if smem_bytes(model, form, False, True, threads, t, t) <= MAX_DYNAMIC_SMEM:
                        timed[f"costs_in_{form}/{threads}"] = launch_arm(KernelLaunch(
                            *kargs, scal(thresh), costs_in=costs, form=form,
                            threads=threads, **kw))
        res = time_arms(timed)
        pick = launch_shape(model, k, t, t, m2)
        print(f"{model} K={k} T={t} B={b or 1} second_moment={m2}: launch_shape picks "
              f"{pick.form}/{pick.threads}")
        for (form, threads), (shape, cuda_bps, err) in shapes.items():
            ms = res[f"{form}/{threads}"]
            print(f"  {form}/{threads}: {ms[0]:.4f} ms [{ms[1]:.4f}, {ms[2]:.4f}]; "
                  f"smem {shape.smem} B, blocks/SM model {shape.blocks_per_sm} CUDA "
                  f"{cuda_bps} (at {REGISTERS[model, form]} registers); "
                  f"u_opt err {err:.2e}", flush=True)
            rows.append(dict(model=model, k=k, t=t, b=b or 1, m2=m2, form=form,
                             threads=threads, ms=ms[0], blocks=shape.blocks,
                             bps=shape.blocks_per_sm, cuda_bps=cuda_bps,
                             pick=(pick.form, pick.threads) == (form, threads)))
        if not m2 and b is None:
            print(f"  launch_shape picks {launch_shape(model, k, t, t, accumulate=False)} "
                  f"for the costs-only pass, "
                  f"{launch_shape(model, k, t, t, costs_in=True)} for the costs-in pass")
        for name, ms in res.items():
            if name.startswith("costs_"):
                print(f"  {name}: {ms[0]:.4f} ms [{ms[1]:.4f}, {ms[2]:.4f}]", flush=True)
                form, threads = name.split("/")
                rows.append(dict(model=model, k=k, t=t, b=b or 1, m2=m2, form=form,
                                 threads=int(threads), ms=ms[0]))
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=0))
    print(f"wrote {out}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--out", default=str(ROOT / "build" / "kernel_sweep.json"))
    a = sub.add_parser("arms")
    a.add_argument("--repo", required=True)
    b = sub.add_parser("ab")
    b.add_argument("parent")
    b.add_argument("change")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    if args.cmd == "sweep":
        cmd_sweep(args.out)
    elif args.cmd == "arms":
        cmd_arms(args.repo)
    else:
        cmd_ab(args.parent, args.change)
    return 0


if __name__ == "__main__":
    sys.exit(main())
