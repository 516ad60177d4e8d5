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
the kernel-lean one refined by three Gauss-Newton steps (3 calls). The
draw arms time the eager arm's draw kernel (``philox_normals_cuda``, the
key on the card), a replay of a CUDA graph of 50 draws each, at (B, T-1,
K, U) = (1, 29, 102400, 5) (the flagship), (1, 29, 102400, 3), (256, 14,
1024, 2) (the fleet) and (64, 7, 64, 2) (meta_train's step), and
``torch.randn`` of the flagship's shape the same way, a different stream:
a yardstick only. An arm a checkout cannot run is reported absent. CUDA
events over 50 calls unless stated, median of 9 repetitions. The operands
and the timing loop are chip_smoke.py's (kernel_case, time_interleaved).

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
    python3 scripts/torch_kernel_ab.py sass [--out FILE]
        each kernel's SASS hot path (cuobjdump): the draw's instantiations
        and the issue floor at the draw arms' shapes; the fused kernel's 16
        instantiations with each loop weighted by its trips at the shape of
        each of PERF.md section 6's rows, and the issue floor there beside
        rollout_cost_bound_ms (the twin of scripts/roofline.py and
        scripts/kernel_floor.py)
    python3 scripts/torch_kernel_ab.py ablate [--out FILE]
        the fused kernel ablated with its own modes, full_body at K=102400
        T=30: RNG mode, noise input, no update, costs in, a short reference
        window (the twin of scripts/kernel_ablation.py)

sass and ablate write into FILE (default artifacts/kernel_floor_torch.json),
each under its own key.

Prints the card's name and power limit beside the numbers.
"""

import argparse
import bisect
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

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


# the draw arms: name -> (B, T-1, K, U)
DRAW_ARMS = {
    "draw/flagship": (1, smoke.T_MAIN - 1, smoke.K_MAIN, 5),
    "draw/u3": (1, smoke.T_MAIN - 1, smoke.K_MAIN, 3),
    "draw/fleet": (smoke.B_FLEET, smoke.T_FLEET - 1, smoke.K_FLEET, 2),
    "draw/meta_train": smoke.META_DRAW,
}


def draw_arms():
    """({name: replay}, {name: why absent}): a replay of one CUDA graph of
    INNER draws (chip_smoke.graph_replay: device time, no host enqueue) at
    each DRAW_ARMS shape, the key on the card (an arm whose capture raises
    is absent), and ``draw/randn``, INNER torch.randn of the flagship's
    shape."""
    import torch

    arms, absent = {}, {}
    try:
        from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import philox_normals_cuda
    except ImportError as e:
        return arms, {name: f"ImportError: {e}" for name in DRAW_ARMS}
    key = torch.tensor([1, 2], dtype=torch.int64, device="cuda")
    for name, (b, tm1, k, u_dim) in DRAW_ARMS.items():
        fn = functools.partial(philox_normals_cuda, key, num_samples=k, tm1=tm1,
                               u_dim=u_dim, robots=b)
        try:
            arms[name] = smoke.graph_replay(fn, INNER)
        except (RuntimeError, ValueError, TypeError) as e:
            absent[name] = f"{type(e).__name__}: {e}"
    b, tm1, k, u_dim = DRAW_ARMS["draw/flagship"]
    arms["draw/randn"] = smoke.graph_replay(
        lambda: torch.randn((tm1, k, u_dim), device="cuda"), INNER)
    return arms, absent


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

    arms = build_arms()
    draws, absent = draw_arms()
    res = time_arms({**arms, **{name: (replay, 1) for name, replay in draws.items()}})
    for name in draws:  # a replay is INNER draws
        res[name] = tuple(v / INNER for v in res[name])
    print(json.dumps({"repo": str(Path(port.__file__).resolve().parents[1]),
                      "device": torch.cuda.get_device_name(0), "card": card(),
                      "ms": res, "absent": absent, "host_us": host_us()}), flush=True)


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
          f"{REPS} reps of {INNER} calls (a kernel and its finish, a draw) or of 3-20 "
          f"updates:")
    names = list(dict.fromkeys(n for _, r in runs for n in r["ms"]))
    for name in names:
        cells = [f"{r['ms'][name][0]:.4f}" if name in r["ms"] else "absent"
                 for _, r in runs]
        ratio = "no ratio: an arm is absent"
        if all(name in r["ms"] for _, r in runs):
            p = (runs[0][1]["ms"][name][0] + runs[3][1]["ms"][name][0]) / 2
            c = (runs[1][1]["ms"][name][0] + runs[2][1]["ms"][name][0]) / 2
            ratio = f"change/parent {c / p:.4f}"
        print(f"  {name}: {', '.join(cells)}; {ratio}")
    for label, r in runs:
        for name, why in r.get("absent", {}).items():
            print(f"  absent in the {label} run: {name} ({why})")
    print(f"host clock per fused_sample_rollout_cost call, median us of {REPS} reps x "
          f"{INNER} calls:")
    for name in runs[0][1]["host_us"]:
        cells = [f"{r['host_us'][name]:.1f}" for _, r in runs]
        print(f"  {name}: {', '.join(cells)}")


SLOW_PATH = re.compile(r"\b(LDL|STL|DMUL|CALL)\b")
# the Philox multipliers 0xD2511F53 and 0xCD9E8D57 as SASS prints them
PHILOX = re.compile(r"-0x(2daee0ad|326172a9)\b")
# what an unrolled block of the reference scan holds (csrc path_d2: four
# float4 rows loaded, two FMAs and a min each)
SCAN_BLOCK = re.compile(r"^(@!?U?P\d+\s+)?(LDS\.128|FFMA|FMNMX|ISETP|BRA|ULEA|UIADD3|IADD3|"
                        r"VIADD|MOV|IMAD\.MOV|UMOV|NOP)\b")


def sass_instructions(sass_fn):
    """[(address, instruction)] of one function's cuobjdump -sass text."""
    return [(int(m.group(1), 16), m.group(2).strip()) for line in sass_fn.splitlines()
            for m in [re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)] if m]


def branch_target(op):
    m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", op)
    return int(m.group(1), 16) if m else None


def skipped_spans(ins, also=None):
    """The addresses that a forward predicated branch skips, where the span
    is short (under 120) and holds local memory, a double or a call (the
    libm slow paths: sinf/cosf's Payne-Hanek reduction, sqrtf's rare case),
    or where ``also(span)`` says the measured arm does not run it."""
    addrs = [a for a, _ in ins]
    skip = set()
    for i, (addr, op) in enumerate(ins):
        target = branch_target(op)
        if target is None or target <= addr or not re.match(r"@!?P\d", op):
            continue
        span = ins[i + 1:bisect.bisect_left(addrs, target)]
        ops = [o for _, o in span]
        if (len(span) < 120 and any(SLOW_PATH.search(o) for o in ops)) or (
                also is not None and also(ops)):
            skip.update(a for a, _ in span)
    return skip


class Loop(NamedTuple):
    """A loop of the SASS: from a backward branch's target to the branch."""

    start: int
    end: int
    own: tuple      # its instructions outside its nested loops and skipped spans
    nested: tuple   # every loop inside it (Loop), outermost first
    parent: Optional[int]  # the start of the loop directly around it, or None


def sass_loops(ins, skip=frozenset()):
    """[Loop] of a function, one for each backward branch, outermost first."""
    spans = sorted({(t, a) for a, o in ins for t in [branch_target(o)]
                    if t is not None and t < a}, key=lambda se: (se[0], -se[1]))

    def inside(inner, outer):
        return outer[0] <= inner[0] and inner[1] <= outer[1] and inner != outer

    loops = {}
    for span in reversed(spans):  # innermost first
        nested = [loops[o] for o in spans if inside(o, span) and o in loops]
        own = tuple(o for a, o in ins if span[0] <= a <= span[1] and a not in skip
                    and not any(n.start <= a <= n.end for n in nested))
        around = [o for o in spans if inside(span, o)]
        parent = max(around, key=lambda o: (o[0], -o[1]))[0] if around else None
        loops[span] = Loop(span[0], span[1], own,
                           tuple(sorted(nested, key=lambda lp: (lp.start, -lp.end))), parent)
    return [loops[s] for s in spans]


def hot_path(sass_fn, trips=None, also_skip=None, until=None):
    """(SASS instructions, instructions on the hot path) of one kernel
    (cuobjdump -sass text): a thread's instructions when no slow path is
    taken (:func:`skipped_spans`), up to the last EXIT, or up to the first
    instruction that matches ``until`` (the fused kernel's finish, which one
    block a group runs). Without ``trips`` a loop's body counts once (the
    draw kernel, whose loops are its slow paths). With ``trips`` each
    instruction counts the product of ``trips(loop)`` over the loops around
    it (:func:`sass_loops`; ``trips(loop, loops)``, every loop given), which
    weights each loop body by its trip count at the measured shape."""
    ins = sass_instructions(sass_fn)
    skip = skipped_spans(ins, also_skip)
    if until is None:
        last = max(a for a, o in ins if re.search(r"\bEXIT\b", o)) + 1
    else:
        last = min(a for a, o in ins if re.search(until, o))
    weight = {a: 1 for a, _ in ins if a < last and a not in skip}
    if trips is not None:
        loops = sass_loops(ins, skip)
        for loop in loops:
            t = trips(loop, loops)
            for a in weight:
                if loop.start <= a <= loop.end:
                    weight[a] *= t
    return len(ins), sum(weight.values())


def _count(ops, pattern):
    return sum(1 for o in ops if re.search(pattern, o))


def is_scan(loop):
    """The reference scan's loop (csrc path_d2), unrolled: float4 rows
    loaded from shared memory and a running min, no draw."""
    return (_count(loop.own, r"\bLDS\.128\b") > 0 and _count(loop.own, r"\bFMNMX\b") > 0
            and not _count(loop.own, PHILOX.pattern))


def fused_trips(model, horizon, num_ref, threads, accumulate=True, costs_in=False):
    """(trips, also_skip) of the fused kernel at one arm's shape, RNG mode,
    for :func:`hot_path`, by what each loop of the SASS holds:

    - the reference scan (:func:`is_scan`): the padded reference rows over
      the rows an iteration loads (one LDS.128 a row), shared greedily among
      the scan loops beside it (the unrolled loop, then its remainder loop);
      its unrolled remainder blocks (forward spans of scan instructions
      only) skipped where the rows are a multiple of the unrolled loop's;
    - the step loop (a loop around a scan): T-1 steps (T-2 for full_body);
    - a loop that draws (the Philox multipliers) with warp shuffles: the
      regenerate form's update over T-1 rows; one that draws without them:
      the store form's costs-in pass over T-1 rows (0 in other passes);
    - the store form's update columns (LDS.128 and scalar LDS, no min): the
      threads over the samples an iteration reads (4 a float4 of weights),
      inside a column loop of (nu + 1) / threads columns a thread; the
      normalizer's column (float4 loads only) runs in one thread a block: 0;
    - every other loop (shared-memory copies, the block minimum over its
      warps) once.
    The costs-in pass runs no rollout: its step and scan loops 0.
    ``also_skip`` skips the noise-input loads (RNG mode) and the scan's
    remainder blocks as above."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import pad_ref_count
    from ccv_mppi_path_tracker_tpu_torch.models import get_model

    tm1 = horizon - 1
    steps = horizon - 2 if model == "full_body" else tm1
    rows = pad_ref_count(num_ref)
    nu = tm1 * get_model(model).num_controls

    def scan_trips(loop, loops):
        group = sorted((lp for lp in loops if is_scan(lp) and lp.parent == loop.parent),
                       key=lambda lp: -_count(lp.own, r"\bLDS\.128\b"))
        left = rows
        for lp in group:
            per = _count(lp.own, r"\bLDS\.128\b")
            n = left // per
            if lp == loop:
                return n
            left -= n * per
        return 0

    def trips(loop, loops):
        if is_scan(loop):
            return 0 if costs_in else scan_trips(loop, loops)
        if any(is_scan(lp) for lp in loop.nested):
            return 0 if costs_in else steps
        if _count(loop.own, PHILOX.pattern):
            if _count(loop.own, r"\bSHFL\b"):
                return tm1 if accumulate else 0
            return tm1 if costs_in else 0
        lds128 = _count(loop.own, r"\bLDS\.128\b")
        if lds128 and loop.nested:
            return -(-(nu + 1) // threads)
        if lds128 and loop.parent is not None:
            scalar = _count(loop.own, r"\bLDS\b(?!\.128)")
            return threads // (4 * lds128) if scalar else 0
        return 1

    def also_skip(ops):
        if all(SCAN_BLOCK.match(o) for o in ops):
            return _count(ops, r"\bLDS\.128\b") > 0 and (rows // 4) % 4 == 0
        return bool(len(ops) < 120 and _count(ops, r"\bLDG\b")
                    and not _count(ops, PHILOX.pattern) and not _count(ops, r"\bMUFU\b"))

    return trips, also_skip


# the fused kernel's rows of PERF.md section 6, RNG mode, R = T reference
# points: name -> (model, K, T, B, second moment, passes); a pass is
# (accumulate, costs_in), two-pass elite the costs-only pass then the
# costs-in pass. The cost threshold, first_sample and device-key rows run
# the flagship full_body launch.
FUSED_ROWS = {
    "full_body": ("full_body", smoke.K_MAIN, smoke.T_MAIN, 1, False, ((True, False),)),
    "unicycle": ("unicycle", smoke.K_MAIN, smoke.T_MAIN, 1, False, ((True, False),)),
    "steering_unicycle": ("steering_unicycle", smoke.K_MAIN, smoke.T_MAIN, 1, False,
                          ((True, False),)),
    "rate_limited_steering": ("rate_limited_steering", smoke.K_MAIN, smoke.T_MAIN, 1, False,
                              ((True, False),)),
    "full_body_elite_two_pass": ("full_body", smoke.K_MAIN, smoke.T_MAIN, 1, False,
                                 ((False, False), (True, True))),
    "full_body_second_moment": ("full_body", smoke.K_MAIN, smoke.T_MAIN, 1, True,
                                ((True, False),)),
    "unicycle_second_moment": ("unicycle", smoke.K_MAIN, smoke.T_MAIN, 1, True,
                               ((True, False),)),
    "full_body_second_moment_elite_two_pass": ("full_body", smoke.K_MAIN, smoke.T_MAIN, 1,
                                               True, ((False, False), (True, True))),
    "full_body_fleet": ("full_body", smoke.K_FLEET, smoke.T_FLEET, smoke.B_FLEET, False,
                        ((True, False),)),
    "unicycle_fleet": ("unicycle", smoke.K_FLEET, smoke.T_FLEET, smoke.B_FLEET, False,
                       ((True, False),)),
}
ISSUE_RATE = 4  # warp instructions a clock an SM (four schedulers)


def fused_floor(fns, model, k, t, b, m2, accumulate, costs_in, num_ref=None, sms=132,
                mhz=1980.0):
    """One launch's loop-weighted SASS count and issue floor: (instructions
    a sample, floor ms, the launch shape), the instantiation's SASS in
    ``fns`` {(model, second_moment, store form): text}; the count stops at
    the finish's first ticket (the costs-only pass: at its early EXIT)."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import launch_shape

    num_ref = num_ref or t
    m2 = m2 and accumulate
    shape = launch_shape(model, k, t, num_ref, m2, accumulate, costs_in)
    trips, also_skip = fused_trips(model, t, num_ref, shape.threads, accumulate, costs_in)
    until = r"\bATOM" if accumulate else r"@!?P\d+\s+EXIT"
    _, per_sample = hot_path(fns[model, m2, shape.form == "store"], trips, also_skip, until)
    warps = b * shape.blocks * shape.threads // 32
    return per_sample, warps * per_sample / (ISSUE_RATE * sms * mhz * 1e6) * 1e3, shape


def write_record(out, key, value):
    """Sets ``key`` of the JSON object in ``out`` (both subcommands write one
    file)."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    record = json.loads(out.read_text()) if out.exists() else {}
    record[key] = value
    out.write_text(json.dumps(record, indent=1))


def cmd_sass(out):
    """Each kernel's SASS count and hot path (:func:`hot_path`): the draw's
    instantiations with a loop body once, at each DRAW_ARMS shape the issue
    floor, ceil(rows / 32) warps times the hot path over ISSUE_RATE warp
    instructions a clock on every SM at the card's maximum SM clock, beside
    philox_normals_bound_ms; the fused kernel's instantiations with each
    loop weighted by its trips (:func:`fused_trips`), at each FUSED_ROWS
    shape the instructions a sample and the issue floor, warps (B x blocks x
    threads / 32) times those, beside rollout_cost_bound_ms. Writes both
    into ``out`` under "sass"."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        KERNEL_MODELS,
        philox_draw_geometry,
        philox_normals_bound_ms,
        rollout_cost_bound_ms,
    )

    path, _, _ = build.build("rollout_cost")
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    draw, fused = {}, {}
    for chunk in sass.split("Function : ")[1:]:
        m = re.match(r"\S*philox_normals_kernelILi(\d+)ELb([01])E", chunk)
        if m:
            draw[int(m.group(1)), m.group(2) == "1"] = hot_path(chunk)
        m = re.match(r"\S*rollout_cost_kernelILi(\d)ELb([01])ELb([01])E", chunk)
        if m:
            fused[KERNEL_MODELS[int(m.group(1))], m.group(2) == "1",
                  m.group(3) == "1"] = chunk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smoke.nvidia_smi("clocks.max.sm").split()[0])
    rec = {"card": card(), "sms": sms, "max_sm_mhz": mhz, "issue_rate": ISSUE_RATE,
           "draw": [], "fused": []}
    print(f"{card()}; {sms} SMs, maximum SM clock {mhz:.0f} MHz")
    for (u_dim, wide), (n, h) in sorted(draw.items()):
        print(f"  philox_normals_kernel<{u_dim}, {str(wide).lower()}>: {n} SASS "
              f"instructions, {h} on the hot path")
    for name, (b, tm1, k, u_dim) in DRAW_ARMS.items():
        geo = philox_draw_geometry(b, tm1, k, u_dim)
        warps = -(-geo.rows // 32)
        hot = draw[geo.unrolled_u, bool(geo.wide)][1]
        floor = warps * hot / (ISSUE_RATE * sms * mhz * 1e6) * 1e3
        bound, which = philox_normals_bound_ms(k, tm1, u_dim, b)
        print(f"  {name} (B, T-1, K, U) = {(b, tm1, k, u_dim)}: issue floor {floor:.4f} ms; "
              f"bound {bound:.4f} ms ({which})")
        rec["draw"].append(dict(name=name, shape=[b, tm1, k, u_dim], hot_per_row=hot,
                                issue_floor_ms=floor, bound_ms=bound, bound_by=which))
    for (model, m2, store), chunk in sorted(fused.items()):
        print(f"  rollout_cost_kernel<{model}, second_moment={m2}, "
              f"{'store' if store else 'regen'}>: {len(sass_instructions(chunk))} SASS "
              f"instructions")
    for name, (model, k, t, b, m2, passes) in FUSED_ROWS.items():
        per, floor, bound, shapes = [], 0.0, 0.0, []
        for accumulate, costs_in in passes:
            n, ms, shape = fused_floor(fused, model, k, t, b, m2, accumulate, costs_in,
                                       sms=sms, mhz=mhz)
            per.append(n)
            floor += ms
            bound += rollout_cost_bound_ms(model, k, t, t, m2 and accumulate, num_robots=b,
                                           accumulate=accumulate, costs_in=costs_in)[0]
            shapes.append(f"{shape.form}/{shape.threads}")
        which = rollout_cost_bound_ms(model, k, t, t, m2, num_robots=b)[1]
        print(f"  {name} K={k} T={t} B={b} ({' + '.join(shapes)}): "
              f"{' + '.join(str(n) for n in per)} instructions a sample, issue floor "
              f"{floor:.4f} ms; rollout_cost_bound_ms {bound:.4f} ms ({which}), "
              f"floor/bound {floor / bound:.2f}", flush=True)
        rec["fused"].append(dict(name=name, model=model, k=k, t=t, b=b, second_moment=m2,
                                 passes=[list(pa) for pa in passes], shapes=shapes,
                                 instructions_per_sample=per, issue_floor_ms=floor,
                                 bound_ms=bound, bound_by=which))
    write_record(out, "sass", rec)


# the ablation's arms: name -> the launch's options against the flagship
# full_body launch in RNG mode
ABLATE_ARMS = ("base", "noise_in", "no_update", "costs_in", "short_ref")
SHORT_REF = 4


def cmd_ablate(out):
    """The fused kernel ablated with its own modes, full_body at K=102400,
    T=30: each arm a replayed CUDA graph of INNER launches
    (chip_smoke.graph_replay), the arms in turns, median of REPS: ``base``
    (RNG mode), ``noise_in`` (the normals read instead of drawn: the gap to
    base is the draw less that read, whose bytes over the HBM rate are
    printed beside it), ``no_update`` (the costs-only pass: accumulate=False),
    ``costs_in`` (the draw and the update, no rollout or cost), ``short_ref``
    (a window of SHORT_REF reference points against the flagship's T: the
    scan's share). Each arm beside its loop-weighted issue floor and its
    rollout_cost_bound_ms. Writes into ``out`` under "ablate"."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        HBM_BYTES_PER_S,
        KERNEL_MODELS,
        KernelLaunch,
        rollout_cost_bound_ms,
    )

    k, t = smoke.K_MAIN, smoke.T_MAIN
    c = smoke.kernel_case("full_body", k, t, roll_off=True, seed=5)
    kargs, scal = c["kargs"][:6], c["scal"]
    kw = dict(seed=1, step=2, num_samples=k, model="full_body")
    costs = KernelLaunch(*kargs, scal(), accumulate=False, **kw)
    costs.run()
    ref4 = kargs[4][:SHORT_REF].contiguous()
    launches = {
        "base": KernelLaunch(*kargs, scal(), **kw),
        "noise_in": KernelLaunch(*kargs, scal(), noise=c["noise"],
                                 **dict(kw, seed=None, step=None)),
        "no_update": KernelLaunch(*kargs, scal(), accumulate=False, **kw),
        "costs_in": KernelLaunch(*kargs, scal(), costs_in=costs.costs.clone(), **kw),
        "short_ref": KernelLaunch(*kargs[:4], ref4, kargs[5], scal(), **kw),
    }
    arms = {name: smoke.graph_replay(launch_arm(launch), INNER)
            for name, launch in launches.items()}
    res = time_arms({name: (replay, 1) for name, replay in arms.items()})
    ms = {name: res[name][0] / INNER for name in ABLATE_ARMS}

    path, _, _ = build.build("rollout_cost")
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    fused = {}
    for chunk in sass.split("Function : ")[1:]:
        m = re.match(r"\S*rollout_cost_kernelILi(\d)ELb([01])ELb([01])E", chunk)
        if m:
            fused[KERNEL_MODELS[int(m.group(1))], m.group(2) == "1",
                  m.group(3) == "1"] = chunk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smoke.nvidia_smi("clocks.max.sm").split()[0])
    opts = {"base": {}, "noise_in": {"rng": False}, "no_update": {"accumulate": False},
            "costs_in": {"costs_in": True}, "short_ref": {"num_ref": SHORT_REF}}
    rows = {}
    print(f"{card()}; full_body K={k} T={t}, a replayed graph of {INNER} launches, median "
          f"of {REPS} in turns:")
    for name in ABLATE_ARMS:
        o = opts[name]
        acc, cin = o.get("accumulate", True), o.get("costs_in", False)
        floor = None
        if o.get("rng", True):  # the loop weighting counts the RNG mode's path
            _, floor, _ = fused_floor(fused, "full_body", k, t, 1, False, acc, cin,
                                      num_ref=o.get("num_ref"), sms=sms, mhz=mhz)
        bound, which = rollout_cost_bound_ms("full_body", k, t, o.get("num_ref", t),
                                             rng=o.get("rng", True), accumulate=acc,
                                             costs_in=cin)
        shape = launches[name].shape
        rows[name] = dict(ms=ms[name], ms_min=res[name][1] / INNER,
                          ms_max=res[name][2] / INNER, issue_floor_ms=floor,
                          bound_ms=bound, bound_by=which,
                          shape=f"{shape.form}/{shape.threads}")
        fl = "not counted (noise-input path)" if floor is None else f"{floor:.4f} ms"
        print(f"  {name} ({shape.form}/{shape.threads}): {ms[name]:.4f} ms "
              f"[{rows[name]['ms_min']:.4f}, {rows[name]['ms_max']:.4f}]; issue floor {fl}; "
              f"bound {bound:.4f} ms ({which})", flush=True)
    noise_read_ms = c["noise"].numel() * 4 / HBM_BYTES_PER_S * 1e3
    derived = {
        "draw_less_noise_read": ms["base"] - ms["noise_in"],
        "noise_read_at_hbm_rate": noise_read_ms,
        "update": ms["base"] - ms["no_update"],
        "rollout_and_cost": ms["base"] - ms["costs_in"],
        "scan_of_the_rows_past_4": ms["base"] - ms["short_ref"],
    }
    for name, v in derived.items():
        print(f"  {name}: {v:.4f} ms ({100 * v / ms['base']:.1f} % of base)")
    write_record(out, "ablate", {"card": card(), "model": "full_body", "k": k, "t": t,
                                 "short_ref": SHORT_REF, "inner": INNER, "reps": REPS,
                                 "arms": rows, "derived_ms": derived})


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
    for name in ("sass", "ablate"):
        c = sub.add_parser(name)
        c.add_argument("--out", default=str(ROOT / "artifacts" / "kernel_floor_torch.json"))
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
    elif args.cmd == "sass":
        cmd_sass(args.out)
    elif args.cmd == "ablate":
        cmd_ablate(args.out)
    else:
        cmd_ab(args.parent, args.change)
    return 0


if __name__ == "__main__":
    sys.exit(main())
