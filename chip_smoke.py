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
     without each refinement, the Gauss-Newton one under the 100 ms period.
     On the card the refine stage is a CUDA graph's replay
     (utils/cuda_graph.py): held against the eager stage (float64 rtol
     1e-8), and both timed;
 23. the training side on the card at the JAX package's script sizes: the
     sysid command (gains within rtol 1e-3), fit_full_body_params (base2com
     within 2 %), the chunked rollout gradient (num_chunks 1, 4, 8 equal at
     float64), collect_imitation_data + fit_sampler (the loss halves, the
     proposal wins 5 of 6 cold starts), meta_train (the loss falls, the rule
     beats vanilla on held-out poses); the wall time of each;
 24. the sample offset (the Philox counter's first_sample), every model at
     K=102400 T=30: the kernel at first_sample != 0 vs its plain version, and
     two launches of K/2 at first_sample 0 and K/2 bit-equal to one launch of
     K; CUDA-event times at offset 0, at the offset, and of one shard;
 25. the sharded step (parallel/): world size 1 over NCCL, full_body at the
     flagship, kernel and eager, vanilla, elite 0.1 and adapt_sigma, each
     bit-equal to mppi_step and free of host syncs; world size 2, two
     processes of scripts/torch_multiprocess_worker.py over gloo sharing the
     card: the shards' costs bit-equal to one launch, u_opt within the kernel
     gate of the one-card update, min_cost equal, the elite threshold
     bit-equal, a 200-cycle sharded loop (RMSE < 0.15 m, 200 launches a rank);
     the sharded update's time beside the unsharded one;
 26. use_kernel="auto": kernel-lean vs eager-lean updates, K 16 ... 102400 x T
     5, 15, 30, every model; at every point the arm auto picks
     (kernels/rollout_cost.py should_use_kernel) must be the faster or within
     10 % of it; the crossover the grid implies is printed; `run` with no flag
     at the flagship takes the kernel; examples/custom_model_torch.py on the
     card (auto: eager, no launch; RMSE < 0.15 m);
 27. export: the exported full_body flagship step against the kernel path at
     the same seed and step (kernel gate) and the eager step on the same
     Philox normals (rtol 1e-5); the `export` command;
 28. profile: the `profile` command's trace holds one rollout_cost kernel
     event per traced step (and the launch count adds the warm step);
     simulate(with_paths=True) logs on the card, eager with candidates and
     kernel, finite; no figure (the card's machine has no matplotlib);
 29. the benchmark (benchmark/): each workload of BENCHMARK.json once,
     `python3 -m benchmark --workload W --seed 0 --seconds 2 --trace 0`, each
     in a process of its own; its last line correct, 0 failed and every
     metric finite, one line a cell printed;
 30. the compiled paths (utils/cuda_graph.py, the counterparts of jax.jit
     and lax.scan): the kernel with its (seed, step) key read from device
     memory, bit-equal to the by-value key (every model, both elite passes,
     the second moment, the fleet, first_sample) and within the kernel gate
     of its plain version with the same key tensor; compile_step over 50
     chained updates against op-by-op mppi_step (full_body, unicycle, elite,
     Gauss-Newton refined: bit-equality printed, the u_opt gate required),
     one capture each, replays counted as launches, the key [seed, step];
     no host sync in a replay of the step, the ControlLoop cycle, the fleet
     tick and the graphed loop; the graphed loop (RMSE < 0.15 m), fleet
     (every robot within 0.3 m), paced ControlLoop at 10 Hz (0 misses) and
     pipelined M=8 window (0 misses); CUDA-event and host times of the
     op-by-op and graphed arms in turns (updates, the loop, the fleet tick,
     the serving cycle, the window's enqueue) and the graphed update's busy
     share;
 31. the eager arm's compiled programs: the draw kernel
     (kernels/rollout_cost.py philox_normals_cuda, the eager step's keyed
     normals) against its plain version core/random.py philox_normals on the
     card (max abs err <= 1e-5; the flagship, U=3, the fleet, first_sample
     K/2, meta_train's (64, 7, 64, 2), U=1, U=4, the generic U=7, K=1000,
     T-1 = 70001, and 2^31 + 2 rows on slices; by value and by the device key
     bit-equal), the fused kernel fed the draw bit-equal to its own RNG mode
     for every preset model, each draw instantiation's ptxas report and the
     fused kernel's registers unchanged; the eager RNG-mode update against
     the kernel's, every model, within the kernel gate; compile_step(
     use_kernel=False) over 50 chained updates against op by op (full_body,
     unicycle, elite 0.1, adapt_sigma, the custom bicycle through
     MPPISolver(use_kernel="auto")), one capture each, no host sync in a
     replay, and the refusal of a user model whose step reads the card back;
     the graphed eager 200-cycle loop (RMSE < 0.15 m), fleet over 200 ticks
     (every robot within 0.3 m) and pipelined M=8 window (0 misses), exact
     draw launches; op-by-op and graphed eager timings in turns, host us,
     launches, busy share, the draw against its bound and torch.randn's time
     (a different stream: a yardstick), the draw at meta_train's (64, 7, 64,
     2) as a graph's replay, and the eager update's peak memory.

 32. the reference's evaluations (scripts/torch_quality_matrix.py and
     scripts/torch_realtime_session.py): the three quick-matrix cells of
     tests/test_quality_matrix.py on the kernel (K=256) with their gates
     against pure pursuit and one launch a cycle, the refined arm's cycle
     captured once over two seeds; pure pursuit's graphed scan bit-equal to
     its cycle run op by op on the card, one capture; the robustness twins
     (500 cycles, the course end, the dkan corridor, 50 dt-jittered
     ControlLoop cycles with one capture); the session's device arm at 500
     Hz for 2 s (full_body K=102400 T=30: 1000 cycles of one graph, 1000
     launches), the host loop at 10 Hz and the pipelined loop at 25 Hz for
     2 s each; the phase's time.
 33. the differentiable side's compiled programs (diff/optim.py: one Adam
     step scanned as a CUDA graph): fit_control_gains (the sysid data, 300
     steps), fit_full_body_params (500), the chunked rollout gradient
     (num_chunks 1, 4, 8), fit_sampler (300), meta_train (120) and
     evaluate_rule, float32, each run eagerly (utils/cuda_graph.scan) and
     graphed (Graphed.scan) in turns: wall ms of each, one capture a
     program, the graphed outputs within rtol 1e-5 of the eager ones (bit
     equality printed), no host sync in a replay, the draw kernel's launches
     through meta_train's replays (one a step); phase 23's gates on the
     graphed results (gains within rtol 1e-3, the sampler loss halved and 5
     of 6 cold-start wins, meta_train's last 20 steps below its first 20
     and the learned rule below vanilla); one graphed meta_train step at the
     fleet width (diff_drive K=1024 T=15, batch 32), its ms and memory; and
     scripts/torch_learning_eval.py --quick, every claim pointing the JAX
     artifact's way.
 34. the sample-sharded programs compiled over NCCL at world size 1 (the
     counterparts of the JAX package's jax.jit of shard_map): captures of a
     collective in torch's default mode with eager collectives outstanding;
     the sharded
     step, full_body at K=102400 T=30, kernel and eager, vanilla, elite 0.1
     and adapt_sigma, bit-equal to the op-by-op sharded step and to
     compile_step without a group, one capture an option set, launches
     counted a replay, no host sync in a replay, its CUDA-event time in
     turns against both; the graphed sharded 200-cycle loop (200 launches
     in 200 replays, bit-equal to op by op, RMSE < 0.15 m) and its cycle's
     time; the system-ID fits and the chunked gradient (num_chunks 1, 4, 8)
     with the group, graphed against op by op in turns, bit-equal;
     scripts/torch_multihost_demo.py --kernel at K=131072 T=30 (RMSE < 0.15
     m); the fleet command's plant captured once (its RMSE line phase 14's);
     scripts/torch_make_figures.py's runs (the ten PNGs where matplotlib is
     installed; the runs are kept in build/figure_runs_torch.npz).
 35. fleets past 65535 robots (kernels/rollout_cost.py fleet_chunks): the
     kernel arm at B = 131071 (unicycle K=64 T=10, RNG mode) in three
     launches at their robot offsets, called eagerly and as the fleet tick's
     replay: robots 0, 65534, 65535, 65536, 131070 bit-equal to their own
     launches at robot=b, the fleet within the kernel gate of the plain
     version, three launches a tick, the tick's ms beside the B = 65535
     tick's; the eager arm at B = 65536 (its draw's robot 65535 bit-equal to
     the draw of robot 65535 alone); scripts/torch_eager_breakdown.py
     --quick and scripts/torch_kernel_ab.py sass (both kernels' issue
     floors), each in a process of its own.
 36. the refine stage's kernel (kernels/gauss_newton.py, csrc/gauss_newton.cu):
     its build and ptxas report; against the op-by-op stage on the card at
     T=30 on 30 inputs (28 seeded sampled updates, half with roll_off, and
     the zero warm start of two), the accept pattern of the 3 steps, the
     counters and max |du| over the box width; an input with a NaN and one
     with a non-positive pivot, every step rejected; the dispatch of
     gauss_newton_refine launching it; one launch a replayed refined update
     (and the device ops from the fused kernel's end by torch.profiler);
     CUDA-event times in turns of the kernel, the plain stage as a graph, the
     refined update with either, the unrefined update, beside
     benchmark/work_refine.py bound_us(30, 5, 3).
 37. the control step's prologue (kernels/step_prologue.py, csrc/rollout_cost.cu
     step_prologue) against the op-by-op glue it replaces, bit for bit on every
     output (window, yaw, centred rows and state, scalars, next key; tickets
     zero), for every model on 32 poses of the benchmark's course (beyond
     DIST_CAP, the course's end, an exact tie, roomy paths) and fleets of 256
     on shared and per-robot paths; compiled updates with either prologue
     chained bit for bit (lean, two-pass and stale elite, Gauss-Newton
     refined, the fleet tick); one launch and the counters a replay; the
     replayed flagship update's ms and device ops with either;
 38. the eager update's network rollout and cost (kernels/network_rollout.py,
     csrc/network_rollout.cu): its build and ptxas report; the costs against
     the plain version (models/autorally_nn.py cost(rollout(...))) at
     K=102400 T=30 and a ragged K=1000 T=15, the counters model.nn_evals and
     model.nn_fused; the dispatch launching on the cell's shape and not under
     float64, grad, vmap or distinct start states; compiled updates on the
     cell's inputs within 1e-6 of the box of op-by-op ones with the plain
     rollout; weights changed in place between replays reaching the kernel;
     one launch a replay; CUDA-event times of the kernel, the plain version
     and the update with either, the kernel beside work_nn's bound;
 39. PETS's probabilistic ensemble (models/pets_pe.py) at K=5120, P=20, T=30
     through compile_step(use_kernel="auto", lean=True): chained updates, the
     capture and replays of one graph, within the cell's u_gap limit of
     benchmark/reference_pe.py; each replay's particles drawn anew (far from
     a reference whose particles keep step 0's normals); model.pe_evals
     K·P·(T-1) an update; the memory peak; CUDA-event ms, device ops and the
     float32 peak's share of an update;
 40. the eager update's PETS ensemble rollout (kernels/pets_rollout.py,
     csrc/pets_rollout.cu): its build and ptxas report; each particle's cost
     against the op-by-op version (models/pets_pe.py
     states_cost(particle_states(...))) at K=5120 T=30 for two seeds and at a
     ragged K=1001 T=15, the counters
     model.pe_evals and model.pe_fused; the dispatch launching on the cell's
     shape and not under float64, grad or vmap; compiled updates on the
     cell's inputs within 1e-6 of the box of op-by-op ones; weights changed
     in place between replays reaching the kernel; one launch a replay;
     CUDA-event times of the kernel, the op-by-op chain and the update with
     either, the kernel beside work_pe's bound.

After every phase that launches the kernel, the finish's ticket counters are
back at 0.

Phases 19-21 end with a JSON line of the serving runs' numbers
({"serving": ...}), phases 22-23 with one of theirs ({"refine": ...,
"training": ...}), phases 24-28 with {"sharded": ..., "auto": ..., "export":
...}, phase 30 with {"compiled": ...}, phase 31 with {"eager_compiled": ...},
phase 32 with {"evaluations": ...}, phase 33 with {"training_programs": ...},
phase 34 with {"sharded_programs": ...}, phase 35 with {"big_fleets": ...},
phase 36 with {"gauss_newton_kernel": ...}, phase 37 with {"step_prologue": ...},
phase 38 with {"network_rollout": ...}, phase 39 with {"pets_ensemble": ...},
phase 40 with {"pets_rollout": ...}.
The last three lines are the kernels JSON line (each entry with its bound:
kernels/rollout_cost.py rollout_cost_bound_ms or philox_normals_bound_ms, and
its launches per update: the main-path run's count over its cycles; where
phase 32, 33, 34 or 35 launched it, ``launches_phase_32``, ``_33``, ``_34``
or ``_35``, each of its runs' count; the unicycle fleet's entry also the
split tick's ms), the card's name and power limit
as nvidia-smi prints them, and {"ok": true, "device": {...}}. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import socket
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


def graph_replay(fn, n):
    """A function that replays one CUDA graph of n calls of fn, captured here
    after a warm call: its time over n is a launch's device time where the
    host takes longer to enqueue a launch than the card to run it (a small
    draw). A plain torch.cuda.CUDAGraph: a wrapper's launch count sees the
    capture, not the replays."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return graph.replay


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
OFFSET = 3 * K_MAIN + 17   # phase 24's first_sample, past every sample drawn before
TIE = 0.10                 # phase 26: arms within 10 % of each other are a tie
AUTO_K = (16, 64, 256, 1024, 4096, 10000, 32768, 102400)   # phase 26's grid
AUTO_T = (5, 15, 30)
PROFILE_STEPS = 20
WORKER = ROOT / "scripts" / "torch_multiprocess_worker.py"


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_workers(mode, world_size, device, tmp):
    """scripts/torch_multiprocess_worker.py in ``world_size`` processes over
    gloo on ``device``; their npz results. Every process is waited for, and
    killed if it outlives the wait."""
    import numpy as np

    port, outs, procs, logs = free_port(), [], [], []
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    try:
        for r in range(world_size):
            outs.append(tmp / f"{mode}{r}.npz")
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "--mode", mode, "--coordinator",
                 f"localhost:{port}", "--world-size", str(world_size), "--rank", str(r),
                 "--out", str(outs[-1]), "--device", device, "--backend", "gloo"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"worker {r} of {world_size} failed:\n{log[-3000:]}")
    return [dict(np.load(o)) for o in outs]


def crossover(rows):
    """The smallest K*(T-1) of ``rows`` [(K*(T-1), K, T, kernel ms, eager
    ms)], sorted by K*(T-1), from which on the kernel was the faster at
    every point; None where it was the faster at every point of the grid;
    one past the last point where it never was."""
    cut = rows[-1][0] + 1
    for props, _, _, kern, eager in reversed(rows):
        if kern >= eager:
            return cut
        cut = props
    return None


GRAPH_UPDATES = 50          # phase 30: chained updates, compiled against op by op
SEED_30, STEP_30 = 2 ** 33 + 5, 9  # phase 30's key: a seed past 32 bits


def host_split(keyed, args, calls=200):
    """Host microseconds of each piece of a replayed call of ``keyed`` (a
    KeyedGraph whose graph of ``args`` exists), over ``calls`` calls after
    one: the state, path and dt made graph inputs, the argument walk for the
    cache key, the guard that takes its place (the graph's own, with the
    stale check folded in), the refusal check, the load of the inputs (none
    changed), a copy of every input (what a call would cost without the
    skip), the replay's launch, the copies of the outputs, the rebuild of the
    result and the graph's generated rebuild with its copies."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph

    full = keyed._inputs(*args[:3]) + tuple(args[3:])
    leaves = []
    graph = keyed.graphed.graphs[cuda_graph._flatten(full, leaves)]

    def us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return out

    return {
        "graph_inputs": us(lambda: keyed._inputs(*args[:3])),
        "walk": us(lambda: cuda_graph._flatten(full, [])),
        "guard": us(lambda: graph.guard(full, graph._loaded)),
        "refusal": us(lambda: cuda_graph.refusal(leaves)),
        "load_unchanged": us(lambda: graph.load(leaves)),
        "copy_every_input": us(lambda: torch._foreach_copy_(graph.inputs, leaves)),
        "replay": us(graph.replay),
        "clone_outputs": us(lambda: cuda_graph._clone_all(graph.outputs)),
        "rebuild": us(lambda: cuda_graph.fill_tensors(graph.out_template, graph.outputs)),
        "clone_and_rebuild": us(lambda: graph.rebuild(graph.outputs)),
        "inputs": len(leaves), "outputs": len(graph.outputs)}


def phase_29():
    """Each workload of BENCHMARK.json once, in a process of its own, for 2 s
    and untraced: its last line says correct, 0 failed, every metric finite."""
    with open(ROOT / "BENCHMARK.json") as f:
        workloads = [w["name"] for w in json.load(f)["workloads"]]
    t0 = time.perf_counter()
    for name in workloads:
        cmd = [sys.executable, "-m", "benchmark", "--workload", name, "--seed", "0",
               "--seconds", "2", "--trace", "0"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        require(proc.returncode == 0 and lines, f"{' '.join(cmd[1:])} exited "
                f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        rec = json.loads(lines[-1])
        metrics = {k: m["value"] for k, m in rec["metrics"].items()}
        print(f"[29 benchmark] {name}: correct {rec['correct']}, attempted "
              f"{rec['attempted']}, failed {rec['failed']}, {metrics}, checks "
              f"{rec['checks']}; on {rec['device']['kind']}", flush=True)
        require(rec["correct"] is True and rec["failed"] == 0 and metrics
                and all(isinstance(v, (int, float)) and math.isfinite(v)
                        for v in metrics.values()),
                f"benchmark {name}: not correct, a failed answer or a metric not finite: {rec}")
    print(f"[29 benchmark] {len(workloads)} cells, each correct, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_30(dev, card, launches, max_abs_err, times_out, counters_zero):
    """Phase 30: the compiled paths (utils/cuda_graph.py), the counterparts
    of the JAX package's jax.jit and lax.scan. (a) the kernel's key read from
    device memory, bit-equal to the by-value key and within the kernel gate
    of its plain version with the same key tensor; (b) compile_step against
    op by op over GRAPH_UPDATES chained updates; (c) replays draw anew and
    the key reads [seed, step]; (d) no host sync in a replay, one capture a
    configuration; (g) a replay reads a parameter retuned in place and runs
    under torch.inference_mode; (e) the gates on the graphed paths; (f)
    timings of the op-by-op and graphed arms in turns, and where a graphed
    call's host time goes (:func:`host_split`). Fills ``launches``, ``max_abs_err``
    and ``times_out`` for the kernels line; returns its JSON record."""
    import numpy as np
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        KernelLaunch,
        fused_sample_rollout_cost,
        fused_sample_rollout_cost_reference,
    )
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import elite_threshold
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime import (
        ControlLoop,
        run_tracking_experiment,
        simulate,
    )
    from ccv_mppi_path_tracker_tpu_torch.runtime import loop as loop_mod
    from ccv_mppi_path_tracker_tpu_torch.runtime import realtime
    from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, init_fleet
    from ccv_mppi_path_tracker_tpu_torch.solver import batch as batch_mod
    from ccv_mppi_path_tracker_tpu_torch.solver.command import command_from_solution
    from ccv_mppi_path_tracker_tpu_torch.solver.mppi import (
        REFINE_GRAPHS,
        KeyedGraph,
        compile_step,
        mppi_step,
    )
    from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph

    kernel_fn, plain_fn = fused_sample_rollout_cost, fused_sample_rollout_cost_reference
    record = {}
    t_phase = time.perf_counter()

    def key_of(seed, step):
        return torch.tensor([seed, step], dtype=torch.int64, device=dev)

    def key_reads(ctrl):
        return ctrl.key.tolist() == [ctrl.seed, ctrl.step]

    # (a) the kernel's key --------------------------------------------------
    key = key_of(SEED_30, STEP_30)
    by_value = dict(seed=SEED_30, step=STEP_30)
    by_key = dict(seed=None, step=None, key=key)
    key_cases = [(p, K_MAIN, T_MAIN, None, {}) for p in PRESET_MODELS]
    key_cases += [("full_body", K_MAIN, T_MAIN, None, {"accumulate": False}),
                  ("full_body", K_MAIN, T_MAIN, None, {"costs_in": True}),
                  ("diff_drive", K_MAIN, T_MAIN, None, {"costs_in": True}),
                  ("full_body", K_MAIN, T_MAIN, None, {"second_moment": True}),
                  ("diff_drive", K_MAIN, T_MAIN, None, {"second_moment": True}),
                  ("full_body", K_MAIN, T_MAIN, None, {"first_sample": OFFSET}),
                  ("diff_drive", K_FLEET, T_FLEET, B_FLEET, {}),
                  ("full_body", K_FLEET, T_FLEET, B_FLEET, {})]
    worst = {}
    for preset, k, t, robots, opts in key_cases:
        s = kernel_case(preset, k, t, robots=robots, seed=30)
        kw = dict(num_samples=k, model=s["model"], **opts)
        args = s["kargs"]
        if opts.get("costs_in"):
            costs = kernel_fn(*args, accumulate=False, **by_value, num_samples=k,
                              model=s["model"])[0]
            args = args[:6] + (s["scal"](elite_threshold(costs, ELITE)),)
            kw["costs_in"] = costs
        a = kernel_fn(*args, **by_value, **kw)
        b = kernel_fn(*args, **by_key, **kw)
        c = plain_fn(*args, **by_key, **kw)
        torch.cuda.synchronize()
        same = all((x is None and y is None) or bool(torch.equal(x, y)) for x, y in zip(a, b))
        tag = f"{s['model']} K={k} T={t}{f' B={robots}' if robots else ''} {opts or ''}"
        require(same, f"[30] {tag}: the device key's draw differs from the by-value key's")
        cost_rel = float(((b[0] - c[0]).abs() / c[0].abs()).max())
        require(cost_rel <= COST_RTOL, f"[30] {tag}: key costs vs plain {cost_rel}")
        err = 0.0
        if b[1] is not None:
            norm_b, norm_c = b[2], c[2]
            if robots:
                norm_b, norm_c = norm_b[:, None, None], norm_c[:, None, None]
            ub, uc = b[1] / norm_b, c[1] / norm_c
            err = float((ub - uc).abs().max())
            require(bool(torch.isfinite(ub).all()) and err <= u_bound(uc),
                    f"[30] {tag}: key u_opt vs plain {err} > {u_bound(uc)}")
        worst[tag] = err
        print(f"[30 key] {tag}: device key bit-equal to the by-value key {same}; vs the "
              f"plain version with the same key tensor: costs max rel err {cost_rel:.3e}, "
              f"u_opt max abs err {err:.3e}", flush=True)
        counters_zero(f"[30] {tag}")
    max_abs_err["full_body_key"] = worst[f"full_body K={K_MAIN} T={T_MAIN} "]
    record["key_cases"] = len(key_cases)

    # (b, c) compile_step against op by op ---------------------------------
    chains = {}
    for preset, opts in (("full_body", {}), ("diff_drive", {}),
                         ("full_body", {"elite_frac": ELITE}),
                         ("full_body", {"refine_steps": 3,
                                        "refine_method": "gauss_newton"})):
        cfg, sp, cp, course = PRESETS[preset](num_samples=K_MAIN, horizon=T_MAIN, device=dev)
        m = get_model(cfg.model)
        path = PathBuffer.from_points(course, 0.1, device=dev)
        state = torch.zeros(m.num_states, device=dev)
        state[1] = float(course[0, 1])
        n = GRAPH_UPDATES if "refine_steps" not in opts else 10
        compiled = compile_step(cfg, use_kernel=True, lean=True, **opts)
        refine_graphs = REFINE_GRAPHS.captures
        fused_sample_rollout_cost.launches = 0
        c1 = ControllerState.initial(SEED_30, cfg.horizon, m.num_controls, device=dev)
        outs_g = []
        for i in range(n):
            c1, r1 = compiled(c1, state, path, 0.1 + 0.001 * i, sp, cp)
            outs_g.append(r1.u_opt)
        n_graph = fused_sample_rollout_cost.launches
        inlined = REFINE_GRAPHS.captures == refine_graphs
        c2 = ControllerState.initial(SEED_30, cfg.horizon, m.num_controls, device=dev)
        outs_e = []
        for i in range(n):
            c2, r2 = mppi_step(cfg, c2, state, path, torch.full((), 0.1 + 0.001 * i,
                                                                device=dev),
                               sp, cp, use_kernel=True, lean=True, **opts)
            outs_e.append(r2.u_opt)
        g, e = torch.stack(outs_g), torch.stack(outs_e)
        bit = bool(torch.equal(g, e))
        err = float((g - e).abs().max())
        moved = bool((g[1:] - g[:-1]).abs().amax(dim=(1, 2)).min() > 0)
        name = f"{cfg.model}{''.join('_' + k for k in opts)}"
        per = 2 if "elite_frac" in opts else 1
        require(err <= u_bound(e), f"[30] {name}: compiled vs op by op {err}")
        require(compiled.captures == 1, f"[30] {name}: {compiled.captures} captures")
        require(n_graph == per * n, f"[30] {name}: {n_graph} launches in {n} updates")
        require(key_reads(c1) and c1.step == n and c1.key.tolist() == c2.key.tolist(),
                f"[30] {name}: key {c1.key.tolist()} after {n} updates")
        require(moved, f"[30] {name}: two consecutive replays gave the same update")
        require(inlined, f"[30] {name}: the refine stage was captured apart")
        chains[name] = dict(bit_equal=bit, max_abs_err=err, updates=n, launches=n_graph)
        print(f"[30 compile_step] {name} K={K_MAIN} T={T_MAIN}, {n} chained updates, dt "
              f"varying: u_opt bit-equal to op by op {bit} (max abs err {err:.3e}, bound "
              f"{u_bound(e):.3e}); 1 capture; kernel launches {n_graph} (replays counted); "
              f"every update moved; key {c1.key.tolist()} = [seed, step]"
              f"{'; refine stage inlined in the graph' if 'refine_steps' in opts else ''}",
              flush=True)
        counters_zero(f"[30] {name}")
    record["compile_step"] = chains
    # consecutive replays from one warm start draw new samples
    cfg, sp, cp, course = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN, device=dev)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    state = torch.zeros(5, device=dev)
    state[1] = float(course[0, 1])
    compiled = compile_step(cfg, use_kernel=True, lean=True)
    c0 = ControllerState.initial(SEED_30, cfg.horizon, 5, device=dev)
    ua = compiled(c0, state, path, 0.1, sp, cp)[1].u_opt        # the capture's eager run
    ub = compiled(c0, state, path, 0.1, sp, cp)[1].u_opt        # a replay, same key
    c1 = ControllerState(c0.u_prev, c0.seed, 1, key_of(SEED_30, 1))
    uc = compiled(c1, state, path, 0.1, sp, cp)[1].u_opt        # a replay, the next key
    require(bool(torch.equal(ua, ub)) and not bool(torch.equal(ub, uc)),
            "[30] a replay does not follow the key it is given")
    print("[30 replays] from one warm start: the replay at the same key bit-equal to the "
          "capturing run, the replay at the next key a new draw", flush=True)

    # (d) one capture a configuration, no host sync in a replay ----------------
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path, sigma_adapt=0.2,
                       solver_options={"use_kernel": True, "lean": True})
    fused_sample_rollout_cost.launches = 0
    st = state
    for i in range(GRAPH_UPDATES):
        res = loop.step(st, dt=0.1 + 0.002 * i)
        st = get_model("full_body").step(st, res.u0, 0.1)
    require(loop.compiled.captures == 1 and fused_sample_rollout_cost.launches ==
            GRAPH_UPDATES and key_reads(loop.ctrl),
            f"[30] ControlLoop: {loop.compiled.captures} captures, "
            f"{fused_sample_rollout_cost.launches} launches in {GRAPH_UPDATES} cycles")
    fcfg, fsp, fcp, fcourse = PRESETS["diff_drive"](num_samples=K_FLEET, horizon=T_FLEET,
                                                    device=dev)
    fpath = PathBuffer.from_points(fcourse, 0.1, device=dev)
    fstates = torch.zeros((B_FLEET, 3), device=dev)
    fstates[:, 1] = float(fcourse[0, 1]) + torch.linspace(-0.4, 0.4, B_FLEET, device=dev)
    fstep = build_fleet_step(fcfg, use_kernel=True)
    fctrls = init_fleet(fcfg, B_FLEET, seed=1, device=dev)
    fdt = torch.full((), 0.1, device=dev)
    fctrls, _ = fstep(fctrls, fstates, fpath, fdt, fsp, fcp)
    lcfg, lsp, lcp, lcourse = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN,
                                                   device=dev)
    lpath = PathBuffer.from_points(lcourse, 0.1, device=dev)
    lstart = torch.tensor([0.0, float(lcourse[0, 1]), 0.0, 0.0, 0.0], device=dev)
    ldt = torch.full((), 0.1, device=dev)

    def lrun(n, seed=0):
        return simulate(lcfg, ControllerState.initial(seed, T_MAIN, 5, device=dev), lstart,
                        lpath, ldt, lsp, lcp, num_steps=n, use_kernel=True, with_stats=False)

    before = loop_mod.CYCLE.captures
    lrun(5)
    lrun(7, seed=3)
    loop_captures = loop_mod.CYCLE.captures - before
    ctrl = ControllerState.initial(SEED_30, cfg.horizon, 5, device=dev)
    ctrl, _ = compiled(ctrl, state, path, 0.1, sp, cp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            ctrl, _ = compiled(ctrl, state, path, 0.1, sp, cp)
            loop.step(st, dt=0.1)
            fctrls, _ = fstep(fctrls, fstates, fpath, fdt, fsp, fcp)
        lrun(5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(loop_captures <= 1 and fstep.graphed.captures == 1,
            f"[30] captures: loop {loop_captures}, fleet {fstep.graphed.captures}")
    print(f"[30 captures] one capture a configuration: compile_step 1, ControlLoop 1 over "
          f"{GRAPH_UPDATES} cycles with dt varying ({GRAPH_UPDATES} launches), the fleet "
          f"tick 1, the loop's cycle {loop_captures} over two runs of 5 and 7 cycles "
          f"(kept from an earlier run of this configuration where 0); no host sync in a "
          f"replay of the step, the ControlLoop cycle, the fleet tick, nor in a 5-cycle "
          f"graphed loop", flush=True)
    counters_zero("[30] captures")

    # (g) what a replay reads: a parameter retuned in place by a torch op, and
    # calls under torch.inference_mode (inference tensors, copied at every
    # call), the graph captured inside it and replayed inside and outside
    rcfg, rsp, rcp, rcourse = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN,
                                                   device=dev)
    rpath = PathBuffer.from_points(rcourse, 0.1, device=dev)
    rstep = compile_step(rcfg, use_kernel=True, lean=True)
    r0 = ControllerState.initial(SEED_30, T_MAIN, 5, device=dev)
    before = rstep(r0, state, rpath, 0.1, rsp, rcp)[1].u_opt       # the capture
    rcp.path_weight.mul_(3.0)
    got = rstep(r0, state, rpath, 0.1, rsp, rcp)[1].u_opt
    want = mppi_step(rcfg, r0, state, rpath, torch.full((), 0.1, device=dev), rsp, rcp,
                     use_kernel=True, lean=True)[1].u_opt
    retune_bit = bool(torch.equal(got, want))
    retune_err = float((got - want).abs().max())
    require(retune_err <= u_bound(want) and not bool(torch.equal(got, before)),
            f"[30] a replay after an in-place retune: {retune_err} from op by op")
    with torch.inference_mode():
        istep = compile_step(rcfg, use_kernel=True, lean=True)
        ic = ControllerState.initial(SEED_30, T_MAIN, 5, device=dev)
        ig = []
        for i in range(3):
            ic, ires = istep(ic, state, rpath, 0.1 + 0.01 * i, rsp, rcp)
            ig.append(ires.u_opt)
    ic, ires = istep(ic, state, rpath, 0.13, rsp, rcp)
    ig.append(ires.u_opt)
    ie, ieo = ControllerState.initial(SEED_30, T_MAIN, 5, device=dev), []
    for i in range(4):
        ie, ires = mppi_step(rcfg, ie, state, rpath, torch.full((), 0.1 + 0.01 * i, device=dev),
                             rsp, rcp, use_kernel=True, lean=True)
        ieo.append(ires.u_opt)
    infer_err = float((torch.stack(ig) - torch.stack(ieo)).abs().max())
    infer_bit = bool(torch.equal(torch.stack(ig), torch.stack(ieo)))
    require(infer_err <= u_bound(ieo[-1]) and istep.captures == 1 and key_reads(ic),
            f"[30] inference mode: {infer_err} from op by op, {istep.captures} captures")
    record["replay_reads"] = dict(retune_bit_equal=retune_bit, retune_max_abs_err=retune_err,
                                  inference_bit_equal=infer_bit,
                                  inference_max_abs_err=infer_err)
    print(f"[30 inputs] path_weight retuned by an in-place torch op between replays: u_opt "
          f"bit-equal to op by op with the new weight {retune_bit} (max abs err "
          f"{retune_err:.3e}), and moved; 3 updates under torch.inference_mode (captured "
          f"there) and one replay outside it: bit-equal to op by op {infer_bit} (max abs err "
          f"{infer_err:.3e}), 1 capture, key {ic.key.tolist()} = [seed, step]", flush=True)
    counters_zero("[30] inputs")

    # (e) the gates on the graphed paths ---------------------------------------
    fused_sample_rollout_cost.launches = 0
    out = run_tracking_experiment(lcfg, lsp, lcp, lcourse, num_steps=STEPS, use_kernel=True)
    n = fused_sample_rollout_cost.launches
    launches["full_body_graphed"] = n
    rmse = out["metrics"]["rmse"]
    require(rmse < 0.15 and n == STEPS and key_reads(out["ctrl"]),
            f"[30] graphed loop: RMSE {rmse}, {n} launches")
    fused_sample_rollout_cost.launches = 0
    fctrls = init_fleet(fcfg, B_FLEET, seed=1, device=dev)
    fs = fstates
    fm = get_model(fcfg.model)
    for _ in range(STEPS):
        fctrls, fres = fstep(fctrls, fs, fpath, fdt, fsp, fcp)
        fs = fm.step(fs, fres.u0, fdt)
    final = fs.cpu().numpy()
    d = np.min(np.linalg.norm(final[:, None, :2] - fcourse[None], axis=-1), axis=1)
    nf = fused_sample_rollout_cost.launches
    require(bool((d < 0.3).all()) and nf == STEPS and key_reads(fctrls),
            f"[30] graphed fleet: worst robot {d.max()} m, {nf} launches")
    paced = realtime.run_realtime_experiment(lcfg, lsp, lcp, lcourse, hz=10.0,
                                             num_cycles=20, use_kernel=True)
    prs = paced["rate_stats"]
    require(prs["deadline_misses"] == 0 and paced["metrics"]["rmse"] < 0.15,
            f"[30] paced ControlLoop at 10 Hz: {prs['deadline_misses']} misses, RMSE "
            f"{paced['metrics']['rmse']}")
    pcfg, psp, pcp, pcourse = PRESETS["diff_drive"](num_samples=K_MAIN, horizon=T_MAIN,
                                                    device=dev)
    piped = realtime.run_pipelined_experiment(pcfg, psp, pcp, pcourse, hz=50.0,
                                              num_cycles=96, use_kernel=True, micro_batch=8)
    pipe_rs, pipe_dm = piped["rate_stats"], piped["dispatch_ms"]
    require(pipe_rs["deadline_misses"] == 0 and piped["metrics"]["rmse"] < 0.5,
            f"[30] pipelined M=8: {pipe_rs['deadline_misses']} misses, RMSE "
            f"{piped['metrics']['rmse']}")
    record["gates"] = dict(
        loop_rmse=rmse, loop_launches=n, fleet_worst_m=float(d.max()), fleet_launches=nf,
        paced_misses=prs["deadline_misses"], paced_mean_dt_ms=prs["mean_dt"] * 1e3,
        paced_rmse=paced["metrics"]["rmse"], pipelined_m8_misses=pipe_rs["deadline_misses"],
        pipelined_m8_dispatch_ms=pipe_dm, pipelined_m8_rmse=piped["metrics"]["rmse"])
    print(f"[30 gates] graphed loop {STEPS} cycles full_body K={K_MAIN} T={T_MAIN}: RMSE "
          f"{rmse:.4f} m, {n} launches; graphed fleet {STEPS} ticks B={B_FLEET} K={K_FLEET} "
          f"T={T_FLEET}: every robot within {d.max():.4f} m, {nf} launches; paced "
          f"ControlLoop full_body 10 Hz 20 cycles: {prs['deadline_misses']} misses, mean dt "
          f"{prs['mean_dt'] * 1e3:.4f} ms, RMSE {paced['metrics']['rmse']:.4f} m; pipelined "
          f"M=8 diff_drive 50 Hz 96 cycles: {pipe_rs['deadline_misses']} misses, a window's "
          f"dispatch mean {pipe_dm['mean']:.4f} ms max {pipe_dm['max']:.4f} ms, RMSE "
          f"{piped['metrics']['rmse']:.4f} m on {card}", flush=True)
    counters_zero("[30] gates")

    # (f) timing: op by op against graphed, in turns ---------------------------
    arms, per = {}, {}
    for name, preset, k, t, opts in (
            ("full_body", "full_body", K_MAIN, T_MAIN, {}),
            ("unicycle", "diff_drive", K_MAIN, T_MAIN, {}),
            ("full_body_K10000_T15", "full_body", K_REF, T_REF, {}),
            ("full_body_elite", "full_body", K_MAIN, T_MAIN, {"elite_frac": ELITE})):
        s = kernel_case(preset, k, t, roll_off=True, seed=5)
        step_args = (s["state"], s["path"], s["dt"], s["sp"], s["cp"])
        comp = compile_step(s["cfg"], use_kernel=True, lean=True, **opts)

        def chain(fn, s=s, step_args=step_args):
            carry = [ControllerState.initial(0, s["cfg"].horizon, s["u_prev"].shape[1],
                                             device=dev)]

            def call():
                carry[0], _ = fn(carry[0], *step_args, model_params=s["mp"])
            return call

        arms[f"{name}/op_by_op"] = (chain(functools.partial(
            mppi_step, s["cfg"], use_kernel=True, lean=True, **opts)), 20)
        arms[f"{name}/graphed"] = (chain(comp), 20)
    s = kernel_case("full_body", K_MAIN, T_MAIN, roll_off=True, seed=5)
    mkw = dict(num_samples=K_MAIN, model="full_body")
    arms["kernel/by_value"] = (KernelLaunch(*s["kargs"], **by_value, **mkw).run, 50)
    arms["kernel/device_key"] = (KernelLaunch(*s["kargs"], **by_key, **mkw).run, 50)
    arms["kernel/plain_key"] = (lambda: plain_fn(*s["kargs"], **by_key, **mkw), 3)
    # the 200-cycle loop: the eager scan of the cycle against its graph
    static = (lcfg, loop_mod.Plant(model_name="full_body"),
              {"use_kernel": True, "lean": False}, True, False)
    mp = get_model("full_body").default_params(device=dev)

    def loop_eager():
        c = ControllerState.initial(0, T_MAIN, 5, device=dev)
        cuda_graph.scan(loop_mod.cycle, (c, lstart, None), lpath, ldt, lsp, lcp, mp, *static,
                        length=STEPS)

    def loop_graphed():
        simulate(lcfg, ControllerState.initial(0, T_MAIN, 5, device=dev), lstart, lpath,
                 ldt, lsp, lcp, model_params=mp, num_steps=STEPS, use_kernel=True)

    arms["loop200/op_by_op"], arms["loop200/graphed"] = (loop_eager, 1), (loop_graphed, 1)
    per["loop200"] = STEPS
    # the fleet tick
    fc = [init_fleet(fcfg, B_FLEET, seed=1, device=dev)] * 2

    def tick_eager():
        fc[0], _ = batch_mod._tick(fc[0], fpath, fdt, fstates, fsp, fcp, None, None, fcfg, True)

    def tick_graphed():
        fc[1], _ = fstep(fc[1], fstates, fpath, fdt, fsp, fcp)

    arms["fleet/op_by_op"], arms["fleet/graphed"] = (tick_eager, 20), (tick_graphed, 20)
    # the serving cycle: update, command geometry, plant, one read to the host
    serve = {}
    for arm in ("op_by_op", "graphed"):
        sl = ControlLoop(cfg=lcfg, sp=lsp, cp=lcp, path=lpath,
                         solver_options={"use_kernel": True, "lean": True})
        if arm == "op_by_op":
            sl.compiled = functools.partial(mppi_step, lcfg, use_kernel=True, lean=True)
        serve[arm] = sl

        def cycle(sl=sl):
            res = sl.step(lstart, dt=0.01)
            cmd = command_from_solution("full_body", res.u0, 0.01)
            nxt = get_model("full_body").step(lstart, res.u0, 0.01)
            torch.cat([nxt, torch.stack([cmd.v, cmd.w, cmd.steer_r, cmd.steer_l,
                                         cmd.roll])]).cpu()
        arms[f"serving/{arm}"] = (cycle, 20)
    # the pipelined M=8 window's enqueue
    wkw = dict(model_params=None, use_kernel=True, lean=True)
    pstate = torch.tensor([0.0, float(pcourse[0, 1]), 0.0], device=dev)
    ppath = PathBuffer.from_points(pcourse, 0.1, device=dev)
    pdt = torch.full((), 0.1, device=dev)
    gwin = KeyedGraph(realtime.window)
    pc = ControllerState.initial(0, T_MAIN, 2, device=dev)
    wargs = (pc, ppath, pdt, pstate, psp, pcp, pcfg, 8, 0.02, wkw)
    arms["window_m8/op_by_op"] = (lambda: realtime.window(*wargs), 5)
    arms["window_m8/graphed"] = (lambda: gwin(*wargs, steps=8), 5)
    per["window_m8"] = 1
    host = {name: [] for name in arms}
    kl = {name: [0, 0] for name in arms}

    def wrap(name, fn):
        def call():
            before = fused_sample_rollout_cost.launches
            t0 = time.perf_counter()
            fn()
            host[name].append(time.perf_counter() - t0)
            kl[name][0] += fused_sample_rollout_cost.launches - before
            kl[name][1] += 1
        return call

    reps = 5
    times = time_interleaved({name: (wrap(name, fn), inner)
                              for name, (fn, inner) in arms.items()}, reps)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    timing = {}
    for name, v in times.items():
        div = per.get(name.split("/")[0], 1)
        timing[name] = dict(
            ms=statistics.median(v) / div, ms_min=min(v) / div, ms_max=max(v) / div,
            host_us=statistics.median(host[name]) * 1e6 / div,
            launches=kl[name][0] / kl[name][1] / div)
        times_out[name] = timing[name]["ms"]
    # the graphed update's device busy share (phase 17's measure)
    comp = compile_step(s["cfg"], use_kernel=True, lean=True)
    pc2 = [ControllerState.initial(0, T_MAIN, 5, device=dev)]

    def graphed_update():
        pc2[0], _ = comp(pc2[0], s["state"], s["path"], s["dt"], s["sp"], s["cp"],
                         model_params=s["mp"])

    busy, dev_events = busy_share(graphed_update, 20, timing["full_body/graphed"]["ms"])
    record["busy_share_graphed_full_body"] = busy
    # where a graphed call's host time goes: the update's and the fleet tick's
    record["host_split_us"] = {
        "full_body_update": host_split(comp.graph, comp._args(
            pc2[0], s["state"], s["path"], s["dt"], s["sp"], s["cp"], model_params=s["mp"])),
        "fleet_tick": host_split(fstep.graphed, (fc[1], fpath, fdt, fstates, fsp, fcp, None,
                                                 None, fcfg, True))}
    record["device_events_per_graphed_update"] = dev_events
    record["timing"] = timing
    print(f"[30 timing] median of {reps} rounds in turns, CUDA events (ms a call; the loop "
          f"a cycle), host us a call, fused-kernel launches a call (replays counted), on "
          f"{card} (after: sm clock, draw, limit, temp = {clocks})", flush=True)
    for name, tm in timing.items():
        print(f"  {name}: {tm['ms']:.4f} ms [{tm['ms_min']:.4f}, {tm['ms_max']:.4f}], host "
              f"{tm['host_us']:.1f} us, {tm['launches']:.2f} kernel launches", flush=True)
    print(f"  graphed full_body update: {dev_events:.1f} device events an update "
          f"in the profiler, busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}", flush=True)
    for name, split in record["host_split_us"].items():
        print(f"  host us of a graphed call, {name}: " + ", ".join(
            f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}" for k, v in split.items()),
            flush=True)
    counters_zero("[30] timing")
    record["seconds"] = time.perf_counter() - t_phase
    print(f"[30 compiled] done in {record['seconds']:.1f} s", flush=True)
    return record


EAGER_UPDATES = 50          # phase 31: chained updates, graphed eager against op by op
DRAW_TOL = 1e-5             # phase 31: the draw kernel against its plain version, max |diff|
SEED_31, STEP_31 = 2 ** 33 + 7, 11  # phase 31's key: a seed past 32 bits
REPLACES_DRAW = "ccv_mppi_path_tracker_tpu/ops/sampling.py:53"  # XLA's RBG normal
# XLA's ops of the jitted step, from the reference window on
REPLACES_PROLOGUE = "ccv_mppi_path_tracker_tpu/paths/resample.py:73"
# meta_train's step draw (diff/learned_optimizer.py), (B, T-1, K, U): 64 robot rows
META_DRAW = (64, 7, 64, 2)


# phase 31 (a)'s draws: name, robots, T-1, K, U, first_sample. The flagship
# and its U=3 (steered models), the fleet, the sample offset, meta_train's
# step (diff/learned_optimizer.py, 64 robot rows), the other unrolled U (1,
# 4), the generic loop (U=7, with a ragged float tail), a K that is not a
# multiple of the block's rows, and T-1 past the old grid's 65535.
DRAW_SHAPES = (
    ("flagship", 1, T_MAIN - 1, K_MAIN, 5, 0), ("u3", 1, T_MAIN - 1, K_MAIN, 3, 0),
    ("fleet", B_FLEET, T_FLEET - 1, K_FLEET, 2, 0),
    ("first_sample", 1, T_MAIN - 1, K_MAIN, 5, K_MAIN // 2),
    ("meta_train", *META_DRAW, 0), ("u1", 1, T_MAIN - 1, K_MAIN, 1, 0),
    ("u4", 1, T_MAIN - 1, K_MAIN, 4, 0), ("generic_u7", 2, 9, 999, 7, 0),
    ("ragged_k1000", 1, T_MAIN - 1, 1000, 5, 0), ("tm1_70001", 2, 70_001, 3, 5, 0),
)


WIDE_DRAW = (2, 1, 2**30 + 1, 1)  # 2^31 + 2 rows, 8.6 GB: the 64-bit row split
WIDE_SLICE = 4096                  # samples held against the plain version at each end


def wide_draw_check(dev):
    """A draw past 2^31 - 1 rows (WIDE_DRAW, the wide instantiation): by the
    device key bit-equal to by value, finite, and the first WIDE_SLICE
    samples of robot 0 and the last of robot 1 (rows past 2^31) against the
    plain version within DRAW_TOL. Returns its record."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        philox_draw_geometry,
        philox_normals_cuda,
    )

    robots, tm1, k, u_dim = WIDE_DRAW
    geo = philox_draw_geometry(*WIDE_DRAW)
    kw = dict(num_samples=k, tm1=tm1, u_dim=u_dim, robots=robots)
    key = torch.tensor([SEED_31, STEP_31], dtype=torch.int64, device=dev)
    by_key = philox_normals_cuda(key, **kw)
    by_value = philox_normals_cuda(None, SEED_31, STEP_31, device=dev, **kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(by_key, by_value))
    del by_value
    finite = bool(torch.isfinite(by_key).all())
    err = 0.0
    for rob, first in ((0, 0), (1, k - WIDE_SLICE)):
        plain = philox_normals(SEED_31, STEP_31, WIDE_SLICE, tm1, u_dim, robot=rob,
                               device=dev, first_sample=first)
        err = max(err, float((by_key[rob, :, first:first + WIDE_SLICE] - plain).abs().max()))
    del by_key
    torch.cuda.empty_cache()
    print(f"[31 draw] wide (B, T-1, K, U) = {WIDE_DRAW}: {geo.rows} rows, the 64-bit row "
          f"split; device key bit-equal to the by-value key {same}; finite {finite}; the "
          f"first {WIDE_SLICE} samples of robot 0 and the last of robot 1 vs philox_normals "
          f"max abs err {err:.3e} (tol {DRAW_TOL}); {geo}", flush=True)
    require(geo.wide and same and finite and err <= DRAW_TOL,
            f"[31] wide draw: key {same}, finite {finite}, err {err}")
    return dict(shape=list(WIDE_DRAW), key_bit_equal_value=same, max_abs_err=err,
                geometry=geo._asdict())


def draw_checks(dev, build_log, max_abs_err, counters_zero):
    """Phase 31 (a): the draw kernel (kernels/rollout_cost.py
    philox_normals_cuda) at every DRAW_SHAPES shape, by value and by the
    device key (bit-equal), against its plain version (core/random.py
    philox_normals) within DRAW_TOL; the draw at first_sample K/2 is samples
    K/2... of the draw at 0; the draw past 2^31 rows (wide_draw_check); the
    fused kernel fed the draw bit-equal to its own RNG mode, every preset
    model; the ptxas report of each draw instantiation and the fused
    kernel's registers unchanged. Fills
    ``max_abs_err["philox_normals"]`` (the largest over the shapes); returns
    its record."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        REGISTERS,
        draw_instantiations,
        fused_sample_rollout_cost,
        instantiations,
        philox_draw_geometry,
        philox_normals_cuda,
    )

    def key_of(seed, step):
        return torch.tensor([seed, step], dtype=torch.int64, device=dev)

    draw_fn = philox_normals_cuda
    draws = {}
    for name, robots, tm1, k, u_dim, first in DRAW_SHAPES:
        kw = dict(num_samples=k, tm1=tm1, u_dim=u_dim, robots=robots, first_sample=first)
        by_value = draw_fn(None, SEED_31, STEP_31, device=dev, **kw)
        by_key = draw_fn(key_of(SEED_31, STEP_31), **kw)
        rob = torch.arange(robots, device=dev) if robots > 1 else 0
        plain = philox_normals(SEED_31, STEP_31, k, tm1, u_dim, robot=rob, device=dev,
                               first_sample=first)
        plain = plain if robots > 1 else plain[None]
        torch.cuda.synchronize()
        same = bool(torch.equal(by_value, by_key))
        err = float((by_key - plain).abs().max())
        bit = bool(torch.equal(by_key, plain))
        finite = bool(torch.isfinite(by_key).all())
        geo = philox_draw_geometry(robots, tm1, k, u_dim)
        draws[name] = dict(shape=list(by_key.shape), key_bit_equal_value=same,
                           max_abs_err=err, bit_equal_plain=bit, geometry=geo._asdict())
        print(f"[31 draw] {name} (B, T-1, K, U) = {tuple(by_key.shape)} first_sample {first}: "
              f"device key bit-equal to the by-value key {same}; vs philox_normals on the "
              f"card max abs err {err:.3e} (tol {DRAW_TOL}), bit-equal {bit}; finite "
              f"{finite}; {geo}", flush=True)
        require(same and finite and err <= DRAW_TOL,
                f"[31] draw {name}: key {same}, finite {finite}, err {err}")
        if name == "flagship":
            whole = by_key
        if name == "first_sample":
            half = K_MAIN // 2
            overlap = bool(torch.equal(by_key[:, :, :half], whole[:, :, half:]))
            require(overlap, "[31] the draw at first_sample K/2 is not samples K/2... of the "
                             "draw at 0")
            print(f"  the draw at first_sample {half} is samples {half}... of the draw at 0, "
                  f"bit for bit: {overlap}", flush=True)
        del by_value, by_key, plain
    draws["wide"] = wide_draw_check(dev)
    max_abs_err["philox_normals"] = max(d["max_abs_err"] for d in draws.values())
    # the fused kernel fed the eager draw is its own RNG mode, bit for bit
    fed = {}
    for preset in PRESET_MODELS:
        s = kernel_case(preset, K_MAIN, T_MAIN, seed=31)
        u_dim = s["u_prev"].shape[1]
        mkw = dict(num_samples=K_MAIN, model=s["model"])
        own = fused_sample_rollout_cost(*s["kargs"], seed=SEED_31, step=STEP_31, **mkw)
        noise = draw_fn(key_of(SEED_31, STEP_31), num_samples=K_MAIN, tm1=T_MAIN - 1,
                        u_dim=u_dim)[0]
        given = fused_sample_rollout_cost(*s["kargs"], seed=None, step=None, noise=noise,
                                          **mkw)
        torch.cuda.synchronize()
        bit = all(bool(torch.equal(a, b)) for a, b in zip(own, given))
        fed[s["model"]] = bit
        print(f"[31 fused] {s['model']} K={K_MAIN} T={T_MAIN}: the fused kernel fed the "
              f"eager draw bit-equal to its RNG mode (costs, u_num, norm) {bit}", flush=True)
        require(bit, f"[31] {s['model']}: the eager draw is not the fused kernel's own")
        counters_zero(f"[31] fused {s['model']}")
    summary = build.ptxas_summary(build_log or "")
    fused_regs = {f"{m} m2={int(m2)} {f}": p["registers"]
                  for (m, m2, f), p in instantiations(summary).items()}
    unchanged = all(p["registers"] == REGISTERS[m, f]
                    for (m, _, f), p in instantiations(summary).items())
    draw_ptx = draw_instantiations(summary)
    require(not build_log or (len(fused_regs) == 16 and unchanged and len(draw_ptx) == 12),
            f"[31] ptxas: fused {fused_regs}, draw {draw_ptx}")
    for (u_dim, wide), p in sorted(draw_ptx.items()):
        tile = philox_draw_geometry(1, 1, 1, u_dim or 7).smem
        print(f"[31 ptxas] philox_normals_kernel<{u_dim}, {str(wide).lower()}> "
              f"({'U = %d, unrolled' % u_dim if u_dim else 'generic U'}, "
              f"{'64-bit' if wide else '32-bit'} row split): "
              f"{p['registers']} registers, {p['spill_stores']} B spill stores, "
              f"{p['spill_loads']} B spill loads, {p['stack']} B stack, {p['smem']} B static "
              f"smem, {tile} B dynamic tile at {'U = %d' % (u_dim or 7)}", flush=True)
    print(f"[31 ptxas] the fused kernel's {len(fused_regs)} instantiations' registers equal "
          f"REGISTERS (unchanged): {unchanged if build_log else 'not rebuilt here'}",
          flush=True)
    return {"draws": draws, "fused_fed_draw_bit_equal": fed,
            "ptxas": {"draw": {f"{u},{int(w)}": p for (u, w), p in draw_ptx.items()},
                      "fused_registers": fused_regs,
                      "fused_unchanged": unchanged if build_log else "library reused"}}


def busy_share(fn, calls, ms_per_call):
    """(the device's busy share, device events a call) of ``calls`` calls
    of ``fn`` under torch.profiler, against ``ms_per_call`` CUDA-event ms a
    call; (None, 0) where the profiler shows no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, 0
    dev_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls
    return dev_ms / ms_per_call, len(events) / calls


def phase_31(dev, card, build_log, launches, max_abs_err, times_out, counters_zero):
    """Phase 31: the eager arm's compiled programs. (a) :func:`draw_checks`:
    the draw kernel against its plain version at every DRAW_SHAPES shape, by
    value and by the device key; the fused kernel fed the draw bit-equal to
    its own RNG mode; the draw's ptxas report and the fused kernel's
    registers; (b) the eager RNG-mode
    update against the kernel RNG-mode update, every model, within the
    kernel gate; (c) compile_step(use_kernel=False) against op by op over
    EAGER_UPDATES chained updates (full_body, unicycle, elite, adapt_sigma,
    the custom bicycle through auto), one capture each, no host sync in a
    replay, and the refusal of a user model whose step reads the card back;
    (d) the graphed eager loop, fleet and pipelined window with their gates;
    (e) timings of the op-by-op and graphed arms in turns, host us,
    launches, busy share, and the graphed eager update's peak memory. Fills
    ``launches``, ``max_abs_err`` and ``times_out`` for the kernels line;
    returns its JSON record."""
    import numpy as np
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core import SolverConfig
    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
        philox_normals_cuda,
    )
    from ccv_mppi_path_tracker_tpu_torch.models import Model, get_model, register_model
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment, simulate
    from ccv_mppi_path_tracker_tpu_torch.runtime import loop as loop_mod
    from ccv_mppi_path_tracker_tpu_torch.runtime import realtime
    from ccv_mppi_path_tracker_tpu_torch.solver import (
        MPPISolver,
        build_fleet_step,
        init_fleet,
    )
    from ccv_mppi_path_tracker_tpu_torch.solver import batch as batch_mod
    from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph, compile_step, mppi_step
    from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph

    record = {}
    t_phase = time.perf_counter()
    draw_fn = philox_normals_cuda

    def key_of(seed, step):
        return torch.tensor([seed, step], dtype=torch.int64, device=dev)

    def key_reads(ctrl):
        return ctrl.key.tolist() == [ctrl.seed, ctrl.step]

    def on_course(cfg, course):
        st = torch.zeros(get_model(cfg.model).num_states, device=dev)
        st[1] = float(course[0, 1])
        return st

    # (a) the draw kernel against its plain version ----------------------------
    record.update(draw_checks(dev, build_log, max_abs_err, counters_zero))

    # (b) eager RNG mode against kernel RNG mode -------------------------------
    arms_err = {}
    for preset in PRESET_MODELS:
        s = kernel_case(preset, K_MAIN, T_MAIN, seed=32)
        ctrl = ControllerState(s["u_prev"], SEED_31, STEP_31, key_of(SEED_31, STEP_31))
        args = (s["cfg"], ctrl, s["state"], s["path"], s["dt"], s["sp"], s["cp"])
        _, re_ = mppi_step(*args, model_params=s["mp"], lean=True)
        _, rk = mppi_step(*args, model_params=s["mp"], lean=True, use_kernel=True)
        torch.cuda.synchronize()
        err = float((re_.u_opt - rk.u_opt).abs().max())
        arms_err[s["model"]] = err
        print(f"[31 arms] {s['model']} K={K_MAIN} T={T_MAIN} RNG mode, same key: eager u_opt "
              f"vs kernel u_opt max abs err {err:.3e} (bound {u_bound(rk.u_opt):.3e})",
              flush=True)
        require(bool(torch.isfinite(re_.u_opt).all()) and err <= u_bound(rk.u_opt),
                f"[31] {s['model']}: eager vs kernel in RNG mode {err}")
    counters_zero("[31] arms")
    record["eager_vs_kernel_rng"] = arms_err

    # (c) compile_step(use_kernel=False) against op by op ----------------------
    sys.path.insert(0, str(ROOT / "examples"))
    import custom_model_torch as bicycle

    chains, replays = {}, {}
    cases = [("full_body", "full_body", {}), ("unicycle", "diff_drive", {}),
             ("full_body_elite", "full_body", {"elite_frac": ELITE}),
             ("full_body_adapt_sigma", "full_body", {"adapt_sigma": True}),
             ("bicycle_auto", None, {})]
    for name, preset, opts in cases:
        if preset is None:
            cfg, sp, cp, course, path = bicycle.make_problem(device=dev)
            solver = MPPISolver(cfg, use_kernel="auto", device=dev)
            require(solver.use_kernel is False, "[31] auto picked the kernel for the bicycle")
            compiled, fn = solver.compiled, solver.step
        else:
            cfg, sp, cp, course = PRESETS[preset](num_samples=K_MAIN, horizon=T_MAIN,
                                                  device=dev)
            path = PathBuffer.from_points(course, 0.1, device=dev)
            compiled = fn = compile_step(cfg, use_kernel=False, lean=True, **opts)
        state = on_course(cfg, course)
        u_dim = get_model(cfg.model).num_controls
        lean = preset is not None
        draw_fn.launches = fused_sample_rollout_cost.launches = 0
        c1 = ControllerState.initial(SEED_31, cfg.horizon, u_dim, device=dev)
        outs_g = []
        for i in range(EAGER_UPDATES):
            c1, r1 = fn(c1, state, path, 0.1 + 0.001 * i, sp, cp)
            outs_g.append(r1.u_opt)
        n_draw, n_fused = draw_fn.launches, fused_sample_rollout_cost.launches
        c2 = ControllerState.initial(SEED_31, cfg.horizon, u_dim, device=dev)
        outs_e = []
        for i in range(EAGER_UPDATES):
            c2, r2 = mppi_step(cfg, c2, state, path,
                               torch.full((), 0.1 + 0.001 * i, device=dev), sp, cp,
                               lean=lean, **opts)
            outs_e.append(r2.u_opt)
        g, e = torch.stack(outs_g), torch.stack(outs_e)
        bit = bool(torch.equal(g, e))
        err = float((g - e).abs().max())
        moved = bool((g[1:] - g[:-1]).abs().amax(dim=(1, 2)).min() > 0)
        require(err <= u_bound(e), f"[31] {name}: graphed eager vs op by op {err}")
        require(compiled.captures == 1, f"[31] {name}: {compiled.captures} captures")
        require(n_draw == EAGER_UPDATES and n_fused == 0,
                f"[31] {name}: {n_draw} draw, {n_fused} fused launches in {EAGER_UPDATES}")
        require(key_reads(c1) and c1.step == EAGER_UPDATES and
                c1.key.tolist() == c2.key.tolist(), f"[31] {name}: key {c1.key.tolist()}")
        require(moved, f"[31] {name}: two consecutive replays gave the same update")
        chains[name] = dict(bit_equal=bit, max_abs_err=err, updates=EAGER_UPDATES,
                            draw_launches=n_draw, k=cfg.num_samples, t=cfg.horizon)
        replays[name] = (fn, (c1, state, path, 0.1, sp, cp))
        print(f"[31 compile_step eager] {name} ({cfg.model} K={cfg.num_samples} "
              f"T={cfg.horizon}{', MPPISolver auto' if preset is None else ''}), "
              f"{EAGER_UPDATES} chained updates, dt varying: u_opt bit-equal to op by op "
              f"{bit} (max abs err {err:.3e}, bound {u_bound(e):.3e}); 1 capture; draw "
              f"launches {n_draw} (replays counted), fused 0; every update moved; key "
              f"{c1.key.tolist()} = [seed, step]", flush=True)
    record["compile_step"] = chains
    # the refusal: a user model whose step reads the card back to the host
    reads = register_model(Model(
        name="kinematic_bicycle_reads_host", state_names=bicycle.BICYCLE.state_names,
        control_names=bicycle.BICYCLE.control_names,
        step=lambda st, u, dt: bicycle.bicycle_step(st, u, dt) * (
            1.0 if float(u[..., 0].max()) < 1e9 else 0.0)))
    rcfg = SolverConfig(model=reads.name, num_samples=2048, horizon=20)
    _, rsp, rcp, rcourse, rpath = bicycle.make_problem(device=dev)
    rstep = compile_step(rcfg)
    draw_fn.launches = 0
    refused = None
    try:
        rstep(ControllerState.initial(0, 20, 2, device=dev), on_course(rcfg, rcourse), rpath,
              0.1, rsp, rcp)
    except ValueError as err:
        refused = str(err)
    torch.cuda.synchronize()
    require(refused is not None and "reads the card back to the host" in refused
            and rstep.captures == 0, f"[31] the reading model: {refused!r}, "
                                     f"{rstep.captures} captures")
    record["refusal"] = refused.split("\n")[0][:300]
    print(f"[31 refusal] compile_step of a user model whose step calls float() on a card "
          f"tensor raises ValueError, no capture: {record['refusal']}", flush=True)
    # no host sync in a replay: the steps, the fleet tick, the loop, the window
    fcfg, fsp, fcp, fcourse = PRESETS["diff_drive"](num_samples=K_FLEET, horizon=T_FLEET,
                                                    device=dev)
    fpath = PathBuffer.from_points(fcourse, 0.1, device=dev)
    fstates = torch.zeros((B_FLEET, 3), device=dev)
    fstates[:, 1] = float(fcourse[0, 1]) + torch.linspace(-0.4, 0.4, B_FLEET, device=dev)
    fdt = torch.full((), 0.1, device=dev)
    fstep = build_fleet_step(fcfg, use_kernel=False)
    fctrls, _ = fstep(init_fleet(fcfg, B_FLEET, seed=1, device=dev), fstates, fpath, fdt,
                      fsp, fcp)
    lcfg, lsp, lcp, lcourse = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN,
                                                   device=dev)
    lpath = PathBuffer.from_points(lcourse, 0.1, device=dev)
    lstart = torch.tensor([0.0, float(lcourse[0, 1]), 0.0, 0.0, 0.0], device=dev)
    ldt = torch.full((), 0.1, device=dev)

    def lrun(n, seed=0):
        return simulate(lcfg, ControllerState.initial(seed, T_MAIN, 5, device=dev), lstart,
                        lpath, ldt, lsp, lcp, num_steps=n, use_kernel=False,
                        with_stats=False)

    before = loop_mod.CYCLE.captures
    lrun(5)
    lrun(7, seed=3)
    loop_captures = loop_mod.CYCLE.captures - before
    pcfg, psp, pcp, pcourse = PRESETS["diff_drive"](num_samples=K_MAIN, horizon=T_MAIN,
                                                    device=dev)
    ppath = PathBuffer.from_points(pcourse, 0.1, device=dev)
    pstate = torch.tensor([0.0, float(pcourse[0, 1]), 0.0], device=dev)
    pdt = torch.full((), 0.1, device=dev)
    gwin = KeyedGraph(realtime.window)
    wkw = dict(model_params=None, use_kernel=False, lean=True)
    pc = ControllerState.initial(0, T_MAIN, 2, device=dev)
    wargs = (pc, ppath, pdt, pstate, psp, pcp, pcfg, 8, 0.02, wkw)
    gwin(*wargs, steps=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn, args in replays.values():
            ctrl = args[0]
            for _ in range(3):
                ctrl, _ = fn(ctrl, *args[1:])
        for _ in range(3):
            fctrls, _ = fstep(fctrls, fstates, fpath, fdt, fsp, fcp)
        lrun(5)
        gwin(*wargs, steps=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(loop_captures <= 1 and fstep.graphed.captures == 1 and gwin.captures == 1,
            f"[31] captures: loop {loop_captures}, fleet {fstep.graphed.captures}, window "
            f"{gwin.captures}")
    print(f"[31 captures] one capture a configuration: the eager fleet tick 1, the eager "
          f"loop's cycle {loop_captures} over two runs of 5 and 7 cycles, the M=8 eager "
          f"window 1; no host sync in a replay of the five compiled steps, the fleet tick, "
          f"a 5-cycle graphed eager loop nor the window", flush=True)
    counters_zero("[31] captures")

    # (d) the gates on the graphed eager paths ---------------------------------
    draw_fn.launches = fused_sample_rollout_cost.launches = 0
    out = run_tracking_experiment(lcfg, lsp, lcp, lcourse, num_steps=STEPS, use_kernel=False)
    n = draw_fn.launches
    launches["philox_eager_loop"] = n
    rmse = out["metrics"]["rmse"]
    require(rmse < 0.15 and n == STEPS and fused_sample_rollout_cost.launches == 0
            and key_reads(out["ctrl"]), f"[31] graphed eager loop: RMSE {rmse}, {n} draws")
    draw_fn.launches = 0
    fctrls = init_fleet(fcfg, B_FLEET, seed=1, device=dev)
    fs = fstates
    fm = get_model(fcfg.model)
    for _ in range(STEPS):
        fctrls, fres = fstep(fctrls, fs, fpath, fdt, fsp, fcp)
        fs = fm.step(fs, fres.u0, fdt)
    final = fs.cpu().numpy()
    d = np.min(np.linalg.norm(final[:, None, :2] - fcourse[None], axis=-1), axis=1)
    nf = draw_fn.launches
    require(bool((d < 0.3).all()) and nf == STEPS and key_reads(fctrls)
            and fstep.graphed.captures == 1,
            f"[31] graphed eager fleet: worst robot {d.max()} m, {nf} draws")
    draw_fn.launches = 0
    piped = realtime.run_pipelined_experiment(pcfg, psp, pcp, pcourse, hz=50.0,
                                              num_cycles=96, use_kernel=False, micro_batch=8)
    np_ = draw_fn.launches
    pipe_rs, pipe_dm = piped["rate_stats"], piped["dispatch_ms"]
    require(pipe_rs["deadline_misses"] == 0 and piped["metrics"]["rmse"] < 0.5
            and np_ == (96 // 8 + 1) * 8,
            f"[31] pipelined eager M=8: {pipe_rs['deadline_misses']} misses, RMSE "
            f"{piped['metrics']['rmse']}, {np_} draws")
    record["gates"] = dict(
        loop_rmse=rmse, loop_draws=n, fleet_worst_m=float(d.max()), fleet_draws=nf,
        pipelined_m8_misses=pipe_rs["deadline_misses"], pipelined_m8_dispatch_ms=pipe_dm,
        pipelined_m8_rmse=piped["metrics"]["rmse"], pipelined_m8_draws=np_)
    print(f"[31 gates] graphed eager loop {STEPS} cycles full_body K={K_MAIN} T={T_MAIN}: "
          f"RMSE {rmse:.4f} m, {n} draw launches, 0 fused; graphed eager fleet {STEPS} ticks "
          f"B={B_FLEET} K={K_FLEET} T={T_FLEET}: every robot within {d.max():.4f} m, {nf} "
          f"draw launches; pipelined eager M=8 diff_drive 50 Hz 96 cycles: "
          f"{pipe_rs['deadline_misses']} misses, a window's dispatch mean "
          f"{pipe_dm['mean']:.4f} ms max {pipe_dm['max']:.4f} ms, RMSE "
          f"{piped['metrics']['rmse']:.4f} m, {np_} draw launches (the cycles and the "
          f"warm-up window) on {card}", flush=True)
    counters_zero("[31] gates")

    # (e) timing: op by op against graphed, in turns; memory --------------------
    arms, per = {}, {}
    s = kernel_case("full_body", K_MAIN, T_MAIN, roll_off=True, seed=5)
    step_args = (s["state"], s["path"], s["dt"], s["sp"], s["cp"])

    def chain(fn, cfg, u_dim, args, **kw):
        carry = [ControllerState.initial(0, cfg.horizon, u_dim, device=dev)]

        def call():
            carry[0], _ = fn(carry[0], *args, **kw)
        return call

    comp = compile_step(s["cfg"], use_kernel=False, lean=True)
    arms["eager_update/op_by_op"] = (chain(functools.partial(
        mppi_step, s["cfg"], lean=True), s["cfg"], 5, step_args, model_params=s["mp"]), 5)
    arms["eager_update/graphed"] = (chain(comp, s["cfg"], 5, step_args,
                                          model_params=s["mp"]), 20)
    fc = [init_fleet(fcfg, B_FLEET, seed=1, device=dev)] * 2

    def tick_eager():
        fc[0], _ = batch_mod._tick(fc[0], fpath, fdt, fstates, fsp, fcp, None, None, fcfg,
                                   False)

    def tick_graphed():
        fc[1], _ = fstep(fc[1], fstates, fpath, fdt, fsp, fcp)

    arms["eager_fleet/op_by_op"], arms["eager_fleet/graphed"] = (tick_eager, 5), (
        tick_graphed, 20)
    mp = get_model("full_body").default_params(device=dev)
    static = (lcfg, loop_mod.Plant(model_name="full_body"),
              {"use_kernel": False, "lean": False}, True, False)

    def loop_eager():
        c = ControllerState.initial(0, T_MAIN, 5, device=dev)
        cuda_graph.scan(loop_mod.cycle, (c, lstart, None), lpath, ldt, lsp, lcp, mp, *static,
                        length=STEPS)

    def loop_graphed():
        simulate(lcfg, ControllerState.initial(0, T_MAIN, 5, device=dev), lstart, lpath,
                 ldt, lsp, lcp, model_params=mp, num_steps=STEPS, use_kernel=False)

    arms["eager_loop200/op_by_op"], arms["eager_loop200/graphed"] = (loop_eager, 1), (
        loop_graphed, 1)
    per["eager_loop200"] = STEPS
    bcfg, bsp, bcp, bcourse, bpath = bicycle.make_problem(device=dev)
    bsolver = MPPISolver(bcfg, use_kernel="auto", device=dev)
    bargs = (on_course(bcfg, bcourse), bpath, 0.1, bsp, bcp)
    arms["bicycle_auto/op_by_op"] = (chain(functools.partial(mppi_step, bcfg), bcfg, 2,
                                           bargs), 10)
    arms["bicycle_auto/graphed"] = (chain(bsolver.step, bcfg, 2, bargs), 20)
    dkey = key_of(SEED_31, STEP_31)
    dkw = dict(num_samples=K_MAIN, tm1=T_MAIN - 1, u_dim=5)
    arms["draw/kernel"] = (lambda: draw_fn(dkey, **dkw), 50)
    arms["draw/plain"] = (lambda: philox_normals(dkey[0], dkey[1], K_MAIN, T_MAIN - 1, 5,
                                                 device=dev), 3)
    arms["draw/randn"] = (lambda: torch.randn((T_MAIN - 1, K_MAIN, 5), device=dev), 50)
    # meta_train's step draw: a replay of one graph of 50 launches (the
    # host's enqueue of one launch takes longer than the kernel)
    mb, mtm1, mk, mu = META_DRAW
    arms["draw_graph50/meta_train"] = (graph_replay(functools.partial(
        draw_fn, dkey, num_samples=mk, tm1=mtm1, u_dim=mu, robots=mb), 50), 1)
    per["draw_graph50"] = 50
    host = {name: [] for name in arms}
    kl = {name: [0, 0] for name in arms}

    def wrap(name, fn):
        def call():
            before = draw_fn.launches
            t0 = time.perf_counter()
            fn()
            host[name].append(time.perf_counter() - t0)
            kl[name][0] += draw_fn.launches - before
            kl[name][1] += 1
        return call

    reps = 5
    times = time_interleaved({name: (wrap(name, fn), inner)
                              for name, (fn, inner) in arms.items()}, reps)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    timing = {}
    for name, v in times.items():
        div = per.get(name.split("/")[0], 1)
        timing[name] = dict(
            ms=statistics.median(v) / div, ms_min=min(v) / div, ms_max=max(v) / div,
            host_us=statistics.median(host[name]) * 1e6 / div,
            draw_launches=kl[name][0] / kl[name][1] / div)
        times_out[name] = timing[name]["ms"]
    # the device's busy share and device events a call, each arm but the draw
    for name, fn in (("eager_update/graphed", arms["eager_update/graphed"][0]),
                     ("eager_update/op_by_op", arms["eager_update/op_by_op"][0]),
                     ("eager_fleet/graphed", tick_graphed),
                     ("eager_fleet/op_by_op", tick_eager),
                     ("bicycle_auto/graphed", arms["bicycle_auto/graphed"][0]),
                     ("bicycle_auto/op_by_op", arms["bicycle_auto/op_by_op"][0])):
        busy, events = busy_share(fn, 10, timing[name]["ms"])
        timing[name].update(busy=busy, device_events=events)
    loop_busy, loop_events = busy_share(lambda: simulate(
        lcfg, ControllerState.initial(0, T_MAIN, 5, device=dev), lstart, lpath, ldt, lsp,
        lcp, model_params=mp, num_steps=20, use_kernel=False), 1,
        20 * timing["eager_loop200/graphed"]["ms"])
    timing["eager_loop200/graphed"].update(busy=loop_busy, device_events=loop_events / 20)
    record["timing"] = timing
    record["host_split_us_eager_update"] = host_split(comp.graph, comp._args(
        ControllerState.initial(0, T_MAIN, 5, device=dev), *step_args, model_params=s["mp"]))
    # peak device memory of the eager flagship update: op by op, and captured
    # and replayed (the graph's pool holds the draw and the intermediates)
    torch.cuda.synchronize()
    memory = {}
    for arm in ("op_by_op", "graphed"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn = (functools.partial(mppi_step, s["cfg"], lean=True) if arm == "op_by_op"
              else compile_step(s["cfg"], use_kernel=False, lean=True))
        c = ControllerState.initial(0, T_MAIN, 5, device=dev)
        for _ in range(3):
            c, _ = fn(c, *step_args, model_params=s["mp"])
        torch.cuda.synchronize()
        memory[arm] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        del fn, c
    record["peak_memory_mib_eager_update"] = memory
    print(f"[31 timing] median of {reps} rounds in turns, CUDA events (ms a call; the loop "
          f"a cycle), host us a call, draw-kernel launches a call (replays counted), busy "
          f"share and device events a call by torch.profiler, on {card} (after: sm clock, "
          f"draw, limit, temp = {clocks})", flush=True)
    for name, tm in timing.items():
        extra = ""
        if "busy" in tm:
            busy = "not measured" if tm["busy"] is None else f"{100 * tm['busy']:.1f} %"
            extra = f", busy {busy}, {tm['device_events']:.1f} device events"
        print(f"  {name}: {tm['ms']:.4f} ms [{tm['ms_min']:.4f}, {tm['ms_max']:.4f}], host "
              f"{tm['host_us']:.1f} us, {tm['draw_launches']:.2f} draw launches{extra}",
              flush=True)
    print(f"  draw kernel {timing['draw/kernel']['ms']:.4f} ms against its bound "
          f"{philox_bound()[0]:.4f} ms; torch.randn of the same shape "
          f"{timing['draw/randn']['ms']:.4f} ms (a different stream: a yardstick only); at "
          f"meta_train's (64, 7, 64, 2) {timing['draw_graph50/meta_train']['ms']:.4f} ms "
          f"(a graph's replay of 50 launches) against "
          f"{philox_bound(*META_DRAW)[0]:.4f} ms", flush=True)
    print("  host us of a graphed eager update: " + ", ".join(
        f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in record["host_split_us_eager_update"].items()), flush=True)
    print(f"  peak device memory of the eager full_body update K={K_MAIN} T={T_MAIN} above "
          f"what was allocated before: op by op {memory['op_by_op']:.1f} MiB, captured and "
          f"replayed {memory['graphed']:.1f} MiB", flush=True)
    counters_zero("[31] timing")
    record["seconds"] = time.perf_counter() - t_phase
    print(f"[31 eager compiled] done in {record['seconds']:.1f} s", flush=True)
    return record


def philox_bound(robots=1, tm1=T_MAIN - 1, k=K_MAIN, u_dim=5):
    """A draw's bound: kernels/rollout_cost.py philox_normals_bound_ms, by
    default at the flagship (B, T-1, K, U) = (1, T_MAIN-1, K_MAIN, 5)."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import philox_normals_bound_ms

    return philox_normals_bound_ms(k, tm1, u_dim, robots)


# phase 32: the three cells of tests/test_quality_matrix.py at --quick,
# (controller, course, v_ref)
QUICK_CELLS = (("diff_drive", "cosine_A1.0_f0.25", 1.2),
               ("steering", "filtered_square", 1.2),
               ("full_body", "cosine_A1.5_f0.127", 2.0))


def quick_cell_gate(ctrl_name, cell, pp):
    """tests/test_quality_matrix.py's gate of the cell: (ok, what it held)."""
    if ctrl_name == "diff_drive":
        return (cell["completed"] and cell["rmse_m"] <= pp["rmse_m"] and cell["rmse_m"] < 0.15,
                "completed, rmse <= pure pursuit's, rmse < 0.15 m")
    if ctrl_name == "steering":
        return (cell["rmse_m"] <= pp["rmse_m"] and cell["max_error_m"] < pp["max_error_m"],
                "rmse <= pure pursuit's, max error < pure pursuit's")
    return (cell["completed"] and cell["rmse_m"] <= max(pp["rmse_m"], 0.12),
            "completed, rmse <= max(pure pursuit's, 0.12 m)")


def phase_32(dev, card, counters_zero):
    """Phase 32: the reference's evaluations on the card. (a) the three
    quick-matrix cells of tests/test_quality_matrix.py through
    scripts/torch_quality_matrix.py (auto: the fused kernel), with its gates
    and exact launch counts, and the refined arm's cycle captured once over
    two seeds; (b) pure pursuit's graphed scan bit-equal to its cycle run op
    by op on the card, one capture; (c) the robustness twins
    (tests/test_torch_robustness.py) on the card: 500 cycles, the course
    end, the dkan corridor, 50 dt-jittered ControlLoop cycles with one
    capture; (d) scripts/torch_realtime_session.py's three arms, shortened:
    the device arm at 500 Hz for 2 s (1000 cycles, one fused launch a cycle),
    the host loop at 10 Hz and the pipelined loop at 25 Hz for 2 s each.
    Returns (its JSON record, {kernels entry: {run: launches}})."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_quality_matrix as qm
    import torch_realtime_session as rs

    from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
        philox_normals_cuda,
    )
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, sum_of_cosines_course
    from ccv_mppi_path_tracker_tpu_torch.paths.courses import dkan_course
    from ccv_mppi_path_tracker_tpu_torch.paths.spline import spline_resample_course
    from ccv_mppi_path_tracker_tpu_torch.runtime import (
        ControlLoop,
        pure_pursuit,
        run_tracking_experiment,
    )
    from ccv_mppi_path_tracker_tpu_torch.runtime import loop as loop_mod
    from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph

    fused, draw = fused_sample_rollout_cost, philox_normals_cuda
    t_phase = time.perf_counter()
    record = {"card": card}
    counts = {}

    def counted(fn):
        """(fn(), fused launches, draw launches), both counts set to 0 just
        before fn and read just after."""
        fused.launches = draw.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, fused.launches, draw.launches

    # (a) the quick-matrix cells ------------------------------------------------
    courses = qm.courses()
    cells = {}
    for ctrl_name, course_name, v in QUICK_CELLS:
        course = courses[course_name]
        cfg, sp, cp = qm.controller_configs(v, quick=True, device=dev)[ctrl_name]
        uk = qm.solver_path(cfg.model, "auto", dev)
        steps = qm.num_steps_for(course, v, quick=True)
        t0 = time.perf_counter()
        cell, nf, nd = counted(lambda: qm.eval_mppi(cfg, sp, cp, course, v, quick=True,
                                                    use_kernel=uk))
        sec = time.perf_counter() - t0
        pp = qm.eval_pure_pursuit(course, v, quick=True, device=dev)
        ok, what = quick_cell_gate(ctrl_name, cell, pp)
        tag = f"{ctrl_name}/{course_name}/v={v}"
        print(f"[32 matrix] {tag} [{'kernel' if uk else 'eager'}] {cell}; pure pursuit "
              f"{pp}; gate ({what}) {'ok' if ok else 'FAILED'}; {nf} fused launches for "
              f"{steps} cycles, {sec:.2f} s; {card}", flush=True)
        require(uk and ok and nf == steps and nd == 0,
                f"[32] {tag}: kernel {uk}, gate {what}: {cell} vs {pp}; {nf} launches "
                f"for {steps} cycles, {nd} draws")
        counts.setdefault(f"rollout_cost_{cfg.model}", {})[f"quick_matrix/{tag}"] = nf
        cells[tag] = {"mppi": cell, "pure_pursuit": pp, "launches": nf, "seconds": sec}
        counters_zero(f"[32] {tag}")
    # the refined arm: one capture of its cycle for the (controller, course)
    # shape, whatever the seed
    ctrl_name, course_name, v = QUICK_CELLS[0]
    course = courses[course_name]
    cfg, sp, cp = qm.controller_configs(v, quick=True, device=dev)[ctrl_name]
    before = loop_mod.CYCLE.captures
    t0 = time.perf_counter()
    refined, nf, _ = counted(lambda: qm.eval_mppi_seeds(
        cfg, sp, cp, course, v, seeds=(0, 1), quick=True, use_kernel=True,
        solver_options=dict(qm.REFINE_OPTS)))
    sec = time.perf_counter() - t0
    captured = loop_mod.CYCLE.captures - before
    steps = qm.num_steps_for(course, v, quick=True)
    print(f"[32 matrix] refined {ctrl_name}/{course_name}/v={v}, seeds 0 and 1: {refined}; "
          f"{captured} capture, {nf} fused launches for {2 * steps} cycles, {sec:.2f} s; "
          f"{card}", flush=True)
    require(captured == 1 and nf == 2 * steps and refined["rmse_m"] < 0.15,
            f"[32] refined: {captured} captures over two seeds, {nf} launches, {refined}")
    cells["refined"] = {"mppi_refined": refined, "captures": captured, "seconds": sec}
    record["quick_matrix"] = cells
    counters_zero("[32] refined")

    # (b) pure pursuit's graphed scan against its cycle op by op ----------------
    course = courses["dkan"]
    pp_cfg = pure_pursuit.PurePursuitConfig(lookahead=0.85, v_ref=1.1, w_max=2.0)
    pp_steps = 400
    before = pure_pursuit.CYCLE.captures
    graphed = [pure_pursuit.run_pure_pursuit_experiment(course, num_steps=pp_steps,
                                                        cfg=pp_cfg, device=dev)
               for _ in range(2)]
    captured = pure_pursuit.CYCLE.captures - before
    path = PathBuffer.from_points(course, 0.1, device=dev).with_count_tensor()
    heading = float(np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0]))
    state0 = torch.tensor([course[0, 0], course[0, 1], heading], device=dev)

    def op_by_op():
        return cuda_graph.scan(pure_pursuit.cycle, state0, path, pp_cfg, 0.1,
                               length=pp_steps)[1]

    ref = {k: t.cpu().numpy() for k, t in op_by_op().items()}
    same = all(np.array_equal(g["logs"][k], ref[k]) for g in graphed for k in ref)
    times = {}
    for name, fn in (("graphed", lambda: pure_pursuit.CYCLE.scan(
            state0, path, pp_cfg, 0.1, length=pp_steps)[1]["state"].cpu()),
            ("op_by_op", lambda: op_by_op()["state"].cpu())):
        t0 = time.perf_counter()
        fn()
        times[name] = (time.perf_counter() - t0) / pp_steps * 1e3
    rmse = graphed[0]["metrics"]["rmse"]
    print(f"[32 pure pursuit] dkan, {pp_steps} cycles: graphed scan bit-equal to the "
          f"cycle op by op on the card {same}, {captured} capture over two runs; "
          f"{times['graphed']:.4f} ms a cycle graphed, {times['op_by_op']:.4f} op by op "
          f"(host clock, one run each); RMSE {rmse:.4f} m; {card}", flush=True)
    require(same and captured == 1 and rmse < 0.3,
            f"[32] pure pursuit: bit-equal {same}, {captured} captures, RMSE {rmse}")
    record["pure_pursuit"] = {"bit_equal": same, "captures": captured,
                              "ms_per_cycle": times, "rmse_m": rmse}

    # (c) the robustness twins ---------------------------------------------------
    cfg, sp, cp, dd_course = diff_drive_launch(num_samples=256, device=dev)
    rob = {}
    long_course = sum_of_cosines_course(
        amplitudes=(1.0, 0, 0), frequencies=(0.25, 0, 0), deltas=(0, 0, 0),
        resolution=0.1, course_length=60.0, dtype=np.float32)
    out, nf, nd = counted(lambda: run_tracking_experiment(cfg, sp, cp, long_course,
                                                          num_steps=500))
    logs = out["logs"]
    ok = (np.isfinite(logs["state"]).all() and np.isfinite(logs["u0"]).all()
          and np.abs(logs["u0"][:, 0]).max() <= float(sp.u_max[0]) + 1e-5
          and out["metrics"]["rmse"] < 0.15 and logs["state"][-1, 0] > 30.0)
    rob["long_run_500"] = {"rmse_m": out["metrics"]["rmse"], "x_end_m": float(logs["state"][-1, 0]),
                           "draws": nd}
    require(ok and nd == 500 and nf == 0, f"[32] long run: {rob['long_run_500']}, {nf} fused")
    counts.setdefault("philox_normals", {})["robustness/long_run_500"] = nd
    out, _, nd = counted(lambda: run_tracking_experiment(cfg, sp, cp, dd_course[:40],
                                                         num_steps=120))
    final = float(np.hypot(*(out["logs"]["state"][-1, :2] - dd_course[39])))
    rob["course_end"] = {"final_distance_m": final, "draws": nd}
    require(np.isfinite(out["logs"]["state"]).all() and final < 1.0 and nd == 120,
            f"[32] course end: {rob['course_end']}")
    raw = dkan_course(resolution=0.1).astype(np.float32)
    smooth = spline_resample_course(
        [[0.0, 0.0], [8.0, 0.0], [17.7, 0.0], [17.7, 4.0], [17.7, 8.0],
         [9.0, 8.0], [0.0, 8.0]], resolution=0.1).astype(np.float32)
    out = run_tracking_experiment(cfg, sp, cp, raw, num_steps=200)
    out2 = run_tracking_experiment(cfg, sp, cp, smooth, num_steps=200)
    rob["dkan"] = {"raw_max_error_m": out["metrics"]["max_error"],
                   "raw_x_end_m": float(out["logs"]["state"][-1, 0]),
                   "spline_rmse_m": out2["metrics"]["rmse"]}
    require(out["metrics"]["max_error"] < 0.6 and out["logs"]["state"][-1, 0] > 15.0
            and out2["metrics"]["rmse"] < 0.2, f"[32] dkan: {rob['dkan']}")
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=PathBuffer.from_points(dd_course, 0.1,
                                                                          device=dev))
    plant = get_model(cfg.model)
    rng = np.random.RandomState(0)
    state = torch.tensor([dd_course[0, 0], dd_course[0, 1], 0.0], device=dev)

    def jitter():
        nonlocal state
        traj = [state.cpu().numpy()]
        for _ in range(50):
            dt = float(rng.uniform(0.08, 0.12))
            res = loop.step(state, dt=dt)
            state = plant.step(state, res.u0, torch.tensor(dt, device=dev))
            traj.append(state.cpu().numpy())
        return tracking_metrics(np.stack(traj)[:, :2], dd_course)

    m, _, nd = counted(jitter)
    rob["dt_jitter_50"] = {"rmse_m": m["rmse"], "captures": loop.compiled.captures,
                           "draws": nd}
    require(loop.compiled.captures == 1 and m["rmse"] < 0.2 and nd == 50,
            f"[32] dt jitter: {rob['dt_jitter_50']}")
    print(f"[32 robustness] on the card, diff_drive K=256 eager (graphed): {rob}; {card}",
          flush=True)
    record["robustness"] = rob
    counters_zero("[32] robustness")

    # (d) the serving session's arms, shortened ---------------------------------
    session = {}
    dev_arm, nf, _ = counted(lambda: rs.device_arm(hz=500.0, seconds=2.0, device=dev))
    session["device_arm"] = dev_arm
    print(f"[32 session] device arm, full_body K={dev_arm['num_samples']} "
          f"T={dev_arm['horizon']} at 500 Hz for 2 s: {dev_arm['cycles']} cycles in "
          f"{dev_arm['wall_seconds']} s = {dev_arm['sustained_hz']} Hz sustained, "
          f"{dev_arm['per_cycle_ms']} ms a cycle, capture {dev_arm['compile_s']} s, "
          f"{dev_arm['captures']} capture, {dev_arm['kernel_launches']} launches in the "
          f"timed run; tracking {dev_arm['tracking']}; {card}", flush=True)
    require(dev_arm["cycles"] == 1000 and dev_arm["kernel_launches"] == 1000
            and dev_arm["captures"] == 1 and nf == 1001
            and dev_arm["tracking"]["rmse"] < 0.15,
            f"[32] device arm: {dev_arm}, {nf} launches with its capture run")
    counts.setdefault("rollout_cost_full_body", {})["session/device_arm_500hz_2s"] = (
        dev_arm["kernel_launches"])
    # the reference's own rate: the host loop's solver dt is the measured one
    hosts, nf, _ = counted(lambda: rs.host_arm(rates=(10.0,), seconds=2.0, device=dev))
    session["host_arm"] = hosts[0]
    print(f"[32 session] host arm 10 Hz for 2 s: {hosts[0]}; {nf} fused launches; {card}",
          flush=True)
    require(hosts[0]["rate_stats"]["cycles"] == 20 and nf == 21
            and hosts[0]["tracking"]["rmse"] < 0.15, f"[32] host arm: {hosts[0]}, {nf}")
    counts["rollout_cost_full_body"]["session/host_arm_10hz_2s"] = nf
    (piped, _), nf, _ = counted(lambda: rs.pipelined_arm(arms=((25.0, 1),), seconds=2.0,
                                                         device=dev, pairs=()))
    session["pipelined_arm"] = piped[0]
    print(f"[32 session] pipelined arm 25 Hz M=1 for 2 s: {piped[0]}; {nf} fused "
          f"launches; {card}", flush=True)
    require(piped[0]["rate_stats"]["cycles"] == 50 and nf == 51
            and piped[0]["tracking"]["rmse"] < 0.15, f"[32] pipelined arm: {piped[0]}, {nf}")
    counts["rollout_cost_full_body"]["session/pipelined_25hz_2s"] = nf
    record["session"] = session
    counters_zero("[32] session")
    record["seconds"] = time.perf_counter() - t_phase
    print(f"[32 evaluations] done in {record['seconds']:.1f} s; {card}", flush=True)
    return record, counts

def _flat(obj):
    """The tensors of ``obj`` (a program's result), in order."""
    from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import split_tensors

    leaves = []
    split_tensors(obj, leaves)
    return leaves


def graphed_against_eager(name, program, card, phase=33):
    """One of diff/'s programs on the card, eager (utils/cuda_graph.scan, or
    its function called) and graphed (Graphed.scan, or a Graphed call) in
    turns E G G E, after the capturing first graphed call (timed apart). The
    replays run under sync debug mode "error": no host read inside the loop.
    Returns (its record: the wall ms of each arm (host clock, synchronized),
    the captures, the max |delta| between the arms' outputs (gated at rtol
    1e-5 of each output's scale) and whether they are bit-equal; the graphed
    output)."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import refuse_host_syncs

    program.graphed.graphs.clear()  # an earlier phase may hold this shape's graph
    before = program.graphed.captures

    def timed(fn, refuse=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with refuse_host_syncs(f"the replay of {name}") if refuse else contextlib.nullcontext():
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    first_ms, _ = timed(program.replay)
    times = {"eager": [], "graphed": []}
    outs = {}
    for arm in ("eager", "graphed", "graphed", "eager"):
        ms, outs[arm] = (timed(program.eager) if arm == "eager"
                         else timed(program.replay, refuse=True))
        times[arm].append(ms)
    captures = program.graphed.captures - before
    eager, graphed = _flat(outs["eager"]), _flat(outs["graphed"])
    require(len(eager) == len(graphed), f"[{phase}] {name}: the arms' outputs differ in "
            "structure")
    delta = max(float((g - e).abs().max()) for g, e in zip(graphed, eager))
    within = all(bool(((g - e).abs() <= 1e-5 * e.abs().max()).all())
                 for g, e in zip(graphed, eager))
    same = all(torch.equal(g, e) for g, e in zip(graphed, eager))
    rec = {"steps": program.length, "eager_ms": times["eager"], "graphed_ms": times["graphed"],
           "first_graphed_ms_with_capture": first_ms, "captures": captures,
           "max_abs_delta": delta, "bit_equal": same}
    print(f"[{phase} {name}] {program.length or 1} step(s): eager "
          f"{', '.join(f'{t:.2f}' for t in times['eager'])} ms, graphed "
          f"{', '.join(f'{t:.2f}' for t in times['graphed'])} ms (first with its capture "
          f"{first_ms:.2f}); {captures} capture; max |delta| {delta:.3e}, bit-equal {same}; "
          f"{card}", flush=True)
    require(captures == 1 and within, f"[{phase}] {name}: {captures} captures, graphed against "
            f"eager max |delta| {delta} beyond rtol 1e-5")
    return rec, outs["graphed"]


def phase_33(dev, card, counters_zero):
    """Phase 33: the differentiable side's compiled programs (diff/optim.py):
    fit_control_gains (the sysid data, 300 steps), fit_full_body_params (500),
    the chunked rollout gradient (num_chunks 1, 4, 8), fit_sampler (300),
    meta_train (120) and evaluate_rule, each eager and graphed in turns
    (:func:`graphed_against_eager`), float32, the generators on the CPU; phase
    23's gates on the graphed results; one graphed meta_train step at the
    fleet cell's width (diff_drive K=1024 T=15, batch 32), its ms and the
    memory it holds; scripts/torch_learning_eval.py --quick with each claim
    pointing the JAX artifact's way. Returns (its JSON record, {kernels entry:
    {run: launches}})."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_learning_eval as tle

    from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu_torch.diff import (
        ControlGains,
        SamplerNet,
        UpdateRule,
        collect_imitation_data,
        proposal_mean,
    )
    from ccv_mppi_path_tracker_tpu_torch.diff.learned_optimizer import (
        _evaluate_rule_program,
        _meta_train_program,
    )
    from ccv_mppi_path_tracker_tpu_torch.diff.learned_sampler import _fit_sampler_program
    from ccv_mppi_path_tracker_tpu_torch.diff.system_id import (
        _fit_control_gains_program,
        _fit_full_body_params_program,
        _rollout_gradient_program,
    )
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
        philox_normals_cuda,
    )
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params, zmp_chain
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step

    t_phase = time.perf_counter()
    fused, draw = fused_sample_rollout_cost, philox_normals_cuda
    record = {"card": card}
    counts = {"philox_normals": {}}

    def gen(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return g

    def counted(name, program):
        """graphed_against_eager with the draw launches of the graphed arm's
        replay-only call (counted from 0 just before it, read just after)."""
        rec, out = graphed_against_eager(name, program, card)
        fused.launches = draw.launches = 0
        program.replay()
        torch.cuda.synchronize()
        rec["draw_launches_graphed"] = draw.launches
        require(fused.launches == 0, f"[33] {name}: {fused.launches} fused launches")
        record[name] = rec
        return out

    # the sysid command's data (cli.py cmd_sysid), float32
    rng = np.random.RandomState(0)
    true_gains = torch.tensor([0.85, 1.1], device=dev)
    states = torch.tensor(rng.randn(2048, 3), dtype=torch.float32, device=dev)
    controls = torch.tensor(rng.randn(2048, 2), dtype=torch.float32, device=dev)
    nxt = get_model("unicycle").step(states, controls * true_gains, 0.1)
    ((gains,), _), _ = counted("fit_control_gains", _fit_control_gains_program(
        "unicycle", states, controls, nxt, 0.1, num_steps=300))
    gains_rel = float((gains / true_gains - 1).abs().max())
    record["fit_control_gains"]["gains_rel_err"] = gains_rel
    require(gains_rel <= 1e-3, f"[33] fit_control_gains: gains {gains.tolist()}")

    # tests/test_diff.py:71-88's data, float32
    rng = np.random.RandomState(2)
    f32 = dict(dtype=torch.float32, device=dev)
    zstates = torch.tensor(rng.randn(12, 64, 5) * 0.2, **f32)
    zcontrols = torch.tensor(rng.randn(11, 64, 5) * 0.5, **f32)
    true = default_params(**f32)
    observed = zmp_chain(zstates, zcontrols, 0.1, true)[..., 1]
    init = dataclasses.replace(true, base2com=torch.full((), 0.6, **f32))
    ((_, base2com), _), losses = counted("fit_full_body_params", _fit_full_body_params_program(
        zstates, zcontrols, observed, 0.1, init, num_steps=500, learning_rate=0.02))
    com_rel = abs(float(base2com) / float(true.base2com) - 1.0)
    record["fit_full_body_params"]["base2com_rel_err"] = com_rel
    require(com_rel <= 0.02, f"[33] fit_full_body_params: base2com {float(base2com)}")

    # tests/test_diff.py:222-228's data, float32
    rng = np.random.RandomState(3)
    rargs = (torch.zeros((128, 3), **f32), torch.tensor(rng.randn(16, 128, 2) * 0.5, **f32),
             torch.tensor(rng.randn(16, 128, 3) * 0.1, **f32))
    for nc in (1, 4, 8):
        counted(f"rollout_prediction_value_and_grad/num_chunks={nc}",
                _rollout_gradient_program("unicycle", ControlGains(
                    torch.tensor([1.1, 0.9], **f32)), *rargs, 0.1, num_chunks=nc))

    # the learned sampler, scripts/learning_eval.py:44-50's sizes
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=10, device=dev)
    feats, targets = collect_imitation_data(cfg, sp, cp, course, gen(0), num_states=96,
                                            solve_cycles=6)
    (params, _), losses = counted("fit_sampler", _fit_sampler_program(
        feats, targets, gen(1), hidden=32, num_steps=300))
    net = SamplerNet(*params)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    dt = torch.full((), 0.1, device=dev)
    step = compile_step(cfg, use_kernel=False)
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
        first = [float(step(ControllerState(u, 100 + i, 0), state, path, dt, sp,
                            cp)[1].stats["min_cost"]) for u in (u_net, torch.zeros_like(u_net))]
        wins += first[0] <= first[1]
    loss0, loss1 = float(losses[0]), float(losses[-1])
    record["fit_sampler"].update(loss_first=loss0, loss_last=loss1, wins=wins)
    print(f"[33 fit_sampler] graphed: loss {loss0:.4f} -> {loss1:.4f}; the proposal won "
          f"{wins} of 6 cold starts", flush=True)
    require(loss1 < 0.5 * loss0 and wins >= 5, "[33] the learned sampler")

    # the learned update rule, scripts/learning_eval.py:103-106's sizes
    cfg, sp, cp, course = diff_drive_launch(num_samples=64, horizon=8, device=dev)
    (params, _, _), losses = counted("meta_train", _meta_train_program(
        cfg, sp, cp, course, gen(0), num_steps=120, batch=32, iterations=2))
    n = record["meta_train"]["draw_launches_graphed"]
    counts["philox_normals"]["meta_train_graphed_120_steps"] = n
    require(n == 120, f"[33] meta_train: {n} draw launches for 120 replayed steps")
    rule = UpdateRule(*params)
    costs = {}
    for arm, r in (("vanilla", None), ("learned", rule)):
        costs[arm] = float(counted(f"evaluate_rule/{arm}", _evaluate_rule_program(
            cfg, r, sp, cp, course, gen(1234), iterations=2)))
    first20, last20 = float(losses[:20].mean()), float(losses[-20:].mean())
    record["meta_train"].update(loss_first20=first20, loss_last20=last20, **costs)
    print(f"[33 meta_train] graphed: mean loss of the first 20 steps {first20:.4f}, of the "
          f"last 20 {last20:.4f}; held-out realized cost vanilla {costs['vanilla']:.4f}, "
          f"learned {costs['learned']:.4f}; {n} draw launches in 120 replayed steps",
          flush=True)
    require(last20 < first20 and costs["learned"] < costs["vanilla"], "[33] meta_train")

    # one graphed meta_train step at the fleet cell's width
    cfg, sp, cp, course = diff_drive_launch(num_samples=K_FLEET, horizon=T_FLEET, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    wide = _meta_train_program(cfg, sp, cp, course, gen(0), num_steps=20, batch=32)
    wide.graphed.graphs.clear()
    wide.replay()  # the capture
    held = torch.cuda.memory_allocated() - base
    fused.launches = draw.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, wide_losses = wide.replay()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / wide.length
    peak = torch.cuda.max_memory_allocated() - base
    record["meta_train_fleet_width"] = {
        "num_samples": K_FLEET, "horizon": T_FLEET, "batch": 32, "ms_per_step": step_ms,
        "held_mib": held / 2**20, "peak_mib": peak / 2**20, "draw_launches": draw.launches}
    print(f"[33 meta_train at the fleet width] diff_drive K={K_FLEET} T={T_FLEET}, batch 32, "
          f"2 iterations: {step_ms:.3f} ms a graphed step over {wide.length} replays, "
          f"{draw.launches} draw launches; holds {held / 2**20:.1f} MiB after its capture, "
          f"peak {peak / 2**20:.1f} MiB; {card}", flush=True)
    require(draw.launches == wide.length and bool(torch.isfinite(wide_losses).all()),
            "[33] meta_train at the fleet width")
    counts["philox_normals"]["meta_train_fleet_width_20_steps"] = draw.launches
    wide.graphed.graphs.clear()

    # the twin of scripts/learning_eval.py, --quick
    fused.launches = draw.launches = 0
    t0 = time.perf_counter()
    out = tle.run(quick=True, device=dev)
    sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    directions = tle.directions(out)
    record["learning_eval_quick"] = {"seconds": sec, "draw_launches": draw.launches,
                                     "directions": {k: v for k, v in directions.items()}}
    for claim, (held_, numbers) in directions.items():
        print(f"[33 learning_eval --quick] {claim}: {held_} ({numbers})", flush=True)
    print(f"[33 learning_eval --quick] {sec:.1f} s, {draw.launches} draw launches, "
          f"{fused.launches} fused; {card}", flush=True)
    require(all(h for h, _ in directions.values()) and fused.launches == 0,
            f"[33] learning_eval --quick: a claim does not point the JAX artifact's way: "
            f"{directions}")
    counts["philox_normals"]["learning_eval_quick"] = draw.launches
    counters_zero("[33]")
    record["seconds"] = time.perf_counter() - t_phase
    print(f"[33 training programs] done in {record['seconds']:.1f} s; {card}", flush=True)
    return record, counts


SHARDED_CALLS = 5       # phase 34: chained updates of each compiled sharded option set
CAPTURE_HOLD_S = 0.3    # phase 34: how long a capture of a collective is held open
FIGURE_RUNS = ROOT / "build" / "figure_runs_torch.npz"   # phase 34's figure runs


def phase_34(dev, card, fleet_lines, counters_zero):
    """Phase 34: the sample-sharded programs compiled over NCCL, world size
    1 on the card (parallel/sharded.py, solver/mppi.py compile_step with a
    group, runtime/loop.py simulate, diff/system_id.py). (0) Five captures of
    an all-reduce in torch's default capture mode, each right after 20 eager
    all-reduces and held open CAPTURE_HOLD_S while ProcessGroupNCCL's
    watchdog polls them, each replayed equal to its first run. (a) The sharded
    step, full_body at K=102400 T=30, kernel and eager, vanilla, elite 0.1
    and adapt_sigma: SHARDED_CALLS chained updates bit-equal to the op-by-op
    sharded step and to compile_step without a group, one capture an option
    set, the kernel (or the eager arm's draw) counted once a pass a replay,
    no host sync in a replay; (b) its CUDA-event time in turns against the
    op-by-op sharded step and the graphed unsharded update; (c) the graphed
    sharded 200-cycle loop (build_sharded_simulate): one capture, then a
    second run of 200 replays with 200 kernel launches, bit-equal to the
    cycle scanned op by op with the group, RMSE < 0.15 m; its cycle's time
    in turns against op by op and the unsharded graphed loop; (d) the fits
    and the chunked gradient (num_chunks 1, 4, 8) with the group, graphed
    against op by op in turns (:func:`graphed_against_eager`), bit-equal;
    (e) scripts/torch_multihost_demo.py --kernel at its defaults (K=131072,
    T=30, 50 cycles) in a process of its own: rc 0, RMSE < 0.15 m, compiled;
    (f) the fleet command: its plant captured once and replayed, the RMSE
    line equal to phase 14's, the graphed plant bit-equal to the plant op
    by op for every model; (g) scripts/torch_make_figures.py on the card:
    every run of the ten figures kept (FIGURE_RUNS) and, where matplotlib
    is installed, the ten PNGs of examples/figures/ written. Returns (its
    record, {kernel name: launches of the graphed sharded loop})."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ccv_mppi_path_tracker_tpu_torch import cli
    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.diff import ControlGains
    from ccv_mppi_path_tracker_tpu_torch.diff.system_id import (
        _fit_control_gains_program,
        _fit_full_body_params_program,
        _rollout_gradient_program,
    )
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost,
        philox_normals_cuda,
    )
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params, zmp_chain
    from ccv_mppi_path_tracker_tpu_torch.parallel import (
        build_sharded_simulate,
        build_sharded_step,
        initialize_multihost,
        samples_group,
        shutdown_multihost,
    )
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime import loop as loop_mod
    from ccv_mppi_path_tracker_tpu_torch.runtime import plant as plant_mod
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step, mppi_step
    from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import all_reduce
    from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import Graphed, refuse_host_syncs

    t_phase = time.perf_counter()
    fused, draw = fused_sample_rollout_cost, philox_normals_cuda
    record = {"card": card, "world_size": 1, "backend": "nccl"}
    require(initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="nccl",
                                 timeout_s=120), "[34] the NCCL group of one process")
    group, _ = samples_group(device=dev)
    try:
        # (0) the capture mode: a graph of a collective captured in torch's
        # default mode right after eager collectives, the capture held open
        # while the group's watchdog thread polls their events
        def held(x, group):   # the group an argument: the graph's key holds it
            y = all_reduce(x, dist.ReduceOp.SUM, group)
            time.sleep(CAPTURE_HOLD_S)
            return y * 2

        ones = torch.ones(1 << 20, device=dev)
        for _ in range(5):
            for _ in range(20):
                dist.all_reduce(ones, group=group)
            graphed = Graphed(held)
            first, replayed = graphed(ones, group), graphed(ones, group)
            require(graphed.captures == 1 and torch.equal(first, replayed),
                    "[34] a capture of a collective after eager collectives")
        record["capture_mode"] = {"mode": "global", "captures": 5,
                                  "eager_collectives_before": 20, "held_s": CAPTURE_HOLD_S}
        print(f"[34 capture mode] 5 captures of an NCCL all-reduce in torch's default mode "
              f"\"global\", each right after 20 eager all-reduces and held open "
              f"{CAPTURE_HOLD_S} s: every one captured and replayed", flush=True)

        # (a) the compiled sharded step ------------------------------------------
        s = kernel_case("full_body", K_MAIN, T_MAIN, seed=34)
        cfg, mp = s["cfg"], s["mp"]
        ctrl0 = ControllerState(u_prev=s["u_prev"], seed=34, step=2).with_key()
        rest = (s["state"], s["path"], s["dt"], s["sp"], s["cp"])
        option_sets = {"vanilla": {}, "elite": {"elite_frac": ELITE},
                       "adapt_sigma": {"adapt_sigma": True}}
        arms, steps = {}, {}
        for use_kernel in (True, False):
            counter = fused if use_kernel else draw
            for tag, opts in option_sets.items():
                name = f"{'kernel' if use_kernel else 'eager'}/{tag}"
                step = build_sharded_step(cfg, group, use_kernel=use_kernel,
                                          solver_options=opts)
                require(step.compiled, f"[34] {name}: the sharded step over NCCL is not "
                        "the compiled form")
                by_op = functools.partial(mppi_step, cfg, group=group, num_samples=K_MAIN,
                                          first_sample=0, use_kernel=use_kernel, **opts)
                unsharded = compile_step(cfg, use_kernel=use_kernel, **opts)
                outs = {"graphed": [], "op_by_op": [], "unsharded": []}
                counter.launches = 0
                for arm, fn in (("graphed", step), ("op_by_op", by_op),
                                ("unsharded", unsharded)):
                    ctrl = ctrl0
                    for _ in range(SHARDED_CALLS):
                        ctrl, res = fn(ctrl, *rest, model_params=mp)
                        outs[arm].append((ctrl, res))
                    if arm == "graphed":
                        torch.cuda.synchronize()
                        n = counter.launches
                passes = 2 if use_kernel and tag == "elite" else 1
                same = {}
                for other in ("op_by_op", "unsharded"):
                    same[other] = all(
                        (ca.seed, ca.step) == (cb.seed, cb.step) and torch.equal(ca.key, cb.key)
                        and torch.equal(a.u_opt, b.u_opt)
                        and a.stats.keys() == b.stats.keys()
                        and all(torch.equal(a.stats[k], b.stats[k]) for k in a.stats)
                        for (ca, a), (cb, b) in zip(outs["graphed"], outs[other]))
                captures = step.compiled_step.captures
                print(f"[34 sharded step] NCCL world size 1, full_body K={K_MAIN} T={T_MAIN} "
                      f"{name}: {SHARDED_CALLS} chained updates bit-equal to the op-by-op "
                      f"sharded step {same['op_by_op']}, to compile_step without a group "
                      f"{same['unsharded']}; {captures} capture; "
                      f"{'kernel' if use_kernel else 'draw'} launches {n} "
                      f"({passes} a pass a replay)", flush=True)
                require(same["op_by_op"] and same["unsharded"] and captures == 1
                        and n == passes * SHARDED_CALLS,
                        f"[34] {name}: bit-equal {same}, captures {captures}, launches {n}")
                steps[name] = step
                arms[name] = (step, by_op, unsharded)
                record[f"step/{name}"] = {"bit_equal_op_by_op": same["op_by_op"],
                                          "bit_equal_unsharded": same["unsharded"],
                                          "captures": captures, "launches": n}
                counters_zero(f"[34] {name}")
        torch.cuda.synchronize()
        with refuse_host_syncs("the sharded step's replay"):
            for step in steps.values():
                step(ctrl0, *rest, model_params=mp)
        print("  no host sync in a replay of the sharded step (kernel and eager, vanilla, "
              "elite and adapt_sigma)", flush=True)

        # (b) the sharded step's time in turns ------------------------------------
        for name, (step, by_op, unsharded) in arms.items():
            carry = {}

            def chained(arm, fn):
                carry[arm] = ctrl0

                def call():
                    carry[arm], _ = fn(carry[arm], *rest, model_params=mp)
                return call

            times = time_interleaved({"sharded_graphed": (chained("g", step), 20),
                                      "sharded_op_by_op": (chained("o", by_op), 20),
                                      "unsharded_graphed": (chained("u", unsharded), 20)}, 7)
            med = {k: statistics.median(v) for k, v in times.items()}
            record[f"step_ms/{name}"] = {k: {"median": med[k], "min": min(v), "max": max(v)}
                                         for k, v in times.items()}
            print(f"  {name} update, CUDA events, median of 7 rounds in turns: sharded "
                  f"graphed {med['sharded_graphed']:.4f} ms, sharded op by op "
                  f"{med['sharded_op_by_op']:.4f}, unsharded graphed "
                  f"{med['unsharded_graphed']:.4f} on {card}", flush=True)
            counters_zero(f"[34] {name} timing")

        # (c) the graphed sharded loop --------------------------------------------
        lcfg, lsp, lcp, course = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN,
                                                      device=dev)
        lpath = PathBuffer.from_points(course, 0.1, device=dev)
        slope = float(np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0]))
        start = torch.tensor([course[0, 0], course[0, 1], slope, 0.0, 0.0], device=dev)
        lctrl = ControllerState.initial(34, T_MAIN, 5, device=dev)
        dt = torch.full((), 0.1, device=dev)
        lmp = default_params(device=dev)
        sim = build_sharded_simulate(lcfg, group, num_steps=STEPS, use_kernel=True)
        require(sim.compiled, "[34] the sharded loop over NCCL is not the compiled form")
        captures0 = loop_mod.CYCLE.captures
        sim(lctrl, start, lpath, dt, lsp, lcp)   # the capture
        fused.launches = 0
        last, logs = sim(lctrl, start, lpath, dt, lsp, lcp)
        torch.cuda.synchronize()
        n_loop = fused.launches
        captures = loop_mod.CYCLE.captures - captures0
        opts = dict(group=group, num_samples=K_MAIN, first_sample=0, use_kernel=True,
                    lean=False)
        plant = plant_mod.Plant(model_name="full_body")

        def op_by_op_loop():
            return loop_mod.CYCLE.scan((lctrl.with_key(), start, None), lpath, dt, lsp, lcp,
                                       lmp, lcfg, plant, opts, True, False, length=STEPS,
                                       graph=False)

        (octrl, _, _), ologs = op_by_op_loop()
        same = ologs.keys() == logs.keys() and all(torch.equal(ologs[k], logs[k])
                                                   for k in logs) \
            and torch.equal(octrl.u_prev, last.u_prev)
        xy = np.concatenate([start[None, :2].cpu().numpy(), logs["state"][:, :2].cpu().numpy()])
        m = tracking_metrics(xy, course, dt=0.1)
        print(f"[34 sharded loop] graphed over NCCL, {STEPS} cycles: {captures} capture; "
              f"{n_loop} kernel launches in {STEPS} replays; bit-equal to the cycle op by op "
              f"with the group {same}; RMSE {m['rmse']:.4f} m, max error "
              f"{m['max_error']:.4f} m", flush=True)
        require(captures == 1 and n_loop == STEPS and same and m["rmse"] < 0.15,
                f"[34] sharded loop: captures {captures}, launches {n_loop}, bit-equal "
                f"{same}, RMSE {m['rmse']}")
        launches = {"rollout_cost_full_body_first_sample": n_loop}
        counters_zero("[34] sharded loop")
        unsharded_sim = functools.partial(loop_mod.simulate, lcfg, lctrl, start, lpath, dt,
                                          lsp, lcp, num_steps=STEPS, use_kernel=True)
        unsharded_sim()   # its capture
        times = time_interleaved({"sharded_graphed": (lambda: sim(lctrl, start, lpath, dt,
                                                                  lsp, lcp), 1),
                                  "sharded_op_by_op": (op_by_op_loop, 1),
                                  "unsharded_graphed": (unsharded_sim, 1)}, 3, warm=1)
        cycle_ms = {k: statistics.median(v) / STEPS for k, v in times.items()}
        record["loop"] = {"cycles": STEPS, "captures": captures, "launches": n_loop,
                          "bit_equal_op_by_op": same, "rmse": m["rmse"],
                          "max_error": m["max_error"], "cycle_ms": cycle_ms}
        print(f"  a cycle, CUDA events over the {STEPS}-cycle run, median of 3 rounds in "
              f"turns: sharded graphed {cycle_ms['sharded_graphed']:.4f} ms, sharded op by op "
              f"{cycle_ms['sharded_op_by_op']:.4f}, unsharded graphed "
              f"{cycle_ms['unsharded_graphed']:.4f} on {card}", flush=True)
        counters_zero("[34] loop timing")

        # (d) the fits and the chunked gradient with the group ---------------------
        f32 = dict(dtype=torch.float32, device=dev)
        rng = np.random.RandomState(0)   # the sysid command's data, as phase 33
        true_gains = torch.tensor([0.85, 1.1], device=dev)
        states = torch.tensor(rng.randn(2048, 3), **f32)
        controls = torch.tensor(rng.randn(2048, 2), **f32)
        nxt = get_model("unicycle").step(states, controls * true_gains, 0.1)
        rng = np.random.RandomState(2)   # tests/test_diff.py:71-88's data
        zstates = torch.tensor(rng.randn(12, 64, 5) * 0.2, **f32)
        zcontrols = torch.tensor(rng.randn(11, 64, 5) * 0.5, **f32)
        true = default_params(**f32)
        observed = zmp_chain(zstates, zcontrols, 0.1, true)[..., 1]
        init = dataclasses.replace(true, base2com=torch.full((), 0.6, **f32))
        rng = np.random.RandomState(3)   # tests/test_diff.py:222-228's data
        rargs = (torch.zeros((128, 3), **f32), torch.tensor(rng.randn(16, 128, 2) * 0.5, **f32),
                 torch.tensor(rng.randn(16, 128, 3) * 0.1, **f32))
        programs = {
            "fit_control_gains": _fit_control_gains_program(
                "unicycle", states, controls, nxt, 0.1, num_steps=300, group=group),
            "fit_full_body_params": _fit_full_body_params_program(
                zstates, zcontrols, observed, 0.1, init, num_steps=500, learning_rate=0.02,
                group=group)}
        for nc in (1, 4, 8):
            programs[f"rollout_prediction_value_and_grad/num_chunks={nc}"] = \
                _rollout_gradient_program("unicycle", ControlGains(
                    torch.tensor([1.1, 0.9], **f32)), *rargs, 0.1, num_chunks=nc, group=group)
        for name, program in programs.items():
            rec, _ = graphed_against_eager(f"sharded {name}", program, card, phase=34)
            require(rec["bit_equal"], f"[34] sharded {name}: graphed differs from op by op")
            record[f"fit/{name}"] = rec
    finally:
        shutdown_multihost()
    require(not dist.is_initialized(), "[34] the group outlived shutdown_multihost")

    # (e) the demo twin -----------------------------------------------------------
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_multihost_demo.py"),
                           "--kernel"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    print(f"[34 demo] scripts/torch_multihost_demo.py --kernel: rc {proc.returncode}, "
          f"{wall:.1f} s; {' | '.join(lines)}", flush=True)
    require(proc.returncode == 0, f"[34] the demo twin exited {proc.returncode}:\n"
            f"{proc.stderr[-3000:]}")
    rmse = float(next(x for x in lines if "RMSE=" in x).split("RMSE=")[1].split()[0])
    require(rmse < 0.15 and "compiled=True (nccl" in proc.stdout
            and "kernel launches a rank [50]" in proc.stdout,
            f"[34] the demo twin: RMSE {rmse}, {lines}")
    record["demo"] = {"rmse": rmse, "wall_s": wall, "lines": lines}

    # (f) the fleet command's plant -----------------------------------------------
    argv, phase14 = fleet_lines
    plant_mod.FLEET_PLANT.graphs.clear()   # phase 14 captured this shape's plant
    before = plant_mod.FLEET_PLANT.captures
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().splitlines()
    captures = plant_mod.FLEET_PLANT.captures - before
    plant_same = []
    for model in ("full_body", "unicycle", "steering_unicycle", "rate_limited_steering"):
        mm = get_model(model)
        g = torch.Generator(device=dev)
        g.manual_seed(34)
        st = torch.randn((64, mm.num_states), generator=g, device=dev)
        u = torch.randn((64, mm.num_controls), generator=g, device=dev)
        plant_mod.step_fleet_plant(model, st, u, s["dt"])   # the capture
        plant_same.append(bool(torch.equal(plant_mod.step_fleet_plant(model, st, u, s["dt"]),
                                           plant_mod.fleet_plant_step(model, st, u, s["dt"]))))
    print(f"[34 fleet] {' '.join(argv)}: rc {rc}; the plant {captures} capture, then "
          f"replayed; RMSE line {lines[1]!r} (phase 14: {phase14[1]!r}); the graphed plant "
          f"bit-equal to op by op for every model {all(plant_same)}", flush=True)
    require(rc == 0 and captures == 1 and lines[1] == phase14[1] and all(plant_same),
            f"[34] fleet: rc {rc}, captures {captures}, {lines[1]} vs {phase14[1]}, "
            f"plant {plant_same}")
    record["fleet"] = {"plant_captures": captures, "rmse_line": lines[1]}
    counters_zero("[34] fleet")

    # (g) the figure twin -----------------------------------------------------------
    FIGURE_RUNS.parent.mkdir(parents=True, exist_ok=True)
    png_dir = FIGURE_RUNS.parent / "figures_torch"
    shutil.rmtree(png_dir, ignore_errors=True)
    script = ROOT / "scripts" / "torch_make_figures.py"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(script), "--runs", str(FIGURE_RUNS),
                           "--out", str(png_dir)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    print(f"[34 figures] scripts/torch_make_figures.py: rc {proc.returncode}, {wall:.1f} s; "
          f"{' | '.join(lines)}", flush=True)
    require(proc.returncode == 0, f"[34] the figure twin exited {proc.returncode}:\n"
            f"{proc.stderr[-3000:]}")
    sys.path.insert(0, str(script.parent))
    import torch_make_figures as twin

    runs = twin.load_runs(FIGURE_RUNS)
    rmses = {name: run["metrics"]["rmse"] for name, run in runs.items() if "metrics" in run}
    require(set(runs) == {"diff_drive", "full_body", "full_stack", "steered", "unsteered",
                          "controlled", "uncontrolled", "solver_debug"}
            and all(np.isfinite(v) for v in rmses.values()),
            f"[34] the figure twin's runs: {sorted(runs)}, RMSE {rmses}")
    expected = sorted(os.listdir(ROOT / "examples" / "figures"))
    drawn = sorted(os.listdir(png_dir)) if png_dir.exists() else []
    try:
        import matplotlib  # noqa: F401
        has_matplotlib = True
    except ImportError:
        has_matplotlib = False
    print(f"  runs kept in {FIGURE_RUNS.relative_to(ROOT)}; RMSE {rmses}; matplotlib here "
          f"{has_matplotlib}: {len(drawn)} PNGs written" + (
              "" if has_matplotlib else " (draw them from the runs with --draw-from where "
              "matplotlib is installed)"), flush=True)
    require(drawn == (expected if has_matplotlib else []),
            f"[34] the figure twin drew {drawn}, not {expected}")
    record["figures"] = {"rmse": rmses, "wall_s": wall, "pngs": drawn}
    counters_zero("[34] figures")
    record["seconds"] = time.perf_counter() - t_phase
    print(f"[34] {record['seconds']:.1f} s", flush=True)
    return record, launches


B_SPLIT = 2 * 65535 + 1          # phase 35: a fleet of three launches
B_SPLIT_ONE = 65535              # ... against the largest fleet of one launch
K_SPLIT, T_SPLIT = 64, 10
SPLIT_ROBOTS = (0, 65534, 65535, 65536, 131070)   # robots held against their own launches
B_EAGER_SPLIT = 65536            # phase 35: the eager arm past one launch's robots
SPLIT_TICKS = 10                 # phase 35: ticks a repetition of the timing


def phase_35(dev, card, counters_zero):
    """Phase 35: fleets past 65535 robots, and the two measuring twins'
    quick forms. (a) The kernel arm's fleet tick at B = 131071 (unicycle,
    K=64, T=10, RNG mode, the key on the card), split into three launches
    at their robot offsets (kernels/rollout_cost.py fleet_chunks): the
    wrapper called eagerly, and build_fleet_step's tick as a graph's
    replay; robots SPLIT_ROBOTS bit-equal to launches of each robot alone
    at robot=b, the whole fleet against the plain version at the kernel
    gate, three launches a tick, the replay bit-equal to the tick's eager
    run, and the replayed tick's ms beside the B = 65535 tick's (one
    launch). (b) The eager arm at B = 65536 (K=64, T=10): its fleet tick
    finite with one draw, the draw's robot 65535 bit-equal to
    philox_normals_cuda(robot_base=65535) alone. (c) scripts/
    torch_eager_breakdown.py --quick and scripts/torch_kernel_ab.py sass,
    each in a process of its own. Returns (its record, {kernel name:
    launches of the replayed B = 131071 tick})."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core.types import make_key
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        MAX_ROBOTS,
        fleet_chunks,
        fused_sample_rollout_cost,
        fused_sample_rollout_cost_reference,
        pack_scalars,
        philox_normals_cuda,
    )
    from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals
    from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, init_fleet

    record = {}
    t_phase = time.perf_counter()
    kernel_fn = fused_sample_rollout_cost
    require(len(fleet_chunks(B_SPLIT)) == 3 and MAX_ROBOTS == B_SPLIT_ONE,
            f"[35] {B_SPLIT} robots are {fleet_chunks(B_SPLIT)}")

    # (a) the kernel arm's split launch, called eagerly ---------------------------
    c = kernel_case("diff_drive", K_SPLIT, T_SPLIT, robots=B_SPLIT, seed=35, device=dev)
    model, kargs = c["model"], c["kargs"]
    key = make_key(35, 4, dev)
    kw = dict(seed=None, step=None, num_samples=K_SPLIT, model=model, key=key)
    kernel_fn.launches = 0
    costs, u_num, norm = kernel_fn(*kargs, **kw)
    torch.cuda.synchronize()
    eager_launches = kernel_fn.launches
    require(eager_launches == 3, f"[35] a {B_SPLIT}-robot launch made {eager_launches} "
            f"kernel launches, not 3")
    counters_zero("[35] split launch")
    u_prev, sigma, u_min, u_max, ref_xy, state0, scal = kargs
    for b in SPLIT_ROBOTS:
        one = kernel_fn(u_prev[b], sigma, u_min, u_max, ref_xy[b], state0[b], scal[b],
                        robot=b, **kw)
        same = all(torch.equal(x[b], y) for x, y in zip((costs, u_num, norm), one))
        require(same, f"[35] robot {b} of the {B_SPLIT}-robot launch differs from its "
                f"own launch at robot={b}")
    kernel_fn.launches = 0
    plain = fused_sample_rollout_cost_reference(*kargs, **kw)
    torch.cuda.synchronize()
    cost_rel = float(((costs - plain[0]).abs() / plain[0].abs()).max())
    u_k, u_r = u_num / norm[:, None, None], plain[1] / plain[2][:, None, None]
    u_err, bound = float((u_k - u_r).abs().max()), u_bound(u_r)
    require(bool(torch.isfinite(u_k).all()) and cost_rel <= COST_RTOL and u_err <= bound,
            f"[35] the split launch against the plain version: costs {cost_rel}, u_opt "
            f"{u_err} (bound {bound})")
    print(f"[35 split] unicycle fleet B={B_SPLIT} K={K_SPLIT} T={T_SPLIT} RNG mode, key on "
          f"the card: {eager_launches} launches of {[n for _, n in fleet_chunks(B_SPLIT)]} "
          f"robots; robots {SPLIT_ROBOTS} bit-equal to their own launches at robot=b; "
          f"against the plain version costs max rel err {cost_rel:.3e} (rtol {COST_RTOL}), "
          f"u_opt max abs err {u_err:.3e} (bound {bound:.3e})", flush=True)
    record["split_launch"] = dict(robots=B_SPLIT, launches=eager_launches,
                                  cost_rel_err=cost_rel, u_opt_err=u_err,
                                  bit_equal_robots=list(SPLIT_ROBOTS))
    del plain

    # (a) the graphed fleet tick --------------------------------------------------
    cfg, sp, cp, path, dt = c["cfg"], c["sp"], c["cp"], c["path"], c["dt"]
    ticks, ctrls0 = {}, {}
    for b_fleet in (B_SPLIT, B_SPLIT_ONE):
        ticks[b_fleet] = build_fleet_step(cfg, use_kernel=True)
        ctrls0[b_fleet] = init_fleet(cfg, b_fleet, seed=35, device=dev)
    states = c["state"]
    _, first = ticks[B_SPLIT](ctrls0[B_SPLIT], states, path, dt, sp, cp)
    first_u = first.u_opt.clone()
    counters_zero("[35] tick capture")
    kernel_fn.launches = 0
    _, res = ticks[B_SPLIT](ctrls0[B_SPLIT], states, path, dt, sp, cp)
    torch.cuda.synchronize()
    tick_launches = kernel_fn.launches
    require(tick_launches == 3 and ticks[B_SPLIT].graphed.captures == 1,
            f"[35] the replayed {B_SPLIT}-robot tick made {tick_launches} launches, "
            f"{ticks[B_SPLIT].graphed.captures} captures")
    require(torch.equal(res.u_opt, first_u), "[35] the replayed tick differs from its "
            "eager run")
    counters_zero("[35] tick replay")
    tick_key = ctrls0[B_SPLIT].key
    for b in SPLIT_ROBOTS:
        sc = pack_scalars(dt, cp, res.ref.yaw[b, 0], None, sp.noise_beta, sp.lam)
        _, un, nm = kernel_fn(ctrls0[B_SPLIT].u_prev[b], sigma, u_min, u_max,
                              res.ref.xy[b], states[b], sc, None, None, K_SPLIT, model,
                              robot=b, key=tick_key)
        require(torch.equal(res.u_opt[b], un / nm), f"[35] robot {b} of the replayed "
                f"tick differs from its own launch at robot={b}")
    print(f"[35 split tick] build_fleet_step(use_kernel=True) B={B_SPLIT}: one capture, "
          f"{tick_launches} launches a replayed tick, the replay bit-equal to the tick's "
          f"eager run, robots {SPLIT_ROBOTS} bit-equal to their own launches", flush=True)
    ticks[B_SPLIT_ONE](ctrls0[B_SPLIT_ONE], states[:B_SPLIT_ONE], path, dt, sp, cp)
    arms = {f"tick/B{b_fleet}": (functools.partial(
        ticks[b_fleet], ctrls0[b_fleet], states[:b_fleet], path, dt, sp, cp), SPLIT_TICKS)
        for b_fleet in (B_SPLIT, B_SPLIT_ONE)}
    times = time_interleaved(arms, 5)
    tick_ms = {name: statistics.median(v) for name, v in times.items()}
    print(f"[35 split tick] graphed tick ms (median of 5 x {SPLIT_TICKS}, in turns) on "
          f"{card}: B={B_SPLIT} (3 launches) {tick_ms[f'tick/B{B_SPLIT}']:.4f}, "
          f"B={B_SPLIT_ONE} (1 launch) {tick_ms[f'tick/B{B_SPLIT_ONE}']:.4f}", flush=True)
    record["tick"] = dict(launches=tick_launches, ms=tick_ms)
    counters_zero("[35] tick timing")
    del ticks, arms, c, costs, u_num, norm, res, first
    torch.cuda.empty_cache()

    # (b) the eager arm past one launch's robots ------------------------------------
    e = kernel_case("diff_drive", K_SPLIT, T_SPLIT, robots=B_EAGER_SPLIT, seed=36, device=dev)
    etick = build_fleet_step(e["cfg"], use_kernel=False)
    ectrls = init_fleet(e["cfg"], B_EAGER_SPLIT, seed=36, device=dev)
    eargs = (ectrls, e["state"], e["path"], e["dt"], e["sp"], e["cp"])
    etick(*eargs)
    philox_normals_cuda.launches = kernel_fn.launches = 0
    _, eres = etick(*eargs)
    torch.cuda.synchronize()
    draws = philox_normals_cuda.launches
    require(bool(torch.isfinite(eres.u_opt).all()) and kernel_fn.launches == 0
            and draws == 1 and etick.graphed.captures == 1,
            f"[35] the replayed eager tick at B={B_EAGER_SPLIT}: {draws} draws, "
            f"{etick.graphed.captures} captures")
    shape = (B_EAGER_SPLIT, T_SPLIT - 1, K_SPLIT, 2)
    fleet_draw = draw_standard_normals(ectrls.key, None, None, shape, device=dev)
    alone = philox_normals_cuda(ectrls.key, num_samples=K_SPLIT, tm1=T_SPLIT - 1, u_dim=2,
                                robot_base=B_EAGER_SPLIT - 1)
    require(torch.equal(fleet_draw[-1], alone[0]), f"[35] robot {B_EAGER_SPLIT - 1} of the "
            f"eager draw differs from its draw alone")
    print(f"[35 eager] build_fleet_step(use_kernel=False) B={B_EAGER_SPLIT} K={K_SPLIT} "
          f"T={T_SPLIT}: one capture, a replay u_opt finite with {draws} draw launch and "
          f"no fused launch; the draw's robot {B_EAGER_SPLIT - 1} bit-equal to "
          f"philox_normals_cuda(robot_base={B_EAGER_SPLIT - 1}) alone "
          f"({fleet_draw.numel() * 4 / 2**30:.2f} GiB of normals)", flush=True)
    record["eager"] = dict(robots=B_EAGER_SPLIT, draws=draws)
    del e, etick, eres, fleet_draw
    torch.cuda.empty_cache()

    # (c) the measuring twins' quick forms --------------------------------------------
    for name, argv in (("eager_breakdown", ["scripts/torch_eager_breakdown.py", "--quick",
                                            "--out", "build/eager_breakdown_quick.json"]),
                       ("kernel_floor", ["scripts/torch_kernel_ab.py", "sass", "--out",
                                         "build/kernel_floor_quick.json"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        wall = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if not ln.startswith("{")]
        print(f"[35 {name}] {' '.join(argv)}: rc {proc.returncode}, {wall:.1f} s", flush=True)
        for ln in lines:
            print(f"  {ln}", flush=True)
        require(proc.returncode == 0, f"[35] {argv[0]} exited {proc.returncode}:\n"
                f"{proc.stderr[-3000:]}")
        record[name] = json.loads((ROOT / argv[-1]).read_text())
        record[name + "_wall_s"] = wall
    counters_zero("[35] twins")
    record["seconds"] = time.perf_counter() - t_phase
    print(f"[35] {record['seconds']:.1f} s", flush=True)
    return record, {"rollout_cost_unicycle_fleet": tick_launches}


GN_SEEDS = 28              # phase 36: seeded sampled updates, half with roll_off
GN_GAP = 5e-2              # phase 36: kernel vs op by op, of the box (see the phase)


def phase_36(dev, card, counters_zero):
    """Phase 36: the refine stage's kernel (kernels/gauss_newton.py
    gauss_newton_steps, csrc/gauss_newton.cu) against the plain op-by-op
    stage on the card (diff/gradients.py gauss_newton_steps_plain), float32,
    full_body at T=30: (a) its build and ptxas report; (b) 32 inputs: the
    sampled update of GN_SEEDS seeded flagship cases (half with roll_off, so
    that the ZMP and roll-rate rows weigh too) and the zero warm start of two
    (the v = 0 tie), each with the accept pattern of the 3 steps equal (the
    kernel's from its counters after 1, 2 and 3 steps), the counters
    [3, accepted] and the fused steps 3, and max |du| over the box width
    under GN_GAP: the damped system's condition number is ~2e4, so rounding
    alone moves an answer by up to 2e-2 of the box (PERF.md section 2); both
    arms' distance from the float64 stage is printed; the dispatch
    (gauss_newton_refine) launching the kernel, bit-equal to the wrapper's
    call; an input with a NaN (every step rejected, a NaN pivot) and one
    with damping -1e3 (a non-positive pivot): every step rejected, the
    sequence returned bit for bit; (c) a compiled refined update replayed 20
    times: one kernel launch, 3 fused steps counted a replay, and by
    torch.profiler the device ops after the fused kernel; (d) CUDA-event
    times in turns: the kernel (a graph of 20 launches), the plain stage
    as a graph, the refined update with the kernel and with the plain
    stage, the unrefined update; the kernel beside
    benchmark/work_refine.py bound_us(30, 5, 3). Returns its record."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from benchmark import work_refine
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, RefWindow
    from ccv_mppi_path_tracker_tpu_torch.diff import gradients
    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels import gauss_newton as gn
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step, mppi_step
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    record = {}
    # (a) the build
    lib_path, build_s, log = build.build("gauss_newton")
    ptxas = build.ptxas_summary(log or "")
    print(f"[36 build] {lib_path.name} in {build_s:.2f} s; ptxas {ptxas}", flush=True)
    require(all("rollout_cost_kernel" not in name for name in ptxas),
            "a Gauss-Newton entry point carries the fused kernel's name")
    record["ptxas"] = ptxas

    def case(seed, roll_off, zero=False):
        s = kernel_case("full_body", K_MAIN, T_MAIN, roll_off=roll_off, seed=seed)
        _, res = mppi_step(s["cfg"], ControllerState(s["u_prev"], seed, 0), s["state"],
                           s["path"], s["dt"], s["sp"], s["cp"], model_params=s["mp"],
                           use_kernel=True)
        u = torch.zeros_like(res.u_opt) if zero else res.u_opt
        return s, u, res.ref

    def cast(obj, dtype):
        return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(dtype)
                                           for f in dataclasses.fields(obj)})

    def plain(s, u, ref, dtype=torch.float32, damping=1e-3):
        sp = cast(s["sp"], dtype)
        out, accepts, _ = gradients.gauss_newton_steps_plain(
            s["cfg"], u.to(dtype), s["state"].to(dtype),
            RefWindow(ref.xy.to(dtype), ref.yaw.to(dtype)), s["dt"].to(dtype), sp.u_min,
            sp.u_max, cast(s["cp"], dtype), cast(s["mp"], dtype), 3, damping)
        return out, [bool(a) for a in accepts]

    def kernel(s, u, ref, steps=3, damping=1e-3):
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        fused = torch.zeros(1, dtype=torch.int64, device=dev)
        out = gn.gauss_newton_steps(u, s["state"], ref.xy, ref.yaw, s["dt"], s["sp"].u_min,
                                    s["sp"].u_max, s["cp"], s["mp"], steps, damping,
                                    counts=counts, fused=fused)
        torch.cuda.synchronize()
        return out, counts.tolist(), fused.tolist()

    # (b) the kernel against the op-by-op stage
    cases = [(seed, seed % 2 == 0, False) for seed in range(GN_SEEDS)]
    cases += [(GN_SEEDS, True, True), (GN_SEEDS + 1, False, True)]
    gaps, rows = [], []
    for seed, roll_off, zero in cases:
        s, u, ref = case(seed, roll_off, zero)
        box = (s["sp"].u_max - s["sp"].u_min).double()
        want, pattern = plain(s, u, ref)
        got, counts, fused = kernel(s, u, ref)
        prefix = [kernel(s, u, ref, steps=k)[1][1] for k in (1, 2)] + [counts[1]]
        kpattern = [prefix[0] == 1] + [b - a == 1 for a, b in zip(prefix, prefix[1:])]
        exact, _ = plain(s, u, ref, torch.float64)
        gap = float(((got.double() - want.double()).abs() / box).max())
        k64 = float(((got.double() - exact).abs() / box).max())
        p64 = float(((want.double() - exact).abs() / box).max())
        before = gn.gauss_newton_steps.launches
        routed = gradients.gauss_newton_refine(s["cfg"], u, s["state"], ref, s["dt"],
                                               s["sp"], s["cp"], s["mp"])
        require(gn.gauss_newton_steps.launches == before + 1 and torch.equal(routed, got),
                f"seed {seed}: gauss_newton_refine did not route to the kernel")
        rows.append(dict(seed=seed, roll_off=roll_off, zero=zero, gap=gap, kernel_f64=k64,
                         plain_f64=p64, pattern=pattern, counts=counts))
        gaps.append(gap)
        print(f"  seed {seed} roll_off {roll_off} zero {zero}: accepts plain {pattern} "
              f"kernel {kpattern}, counts {counts} fused {fused}; |du|/box {gap:.3e}; "
              f"from float64: kernel {k64:.3e}, plain {p64:.3e}", flush=True)
        require(kpattern == pattern and counts == [3, sum(pattern)] and fused == [3],
                f"seed {seed}: the kernel's accepts or counters differ from the op-by-op "
                f"stage's")
        require(gap <= GN_GAP, f"seed {seed}: the kernel differs by {gap} of the box")
    # every step rejected: a NaN in the sequence (a NaN pivot), and a damping
    # that makes a pivot negative
    s, u, ref = case(GN_SEEDS + 2, True)
    u_nan = u.clone()
    u_nan[3, 1] = float("nan")
    for name, uu, damping in (("nan", u_nan, 1e-3), ("negative pivot", u, -1e3)):
        got, counts, fused = kernel(s, uu, ref, damping=damping)
        same = torch.equal(got.nan_to_num(7.0), uu.nan_to_num(7.0))
        want, pattern = plain(s, uu, ref, damping=damping)
        print(f"  {name}: kernel counts {counts}, the sequence returned bit for bit {same}; "
              f"the op-by-op stage's accepts {pattern}", flush=True)
        require(counts == [3, 0] and same, f"{name}: a step was not rejected")
    record["compare"] = dict(max_gap=max(gaps), rows=rows)
    print(f"[36 compare] the kernel against the op-by-op stage on the card, {len(cases)} "
          f"inputs at T={T_MAIN}: max |du|/box {max(gaps):.3e} (gate {GN_GAP}); accept "
          f"patterns and counters equal; NaN and non-positive pivots rejected", flush=True)

    # (c) one launch a replayed refined update
    s = kernel_case("full_body", K_MAIN, T_MAIN, roll_off=True, seed=36)
    call = (s["state"], s["path"], s["dt"], s["sp"], s["cp"])
    refined = compile_step(s["cfg"], use_kernel=True, lean=True, refine_steps=3,
                           refine_method="gauss_newton")
    carry = [ControllerState(s["u_prev"], 36, 0)]

    def update():
        carry[0], _ = refined(carry[0], *call, model_params=s["mp"])

    for _ in range(3):
        update()
    torch.cuda.synchronize()
    require(refined.captures == 1, f"{refined.captures} captures of the refined update")
    profiling.reset()
    before = gn.gauss_newton_steps.launches
    for _ in range(20):
        update()
    torch.cuda.synchronize()
    launched = gn.gauss_newton_steps.launches - before
    counted = profiling.counters()
    print(f"[36 replay] 20 replays of the refined update: {launched} kernel launches, "
          f"counters {counted}", flush=True)
    require(launched == 20 and counted.get("refine.fused_steps") == 60
            and counted.get("refine.lm_steps") == 60,
            "the replayed refined update does not take the kernel once")
    # a profiler with a discarded warm-up cycle: one started this late in the
    # smoke's process loses the first device records after its start
    with profiling.device_profile() as prof:
        for _ in range(5):
            update()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    ends = [e.time_range.end for e in events if "rollout_cost_kernel" in e.name]
    gn_events = [e for e in events if "gauss_newton_kernel" in e.name]
    if ends:
        # the ops from the fused kernel's end to the Gauss-Newton launch's end
        after = [sum(1 for e in events if a <= e.time_range.start < g.time_range.end)
                 for a, g in zip(ends, gn_events)]
        gn_us = [e.time_range.elapsed_us() for e in gn_events]
        record["replay"] = dict(ops_after_kernel=after, kernel_us=gn_us,
                                device_ops=len(events) / 5)
        print(f"[36 profile] 5 replays: {len(events) / 5:.1f} device ops an update, "
              f"{after} from the fused kernel's end to the Gauss-Newton launch's end, "
              f"{len(gn_events)} Gauss-Newton launches of "
              f"{gn_us} us", flush=True)
        require(len(gn_events) == 5, "not one Gauss-Newton launch a replay")
    else:
        print("[36 profile] the profiler recorded no device activity: not measured",
              flush=True)

    # (d) times in turns
    s, u, ref = case(37, True)
    args = (u, s["state"], ref.xy, ref.yaw, s["dt"], s["sp"].u_min, s["sp"].u_max, s["cp"],
            s["mp"])
    plain_args = (s["cfg"], u, s["state"], ref, s["dt"], s["sp"], s["cp"], s["mp"])
    unrefined = compile_step(s["cfg"], use_kernel=True, lean=True)
    carries = {}

    def updater_of(step, key):
        carries[key] = ControllerState(s["u_prev"], 37, 0)

        def fn():
            carries[key], _ = step(carries[key], s["state"], s["path"], s["dt"], s["sp"],
                                   s["cp"], model_params=s["mp"])
        fn()
        return fn

    refined_kernel = updater_of(compile_step(s["cfg"], use_kernel=True, lean=True,
                                             refine_steps=3, refine_method="gauss_newton"),
                                "kernel")
    fused_inputs = gradients._fused_inputs
    gradients._fused_inputs = lambda *a: None    # the parent's op-by-op stage
    try:
        refined_plain = updater_of(compile_step(s["cfg"], use_kernel=True, lean=True,
                                                refine_steps=3,
                                                refine_method="gauss_newton"), "plain")
    finally:
        gradients._fused_inputs = fused_inputs
    arms = {
        "stage/kernel": (graph_replay(lambda: gn.gauss_newton_steps(*args, 3, 1e-3), 20), 1),
        "stage/plain_graphed": (graph_replay(
            lambda: gradients.gauss_newton_refine_plain(*plain_args), 1), 1),
        "update/refined_kernel": (refined_kernel, 20),
        "update/refined_plain": (refined_plain, 5),
        "update/unrefined": (updater_of(unrefined, "unrefined"), 20),
    }
    times = time_interleaved(arms, 5, warm=1)
    med = {name: statistics.median(v) for name, v in times.items()}
    med["stage/kernel"] /= 20
    bound = work_refine.bound_us(T_MAIN, 5, 3)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    record["times_ms"] = med
    record["bound_us"] = bound
    props = {k: K_MAIN * (T_MAIN - 1) / (v * 1e-3) for k, v in med.items()
             if k.startswith("update/")}
    record["propagations_per_s"] = props
    print(f"[36 timing] median of 5 CUDA-event reps on {card} (after: sm clock, draw, "
          f"limit, temp = {clocks}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in med.items())
          + f"; the kernel at {100 * bound / (1e3 * med['stage/kernel']):.2f} % of "
            f"work_refine's bound {bound:.3f} us; propagations/s "
          + ", ".join(f"{k} {v:.4e}" for k, v in props.items()), flush=True)
    counters_zero("gauss newton kernel")
    return record


PROLOGUE_POSES = 32        # phase 37: seeded poses a model on the benchmark course
PROLOGUE_FLEET = 256       # phase 37: the fleet's robots
TIE_AT = 60                # phase 37: the course point doubled for an exact tie
# phase 37: the operands the dispatch converts, one a pose in turn
CONVERTED = ("tensors", "number dt", "number v_ref", "float64 weight", "int32 count")


def prologue_bound(points, horizon, state_dim, tickets, robots=1):
    """(bytes, (ms, "bytes")): the step prologue's bytes at the HBM rate
    (kernels/rollout_cost.py HBM_BYTES_PER_S). Read: the valid path points
    (8 B each), the state, the 17 scalar sources, the count, resolution and
    key. Written: the window (xy and yaw), the padded centred rows (16 B
    each), the start state, the scalar vector, the tickets, the next key;
    the two device counters read and written."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        HBM_BYTES_PER_S,
        NSCAL,
        pad_ref_count,
    )

    read = points * 8 + robots * state_dim * 4 + (NSCAL - 1) * 4 + 8 + 4 + 16
    written = robots * (horizon * 12 + pad_ref_count(horizon) * 16 + state_dim * 4
                        + NSCAL * 4 + tickets * 4) + 16 + 2 * 16
    nbytes = read + written
    return nbytes, (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")


def phase_37(dev, card, counters_zero):
    """Phase 37: the control step's prologue (kernels/step_prologue.py, one
    launch of csrc/rollout_cost.cu step_prologue) against its plain version,
    the op-by-op glue, on the card: (a) for each model, PROLOGUE_POSES seeded
    poses on the benchmark's course (benchmark/reference.py course of the
    flagship configuration at a seeded offset): ref.xy, ref.yaw, refc, s0,
    scal and the next key bit for bit, the tickets zero, the default body
    parameters as views of scal equal to default_params; the poses include
    one beyond DIST_CAP of every point (index 0), one at the course's end
    (the window clamped), one on a doubled point (an exact tie, the first
    index), paths whose capacity exceeds their valid count, the count as a
    tensor and as an int, the elite threshold given and absent, the key
    given and absent, given body parameters, and the operands the dispatch
    converts (dt or v_ref a number, a float64 weight, an int32 count), dt
    and v_ref both numbers refused; (b) a fleet of PROLOGUE_FLEET robots of
    each model on a shared path and on per-robot paths of other lengths, a
    per-robot threshold once, a number dt once; (c) compiled updates with the
    kernel against the same updates with the plain prologue, chained, bit for
    bit: the flagship lean update, two-pass and stale elite, the
    Gauss-Newton-refined update, the diff_drive fleet tick; one prologue
    launch a replay, the counters step.kernel_updates and step.prologue_fused;
    (d) the replayed flagship update in turns with the plain prologue and
    with the kernel: CUDA-event ms and torch.profiler's device ops an update;
    the prologue alone, the kernel's launch against the op-by-op glue it
    replaced, each replayed as a CUDA graph, beside its byte bound
    (:func:`prologue_bound`). Returns its record."""
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from benchmark import reference
    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, make_key
    from ccv_mppi_path_tracker_tpu_torch.kernels import step_prologue as pro
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import pad_ref_rows
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, compile_step, init_fleet
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    config = json.loads((ROOT / "benchmark" / "configs" / "full_body-K102400-T30.json")
                        .read_text())
    spec, res = config["course"], config["course"]["resolution"]
    record = {"cases": 0, "converted": {}}
    dt = torch.full((), 0.1, device=dev)

    def bits(t):
        """A float32 tensor's bit patterns (-0.0 and +0.0 differ, a NaN equals
        itself), any other tensor as it is."""
        return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t

    def same(a, b):
        if a is None or b is None:
            return a is None and b is None
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))

    def centred(ref_xy, state):
        """The centred rows and start state as the fused launch makes them
        where no prologue gives them (kernels/rollout_cost.py KernelLaunch)."""
        c, refc = pad_ref_rows(ref_xy)
        return refc, torch.cat([state[..., :2] - c, state[..., 2:]], dim=-1).contiguous()

    def compare(tag, cfg, path, state, sp, cp, mp=None, thresh=None, key=None, dt=dt):
        want = pro.step_prologue_plain(cfg, path, state, dt, sp, cp, mp, thresh, key)
        want_refc, want_s0 = centred(want.ref.xy, state)
        ops = pro._kernel_operands(cfg, path, state, dt, sp, cp, mp, thresh, key)
        require(ops is not None, f"{tag}: the kernel does not take the call")
        poison = torch.full((1 << 16,), -1, dtype=torch.int32, device=dev)
        del poison   # the tickets come from memory that held -1
        got = pro.step_prologue_cuda(**ops, tickets_per_robot=pro.ticket_count(cfg.num_samples))
        torch.cuda.synchronize()
        pairs = [("ref.xy", got.ref.xy, want.ref.xy), ("ref.yaw", got.ref.yaw, want.ref.yaw),
                 ("refc", got.refc, want_refc), ("s0", got.s0, want_s0),
                 ("scal", got.scal, want.scal), ("next_key", got.next_key, want.next_key)]
        if mp is None and want.model_params is not None:
            pairs += [(f"model_params.{f}", getattr(got.model_params, f),
                       getattr(want.model_params, f).expand_as(getattr(got.model_params, f)))
                      for f in ("mass", "base2com", "inertia", "gravity_z")]
        diffs = [name for name, a, b in pairs if not same(a, b)]
        zeros = bool((got.tickets == 0).all())
        require(not diffs and zeros,
                f"{tag}: the kernel's prologue differs from the op-by-op one in {diffs}; "
                f"tickets zero {zeros}")
        record["cases"] += 1
        return got

    # (a) single robots: each model on the benchmark's course
    presets = list(PRESETS)
    for mi, preset in enumerate(presets):
        cfg, sp, cp, _ = PRESETS[preset](num_samples=K_MAIN, horizon=T_MAIN, device=dev)
        m = get_model(cfg.model)
        rng = np.random.RandomState(3700 + mi)
        course = reference.course(spec, tuple(rng.uniform(-1.0, 1.0, 2)))
        n = len(course)
        tied = np.insert(course, TIE_AT, course[TIE_AT], axis=0)
        paths = {
            "int": PathBuffer.from_points(course, res, device=dev),
            "roomy": PathBuffer.from_points(course, res, capacity=n + 57, device=dev),
            "tie": PathBuffer.from_points(tied, res, device=dev),
        }
        paths["count"] = paths["int"].with_count_tensor()
        paths["roomy_count"] = paths["roomy"].with_count_tensor()
        checks = []
        for i in range(PROLOGUE_POSES):
            name = ("count", "int", "roomy_count", "roomy")[i % 4]
            at = course[rng.randint(0, n)] + 0.3 * rng.randn(2)
            if i == 0:
                at = course[0] + np.array([150.0, 150.0])      # beyond DIST_CAP of all
            elif i == 1:
                at = course[-1] + np.array([0.02, -0.03])      # the window clamped
            elif i == 2:
                name, at = "tie", tied[TIE_AT]                 # an exact tie
            elif i == 3:
                at = course[-3]                                # past the roomy path's end
            rest = (0.1 * rng.randn(m.num_states - 2)).tolist()
            state = torch.tensor([float(at[0]), float(at[1]), *rest], dtype=torch.float32,
                                 device=dev)
            thresh = torch.full((), 40.0 + i, device=dev) if i % 2 else None
            key = None if i % 5 == 4 else make_key(1000 + i, i, dev)
            mp = None
            if m.default_params is not None and i % 6 == 5:
                d = m.default_params(device=dev)
                mp = FullBodyParams(mass=d.mass * 1.01, base2com=d.base2com * 0.99,
                                    inertia=d.inertia * 1.02, gravity_z=d.gravity_z)
            path = paths[name]
            # the operands the dispatch converts, one a pose in turn
            kind = CONVERTED[i % len(CONVERTED)]
            pose_dt, pose_cp, pose_path = dt, cp, path
            if kind == "number dt":
                pose_dt = 0.1
            elif kind == "number v_ref":
                pose_cp = dataclasses.replace(cp, v_ref=float(cp.v_ref))
            elif kind == "float64 weight":
                pose_cp = dataclasses.replace(cp, path_weight=cp.path_weight.double() / 3.0)
            elif kind == "int32 count":
                pose_path = dataclasses.replace(path, num_valid=torch.as_tensor(
                    path.num_valid, dtype=torch.int32, device=dev))
            record["converted"][kind] = record["converted"].get(kind, 0) + 1
            got = compare(f"{preset} pose {i} ({name}, {kind})", cfg, pose_path, state, sp,
                          pose_cp, mp, thresh, key, dt=pose_dt)
            if i in (0, 1, 2):
                nv = int(path.num_valid)
                want_first = {0: 0, 1: nv - 1, 2: TIE_AT}[i]
                require(torch.equal(got.ref.xy[0], path.xy[want_first]),
                        f"{preset} pose {i}: the window starts elsewhere than point {want_first}")
                if i == 2:
                    step_pts = int(torch.floor(cp.v_ref * dt / path.resolution))
                    require(torch.equal(got.ref.xy[1], path.xy[TIE_AT + step_pts]),
                            f"{preset}: the tie did not keep the first index")
                if i == 1:
                    require(torch.equal(got.ref.xy[-1], path.xy[nv - 1]),
                            f"{preset}: the window at the end is not clamped")
            checks.append(name)
        both = dataclasses.replace(cp, v_ref=float(cp.v_ref))
        try:
            pro._kernel_operands(cfg, paths["int"], state, 0.1, sp, both, None, None, None)
            refused = False
        except TypeError:
            refused = True
        require(refused, f"{preset}: dt and v_ref both numbers were not refused")
        print(f"[37 single] {preset} ({cfg.model}): {PROLOGUE_POSES} poses on the course "
              f"({n} points) bit-equal on every output, tickets zero; far pose at point 0, "
              f"end pose clamped, tie at the first index; converted operands (the models "
              f"so far) {record['converted']}; dt and v_ref both numbers refused", flush=True)

    # (b) fleets on a shared path and on per-robot paths
    for mi, preset in enumerate(presets):
        cfg, sp, cp, _ = PRESETS[preset](num_samples=K_FLEET, horizon=T_FLEET, device=dev)
        m = get_model(cfg.model)
        rng = np.random.RandomState(3710 + mi)
        b = PROLOGUE_FLEET
        course = reference.course(spec, (0.0, 0.0))
        st = np.zeros((b, m.num_states))
        st[:, 0] = rng.uniform(0.0, 19.0, b)
        st[:, 1] = np.interp(st[:, 0], course[:, 0], course[:, 1]) + 0.3 * rng.randn(b)
        st[:, 2:] = 0.05 * rng.randn(b, m.num_states - 2)
        st[0, :2] = course[0] + 200.0                      # robot 0 beyond DIST_CAP
        states = torch.tensor(st, dtype=torch.float32, device=dev)
        shared = PathBuffer.from_points(course, res, capacity=len(course) + 9, device=dev)
        lens = rng.randint(120, len(course) + 1, b)
        own = PathBuffer.stack([
            PathBuffer.from_points(reference.course(spec, tuple(0.3 * rng.randn(2)))[:ln], res,
                                   capacity=len(course), device=dev) for ln in lens])
        key = make_key(77, 5, dev)
        compare(f"{preset} fleet shared", cfg, shared, states, sp, cp, key=key)
        compare(f"{preset} fleet shared, count tensor", cfg, shared.with_count_tensor(), states,
                sp, cp, key=key)
        compare(f"{preset} fleet shared, number dt", cfg, shared, states, sp, cp, key=key,
                dt=0.1)
        thresh = torch.linspace(10.0, 90.0, b, device=dev) if mi == 0 else None
        compare(f"{preset} fleet per-robot paths", cfg, own, states, sp, cp, thresh=thresh,
                key=key)
        print(f"[37 fleet] {preset}: B={b} on a shared path (count int and tensor, dt a "
              f"tensor and a number) and on "
              f"per-robot paths of {lens.min()}-{lens.max()} points"
              f"{', a per-robot threshold' if thresh is not None else ''}: bit-equal",
              flush=True)

    # (c) compiled updates: kernel prologue against the plain one, chained
    plain_operands = pro._kernel_operands

    def capture(step, ctrl, call, force_plain, **kw):
        """The first call (the graph's capture) under the same arm."""
        if force_plain:
            pro._kernel_operands = lambda *a, **k: None
        try:
            return step(ctrl, *call, **kw)
        finally:
            pro._kernel_operands = plain_operands

    def chain(preset, opts, n, stale=False, roll_off=True):
        kw = {"roll_off": roll_off} if preset == "full_body" else {}
        cfg, sp, cp, course = PRESETS[preset](num_samples=K_MAIN, horizon=T_MAIN, device=dev,
                                              **kw)
        m = get_model(cfg.model)
        path = PathBuffer.from_points(course, 0.1, device=dev)
        rest = list(PRESET_MODELS[preset][1])
        state = torch.tensor([0.05, float(course[0, 1]) + 0.1, *rest], dtype=torch.float32,
                             device=dev)
        outs = {}
        for arm in ("plain", "kernel"):
            step = compile_step(cfg, use_kernel=True, lean=True, **opts)
            ctrl = ControllerState.initial(37, cfg.horizon, m.num_controls, device=dev)
            thresh = torch.full((), 60.0, device=dev) if stale else None
            extra = {"elite_stale_thresh": thresh} if stale else {}
            seq = []
            for i in range(n):
                call = (state, path, dt, sp, cp)
                if i == 0:
                    ctrl, r = capture(step, ctrl, call, arm == "plain", **extra)
                else:
                    ctrl, r = step(ctrl, *call, **extra)
                if stale:
                    extra["elite_stale_thresh"] = r.stats["elite_thresh"]
                seq.append((ctrl.u_prev.clone(), ctrl.key.clone()))
            outs[arm] = seq
        torch.cuda.synchronize()
        equal = all(same(a[0], b[0]) and same(a[1], b[1])
                    for a, b in zip(outs["plain"], outs["kernel"]))
        return equal

    cases = [("flagship lean", "full_body", {}, 20, False),
             ("two-pass elite", "full_body", {"elite_frac": ELITE}, 6, False),
             ("stale elite", "diff_drive", {"elite_frac": ELITE}, 6, True),
             ("Gauss-Newton refined", "full_body",
              {"refine_steps": 3, "refine_method": "gauss_newton"}, 6, False),
             ("rate-limited lean", "rate_limited_steering", {}, 6, False)]
    chains = {}
    for name, preset, opts, n, stale in cases:
        chains[name] = chain(preset, opts, n, stale)
        print(f"[37 chained] {name}: {n} compiled updates with the kernel's prologue "
              f"bit-equal to the plain prologue's (u_prev and key): {chains[name]}", flush=True)
        require(chains[name], f"{name}: the compiled updates differ")
    record["chained"] = chains

    # the fleet tick, diff_drive at the benchmark's node size
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=1000, horizon=15, device=dev)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    rng = np.random.RandomState(3720)
    st = np.zeros((PROLOGUE_FLEET, 3))
    st[:, 0] = rng.uniform(0.0, 8.0, PROLOGUE_FLEET)
    st[:, 1] = np.interp(st[:, 0], course[:, 0], course[:, 1]) + 0.3 * rng.randn(PROLOGUE_FLEET)
    states = torch.tensor(st, dtype=torch.float32, device=dev)
    ticks = {}
    for arm in ("plain", "kernel"):
        if arm == "plain":
            pro._kernel_operands = lambda *a, **k: None
        try:
            tick = build_fleet_step(cfg, use_kernel=True)
            ctrls = init_fleet(cfg, PROLOGUE_FLEET, seed=37, device=dev)
            ctrls, _ = tick(ctrls, states, path, dt, sp, cp)
        finally:
            pro._kernel_operands = plain_operands
        seq = [(ctrls.u_prev.clone(), ctrls.key.clone())]
        for _ in range(5):
            ctrls, _ = tick(ctrls, states, path, dt, sp, cp)
            seq.append((ctrls.u_prev.clone(), ctrls.key.clone()))
        ticks[arm] = seq
    torch.cuda.synchronize()
    fleet_equal = all(same(a[0], b[0]) and same(a[1], b[1])
                      for a, b in zip(ticks["plain"], ticks["kernel"]))
    print(f"[37 chained] diff_drive fleet tick B={PROLOGUE_FLEET} K=1000 T=15: 6 ticks "
          f"bit-equal {fleet_equal}", flush=True)
    require(fleet_equal, "the fleet ticks differ")
    record["chained"]["fleet tick"] = fleet_equal

    # (d) the replayed flagship update: plain prologue against the kernel
    cfg, sp, cp, course = PRESETS["full_body"](num_samples=K_MAIN, horizon=T_MAIN, device=dev)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    state = torch.tensor([0.05, float(course[0, 1]) + 0.1, 0.1, 0.02, -0.03],
                         dtype=torch.float32, device=dev)
    carries, steps = {}, {}
    for arm in ("plain", "kernel"):
        steps[arm] = compile_step(cfg, use_kernel=True, lean=True)
        carries[arm] = ControllerState.initial(37, T_MAIN, 5, device=dev)
        carries[arm], _ = capture(steps[arm], carries[arm], (state, path, dt, sp, cp),
                                  arm == "plain")

    def updater(arm):
        def fn():
            carries[arm], _ = steps[arm](carries[arm], state, path, dt, sp, cp)
        return fn

    profiling.reset()
    before = pro.step_prologue_cuda.launches
    for arm in ("plain", "kernel"):
        for _ in range(10):
            updater(arm)()
    torch.cuda.synchronize()
    counted = profiling.counters()
    launched = pro.step_prologue_cuda.launches - before
    print(f"[37 replay] 10 replays each arm: {launched} prologue launches; counters "
          f"{ {k: v for k, v in counted.items() if k.startswith('step.')} }", flush=True)
    require(launched == 10 and counted.get("step.kernel_updates") == 20
            and counted.get("step.prologue_fused") == 10,
            "not one prologue launch a replay, or the counters are off")
    ops = {}
    for arm in ("plain", "kernel"):
        with profiling.device_profile() as prof:   # its warm-up cycle discarded
            for _ in range(5):
                updater(arm)()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        names = {}
        for e in events:
            names[e.name[:60]] = names.get(e.name[:60], 0) + 1
        ops[arm] = dict(ops_per_update=len(events) / 5,
                        prologue_us=[e.time_range.elapsed_us() for e in events
                                     if "step_prologue_kernel" in e.name],
                        names=names)
        print(f"[37 profile] {arm} prologue: {len(events) / 5:.1f} device ops an update; "
              f"prologue kernel us {ops[arm]['prologue_us']}", flush=True)
    record["profile"] = ops
    times = time_interleaved({arm: (updater(arm), 20) for arm in ("plain", "kernel")}, 7)
    med = {arm: statistics.median(v) for arm, v in times.items()}
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    record["times_ms"] = med
    print(f"[37 timing] the replayed flagship update, median of 7 CUDA-event reps of 20 on "
          f"{card} (after: sm clock, draw, limit, temp = {clocks}): plain prologue "
          f"{med['plain']:.4f} ms, kernel prologue {med['kernel']:.4f} ms; propagations/s "
          f"{K_MAIN * (T_MAIN - 1) / (med['plain'] * 1e-3):.4e} -> "
          f"{K_MAIN * (T_MAIN - 1) / (med['kernel'] * 1e-3):.4e}", flush=True)

    # the prologue alone at the flagship: the kernel's launch against the
    # op-by-op glue it replaced (the plain version, the centred rows and
    # start state, the tickets' zeros), each a CUDA graph of 20
    key = make_key(37, 0, dev)
    tickets = pro.ticket_count(cfg.num_samples)
    ops_alone = pro._kernel_operands(cfg, path, state, dt, sp, cp, None, None, key)

    def kernel_alone():
        pro.step_prologue_cuda(**ops_alone, tickets_per_robot=tickets)

    def plain_alone():
        want = pro.step_prologue_plain(cfg, path, state, dt, sp, cp, None, None, key)
        centred(want.ref.xy, state)
        torch.zeros(tickets, dtype=torch.int32, device=dev)

    alone = time_interleaved({"kernel": (graph_replay(kernel_alone, 20), 1),
                              "plain": (graph_replay(plain_alone, 20), 1)}, 7)
    alone = {arm: statistics.median(v) / 20 for arm, v in alone.items()}
    nbytes, (bound_ms, _) = prologue_bound(int(path.num_valid), T_MAIN, state.numel(),
                                           tickets)
    record["alone_ms"] = alone
    record["bound"] = {"bytes": nbytes, "ms": bound_ms}
    # every case above is bit-equal on every output
    record["max_abs_err"] = 0.0
    print(f"[37 alone] the prologue at N={int(path.num_valid)} T={T_MAIN}, a launch of a "
          f"graph of 20, median of 7 on {card}: kernel {alone['kernel']:.6f} ms, the "
          f"op-by-op glue {alone['plain']:.6f} ms; bound {bound_ms:.3e} ms ({nbytes} B at "
          f"the HBM rate)", flush=True)
    counters_zero("step prologue")
    return record


NN_SEEDS = 4               # phase 38: seeded cases a shape
NN_COST_RTOL = 2e-5        # phase 38: kernel vs op by op, the costs (COST_RTOL)
NN_U_GAP = 1e-6            # phase 38: kernel vs op by op, the update, of the box


def nn_case(k, t, seed, dev):
    """(cfg, sp, cp, path, state, ctrl) of the AutoRally network model at K=k,
    T=t on its preset's course: a seeded pose near the course's start with a
    seeded roll and velocities, a seeded warm start inside the box."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core.presets import autorally_nn_launch
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer

    cfg, sp, cp, course = autorally_nn_launch(num_samples=k, horizon=t, device=dev)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    g = torch.Generator().manual_seed(seed)
    state = torch.zeros(7)
    state[:2] = torch.as_tensor(course[2], dtype=torch.float32) + 0.1 * torch.randn(2, generator=g)
    state[2] = 0.2 * torch.randn((), generator=g)
    state[3:] = 0.3 * torch.randn(4, generator=g)
    u_prev = torch.clamp(0.4 * torch.randn((t - 1, 2), generator=g), -1.0, 1.0)
    return (cfg, sp, cp, path, state.to(dev),
            ControllerState(u_prev.to(dev), seed, 0))


def nn_cell_case(seed, dev):
    """nn_case's tuple as the cell autorally_nn.update draws it from a seed
    (benchmark/harness.py): the course at a seeded offset, a seeded pose at
    its start, at rest, a zero warm start."""
    import torch

    from benchmark import harness
    from ccv_mppi_path_tracker_tpu_torch.core.presets import autorally_nn_launch
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer

    with open(ROOT / "benchmark" / "configs" / "autorally_nn-K102400-T30.json") as f:
        conf = json.load(f)
    rng = harness.inputs_rng(seed)
    course = harness.course_for(conf, {"course_offset_m": 1.0}, rng)
    pose = torch.from_numpy(harness.start_pose(course, 7, rng, [0.05] * 3))
    cfg, sp, cp, _ = autorally_nn_launch(num_samples=K_MAIN, horizon=T_MAIN, device=dev)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    return (cfg, sp, cp, path, pose.to(dev),
            ControllerState.initial(seed, T_MAIN, 2, device=dev))


def phase_38(dev, card, counters_zero):
    """Phase 38: the eager update's network rollout and cost
    (kernels/network_rollout.py, csrc/network_rollout.cu) against the plain
    version, models/autorally_nn.py cost(rollout(...)), on the card, float32:
    (a) its build and ptxas report (registers, spills); (b) the costs of
    NN_SEEDS seeded cases at K=102400 T=30 and at a ragged K=1000 T=15,
    each sample's within NN_COST_RTOL, and the counters model.nn_evals and
    model.nn_fused K·(T-1) each; the dispatch (autorally_nn.rollout_cost)
    launching it on the cell's shape and taking the plain version under
    float64, grad and vmap; (c) compiled updates (compile_step, "auto", lean)
    against op-by-op updates with the plain rollout on the cell's inputs
    (nn_cell_case), |du|/box under NN_U_GAP, 3 seeds of 3 chained updates,
    and on a case whose softmax rests on a few samples (nn_case, printed: a
    cost's rounding moves its update ~100x more); (d) weights changed in
    place between two replays reach the kernel: the default weights (read by
    the graph as they are) and weights passed as model_params; (e) 20 replays of the
    compiled update: 20 launches, the counters 20 K·(T-1) each, and by
    torch.profiler the device ops and the kernel's time an update; (f)
    CUDA-event times in turns: the kernel (a graph of 20 launches) and the
    plain version (a graph of one), the compiled update with either; the
    kernel beside benchmark/work_nn.py's bound. Returns its record."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType

    from benchmark import work, work_nn
    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels import network_rollout as nr
    from ccv_mppi_path_tracker_tpu_torch.models import autorally_nn
    from ccv_mppi_path_tracker_tpu_torch.paths import resample_reference
    from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals, sample_controls
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step, mppi_step
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    record = {}
    # (a) the build
    lib_path, build_s, log = build.build("network_rollout")
    ptxas = build.ptxas_summary(log or "")
    print(f"[38 build] {lib_path.name} in {build_s:.2f} s; ptxas {ptxas}", flush=True)
    require(all("rollout_cost_kernel" not in name for name in ptxas),
            "a network rollout entry point carries the fused kernel's name")
    record["ptxas"] = ptxas
    dt = torch.full((), 0.1, device=dev)

    def operands(k, t, seed):
        cfg, sp, cp, path, state, ctrl = nn_case(k, t, seed, dev)
        ref = resample_reference(path, state[:2], cp.v_ref, dt, t)
        noise = draw_standard_normals(**ctrl.rng(), shape=(t - 1, k, 2), device=dev)
        u = sample_controls(ctrl.u_prev, sp, k, noise=noise)
        return state, u, ref, cp, autorally_nn.default_params(dev)

    # (b) the costs against the plain version, and the dispatch
    worst = {}
    for k, t in ((K_MAIN, T_MAIN), (1000, 15)):
        for seed in range(NN_SEEDS):
            state, u, ref, cp, p = operands(k, t, seed)
            evals = torch.zeros(1, dtype=torch.int64, device=dev)
            fused = torch.zeros(1, dtype=torch.int64, device=dev)
            got = nr.network_rollout_cost(state, u, dt, p, ref.xy.contiguous(), cp, evals, fused)
            want = autorally_nn.cost(autorally_nn.euler_states(state.expand(k, -1), u, dt, p), u,
                                     {}, ref, cp)
            torch.cuda.synchronize()
            rel = float(((got.double() - want.double()).abs() / want.double().abs()).max())
            worst[f"K{k}_T{t}"] = max(worst.get(f"K{k}_T{t}", 0.0), rel)
            print(f"  K={k} T={t} seed {seed}: costs {float(want.min()):.4f} .. "
                  f"{float(want.max()):.4f}, max rel {rel:.3e}; counters "
                  f"{evals.item()} {fused.item()}", flush=True)
            require(bool(torch.isfinite(got).all()) and rel <= NN_COST_RTOL,
                    f"K={k} T={t} seed {seed}: the kernel's costs differ by {rel}")
            require(evals.item() == fused.item() == k * (t - 1),
                    f"K={k} T={t}: counters {evals.item()} {fused.item()}")
    record["cost_max_rel"] = worst
    state, u, ref, cp, p = operands(K_MAIN, T_MAIN, 9)
    state0 = state.expand(K_MAIN, -1)
    before = nr.network_rollout_cost.launches
    routed = autorally_nn.rollout_cost(state0, u, dt, p, ref, cp)
    require(nr.network_rollout_cost.launches == before + 1,
            "rollout_cost did not launch the kernel on the cell's shape")
    torch.cuda.synchronize()
    p64 = autorally_nn.default_params(dev, torch.float64)
    cp64 = dataclasses.replace(cp, **{f.name: getattr(cp, f.name).double()
                                      for f in dataclasses.fields(cp)})
    plain_calls = {
        "float64": lambda: autorally_nn.rollout_cost(state0.double(), u.double(), dt.double(),
                                                     p64, type(ref)(ref.xy.double(),
                                                                    ref.yaw.double()), cp64),
        "grad": lambda: autorally_nn.rollout_cost(state0, u.clone().requires_grad_(True), dt,
                                                  p, ref, cp),
        "vmap": lambda: torch.func.vmap(
            lambda s: autorally_nn.rollout_cost(s.expand(64, -1), u[:, :64], dt, p, ref, cp))(
                state[None].expand(2, -1)),
        "states": lambda: autorally_nn.rollout_cost(state0.contiguous(), u, dt, p, ref, cp),
    }
    for name, call in plain_calls.items():
        before = nr.network_rollout_cost.launches
        with torch.enable_grad():
            call()
        require(nr.network_rollout_cost.launches == before,
                f"rollout_cost launched the kernel under {name}")
    print(f"[38 compare] the kernel against the plain version: max rel cost {worst} "
          f"(gate {NN_COST_RTOL}); counters K(T-1) each; the dispatch launches on the "
          f"cell's shape, not under {list(plain_calls)}", flush=True)

    # (c) compiled updates against the op-by-op update with the plain rollout
    fused_operands = autorally_nn._fused_operands

    def plain_arm():
        autorally_nn._fused_operands = lambda *a: None

    def kernel_arm():
        autorally_nn._fused_operands = fused_operands

    def updates(case, chained):
        """|du|/box of each of `chained` compiled updates against the
        op-by-op update with the plain rollout from the same warm start."""
        cfg, sp, cp, path, state, ctrl = case
        box = (sp.u_max - sp.u_min).double()
        step = compile_step(cfg, use_kernel="auto", lean=True)
        gaps = []
        for _ in range(chained):
            before = nr.network_rollout_cost.launches
            nxt, res_k = step(ctrl, state, path, dt, sp, cp)
            plain_arm()
            try:
                _, res_p = mppi_step(cfg, ctrl, state, path, dt, sp, cp, lean=True)
            finally:
                kernel_arm()
            torch.cuda.synchronize()
            require(nr.network_rollout_cost.launches == before + 1, "not one launch an update")
            gaps.append(float(((res_k.u_opt.double() - res_p.u_opt.double()).abs()
                               / box).max()))
            ctrl = nxt
        return gaps

    gaps = {}
    for seed in (2**31 + 38, 2**32 + 5, 12345):
        gaps[seed] = updates(nn_cell_case(seed, dev), 3)
        print(f"  cell seed {seed}: |du|/box {gaps[seed]}", flush=True)
        require(max(gaps[seed]) <= NN_U_GAP,
                f"seed {seed}: the compiled update differs by {max(gaps[seed])} of the box")
    stress = updates(nn_case(K_MAIN, T_MAIN, 100, dev), 1)[0]
    record["u_gap"] = max(max(g) for g in gaps.values())
    record["u_gap_few_samples"] = stress
    print(f"[38 update] compiled updates with the kernel against op-by-op updates with the "
          f"plain rollout: max |du|/box {record['u_gap']:.3e} on the cell's inputs (gate "
          f"{NN_U_GAP}); {stress:.3e} where the softmax rests on a few samples", flush=True)

    # (d) weights changed in place reach the kernel at a replay
    cfg, sp, cp, path, state, ctrl = nn_cell_case(200, dev)
    box = (sp.u_max - sp.u_min).double()
    mine = autorally_nn.NNParams(*[t.clone() for t in dataclasses.astuple(
        autorally_nn.default_params(dev))])
    for name in ("default", "model_params"):
        params = autorally_nn.default_params(dev) if name == "default" else mine
        kw = {} if name == "default" else {"model_params": mine}
        step = compile_step(cfg, use_kernel="auto", lean=True)
        for _ in range(2):
            _, before_res = step(ctrl, state, path, dt, sp, cp, **kw)
        params.w3.mul_(-1.0)
        params.b3.mul_(-1.0)
        try:
            _, after_res = step(ctrl, state, path, dt, sp, cp, **kw)
            plain_arm()
            try:
                _, want = mppi_step(cfg, ctrl, state, path, dt, sp, cp, lean=True, **kw)
            finally:
                kernel_arm()
            torch.cuda.synchronize()
        finally:
            params.w3.mul_(-1.0)
            params.b3.mul_(-1.0)
        moved = float(((after_res.u_opt - before_res.u_opt).double().abs() / box).max())
        gap = float(((after_res.u_opt - want.u_opt).double().abs() / box).max())
        print(f"[38 in place] {name} weights: W3, b3 negated in place between replays "
              f"(captures {step.captures}): the update moved {moved:.3e} of the box, "
              f"{gap:.3e} from the op-by-op update with the new weights", flush=True)
        require(step.captures == 1 and moved > 1e-3 and gap <= NN_U_GAP,
                f"{name} weights changed in place did not reach the kernel")

    # (e) one launch a replay, the counters, the device ops
    cfg, sp, cp, path, state, ctrl = nn_case(K_MAIN, T_MAIN, 300, dev)
    step = compile_step(cfg, use_kernel="auto", lean=True)
    carry = [ctrl]

    def update():
        carry[0], _ = step(carry[0], state, path, dt, sp, cp)

    for _ in range(3):
        update()
    torch.cuda.synchronize()
    profiling.reset()
    before = nr.network_rollout_cost.launches
    for _ in range(20):
        update()
    torch.cuda.synchronize()
    launched = nr.network_rollout_cost.launches - before
    counted = profiling.counters()
    print(f"[38 replay] 20 replays of the compiled update: {launched} kernel launches, "
          f"counters {counted}", flush=True)
    n_evals = 20 * K_MAIN * (T_MAIN - 1)
    require(launched == 20 and counted.get("model.nn_evals") == n_evals
            and counted.get("model.nn_fused") == n_evals,
            "the replayed update does not take the kernel once")
    record["launches_20_replays"] = launched
    with profiling.device_profile() as prof:
        for _ in range(5):
            update()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine_ev = [e for e in events if "network_rollout_kernel" in e.name]
    if events:
        kernel_us = [e.time_range.elapsed_us() for e in mine_ev]
        busy = sum(e.time_range.elapsed_us() for e in events) / 5
        record["replay"] = dict(device_ops=len(events) / 5, kernel_us=kernel_us, busy_us=busy)
        print(f"[38 profile] 5 replays: {len(events) / 5:.1f} device ops an update, "
              f"{busy:.1f} us busy an update; {len(mine_ev)} network_rollout_kernel events of "
              f"{kernel_us} us", flush=True)
        require(len(mine_ev) == 5, "not one network rollout launch a replay")
    else:
        print("[38 profile] the profiler recorded no device activity: not measured",
              flush=True)

    # (f) times in turns
    state, u, ref, cp, p = operands(K_MAIN, T_MAIN, 400)
    xy = ref.xy.contiguous()
    plain_cfg, plain_sp, plain_cp, plain_path, plain_state, plain_ctrl = nn_case(
        K_MAIN, T_MAIN, 401, dev)
    steps = {}

    def updater(key):
        step = compile_step(plain_cfg, use_kernel="auto", lean=True)
        steps[key] = [plain_ctrl]

        def fn():
            steps[key][0], _ = step(steps[key][0], plain_state, plain_path, dt, plain_sp,
                                    plain_cp)
        fn()
        return fn

    update_kernel = updater("kernel")
    plain_arm()
    try:
        update_plain = updater("plain")
        rollout_plain = graph_replay(lambda: autorally_nn.cost(
            autorally_nn.euler_states(state.expand(K_MAIN, -1), u, dt, p), u, {}, ref, cp), 1)
    finally:
        kernel_arm()
    arms = {
        "kernel": (graph_replay(lambda: nr.network_rollout_cost(state, u, dt, p, xy, cp), 20), 1),
        "plain_graphed": (rollout_plain, 1),
        "update/kernel": (update_kernel, 20),
        "update/plain": (update_plain, 5),
    }
    times = time_interleaved(arms, 5, warm=1)
    med = {name: statistics.median(v) for name, v in times.items()}
    med["kernel"] /= 20
    bound_ms = work_nn.update_flops(K_MAIN, T_MAIN) / work.FP32_PEAK * 1e3
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    props = {k: K_MAIN * (T_MAIN - 1) / (v * 1e-3) for k, v in med.items()
             if k.startswith("update/")}
    record.update(times_ms=med, bound_ms=bound_ms, propagations_per_s=props)
    print(f"[38 timing] median of 5 CUDA-event reps on {card} (after: sm clock, draw, limit, "
          f"temp = {clocks}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in med.items())
          + f"; the kernel at {100 * bound_ms / med['kernel']:.2f} % of work_nn's bound "
            f"{bound_ms:.4f} ms; propagations/s "
          + ", ".join(f"{k} {v:.4e}" for k, v in props.items()), flush=True)
    counters_zero("network rollout kernel")
    return record


PE_SEEDS = (2**31 + 39, 2**32 + 9)   # phase 39: the cell's inputs, two seeds


def pe_cell_case(seed, dev):
    """(conf, course, cfg, sp, cp, path, pose) of PETS's ensemble as the cell
    pets_pe.update draws them from a seed (benchmark/harness.py): the course
    at a seeded offset, a seeded pose at its start, at rest."""
    import torch

    from benchmark import harness
    from ccv_mppi_path_tracker_tpu_torch.core.presets import pets_pe_launch
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer

    with open(ROOT / "benchmark" / "configs" / "pets_pe-K5120-P20-T30.json") as f:
        conf = json.load(f)
    rng = harness.inputs_rng(seed)
    course = harness.course_for(conf, {"course_offset_m": 1.0}, rng)
    pose = torch.from_numpy(harness.start_pose(course, 7, rng, [0.05] * 3))
    cfg, sp, cp, _ = pets_pe_launch(num_samples=conf["num_samples"], horizon=conf["horizon"],
                                    device=dev)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    return conf, course, cfg, sp, cp, path, pose.to(dev)


def phase_39(dev, card):
    """Phase 39: PETS's probabilistic ensemble (models/pets_pe.py) at its
    published widths, K=5120 sequences of P=20 particles, T=30, through
    compile_step(use_kernel="auto", lean=True) against
    benchmark/reference_pe.py, float32 with TF32 off: (a) PE_SEEDS seeds of 3
    chained updates, the first the capture and the others replays of one
    CUDA graph, each within the cell's u_gap limit of the reference's update
    at its own step; (b) each replay drew its propagation normals anew: it
    lies far from the reference whose propagation stream is held at step 0;
    (c) the device counter model.pe_evals K·P·(T-1) an update,
    model.pe_nonfinite 0; (d) the memory peak of the updates; (e) 20 chained
    replays timed by CUDA events and 3 profiled: ms, device ops and busy
    time an update, the update's share of the float32 peak by
    benchmark/work_pe.py. Returns its record."""
    import torch
    from torch.autograd import DeviceType

    from benchmark import reference, reference_pe, work, work_pe
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    with open(ROOT / "benchmark" / "limits" / "pets_pe.update.json") as f:
        limit = json.load(f)["u_gap"]
    record = {}
    dt = torch.full((), 0.1, device=dev)
    normals = reference.normals

    def held(seed, step, robots, *rest):
        """reference.normals with the propagation stream held at step 0."""
        return normals(seed, 0 if robots[0] >= reference_pe.PROPAGATION_ROBOT else step,
                       robots, *rest)

    # (a)-(d) chained updates against the reference
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    profiling.reset()
    runs, updates, peak = [], 0, 0
    for seed in PE_SEEDS:
        conf, course, cfg, sp, cp, path, pose = pe_cell_case(seed, dev)
        step = compile_step(cfg, use_kernel="auto", lean=True)
        ctrl = ControllerState.initial(seed, conf["horizon"], 2, device=dev)
        for n in range(3):
            u_prev = None if n == 0 else ctrl.u_prev[None].clone()
            ctrl, res = step(ctrl, pose, path, dt, sp, cp)
            runs.append((seed, n, conf, course, pose, u_prev, res.u_opt.clone()))
            updates += 1
        require(step.captures == 1, f"seed {seed}: {step.captures} captures of one shape")
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    counted = profiling.counters()
    box = 2.0
    gaps, held_gaps = [], []
    for seed, n, conf, course, pose, u_prev, got in runs:
        want = reference_pe.update(conf, course, pose[None], u_prev, seed, n)[0]
        gaps.append(float((got.double() - want.double()).abs().max()) / box)
        line = f"  seed {seed} update {n}: |du|/box {gaps[-1]:.3e}"
        if n:
            reference.normals = held
            try:
                frozen = reference_pe.update(conf, course, pose[None], u_prev, seed, n)[0]
            finally:
                reference.normals = normals
            held_gaps.append(float((got.double() - frozen.double()).abs().max()) / box)
            line += f"; {held_gaps[-1]:.3e} from the reference with step 0's particles"
        print(line, flush=True)
    evals = conf["num_samples"] * conf["particles"] * (conf["horizon"] - 1)
    record.update(u_gap=max(gaps), held_u_gap_min=min(held_gaps), counters=counted,
                  memory_peak_bytes=peak)
    print(f"[39 update] {updates} compiled updates against reference_pe: max |du|/box "
          f"{max(gaps):.3e} (limit {limit}); the replays {min(held_gaps):.3e} or more from "
          f"a reference whose particles keep step 0's normals; counters {counted}; memory "
          f"peak {peak} B", flush=True)
    require(max(gaps) <= limit, f"an update differs from the reference by {max(gaps)}")
    require(min(held_gaps) > 10 * limit, "a replay did not draw its particles anew")
    require(counted.get("model.pe_evals") == updates * evals
            and not counted.get("model.pe_nonfinite"),
            f"counters {counted}, not {evals} evaluations an update and no non-finite cost")

    # (e) times and device ops of chained replays
    conf, course, cfg, sp, cp, path, pose = pe_cell_case(PE_SEEDS[0], dev)
    step = compile_step(cfg, use_kernel="auto", lean=True)
    carry = [ControllerState.initial(7, conf["horizon"], 2, device=dev)]

    def update():
        carry[0], _ = step(carry[0], pose, path, dt, sp, cp)

    for _ in range(3):
        update()
    torch.cuda.synchronize()
    ms = statistics.median(event_ms(update, 20) for _ in range(3))
    flops = work_pe.update_flops(conf["num_samples"], conf["horizon"], conf["particles"])
    with profiling.device_profile() as prof:
        for _ in range(3):
            update()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    record.update(ms=ms, propagations_per_s=conf["num_samples"] * (conf["horizon"] - 1)
                  / (ms * 1e-3), mfu=100.0 * flops / (ms * 1e-3 * work.FP32_PEAK),
                  device_ops=len(events) / 3, busy_us=sum(by_name.values()),
                  top_ops_us=[[name[:80], us] for name, us in top])
    print(f"[39 timing] on {card} (sm clock, draw, limit, temp = {clocks}): {ms:.3f} ms an "
          f"update, {record['propagations_per_s']:.4e} propagations/s, {record['mfu']:.2f} % "
          f"of the float32 peak by work_pe; {record['device_ops']:.1f} device ops and "
          f"{record['busy_us']:.1f} us busy an update; top ops (us an update): "
          + "; ".join(f"{name[:60]} {us:.1f}" for name, us in top), flush=True)
    return record


PE_CELL = (5120, 30)    # phase 40: (K, T) of the cell pets_pe.update
PE_RAGGED = (1001, 15)  # phase 40: a K whose last tile is partial, a shorter T
PE_COST_RTOL = 2e-5     # phase 40: kernel vs op by op, each particle's cost
PE_U_GAP = 1e-6         # phase 40: kernel vs op by op, the update, of the box


def phase_40(dev, card):
    """Phase 40: the eager update's PETS ensemble rollout
    (kernels/pets_rollout.py, csrc/pets_rollout.cu) against the op-by-op
    version, models/pets_pe.py states_cost(particle_states(...)), on the
    card, float32 with TF32 off: (a) its build and ptxas report (registers,
    spills, shared memory); (b) each particle's cost at the cell's shape
    (K=5120, P=20, T=30) for PE_SEEDS and at a ragged K=1001, T=15, within
    PE_COST_RTOL, the counters
    model.pe_evals and model.pe_fused K·P·(T-1) each; the dispatch
    (pets_pe.rollout_cost) launching it on the cell's shape and taking the
    op-by-op version under float64, grad and vmap; (c) compiled updates
    (compile_step, "auto", lean) on the cell's inputs against op-by-op updates
    from the same warm start, |du|/box under PE_U_GAP, 2 seeds of 3 chained
    updates; (d) a hidden matrix and the head's mean rows changed in place
    between two replays reach the kernel; (e) 20 replays of the compiled
    update: 20 launches, the counters 20 K·P·(T-1) each, and by
    torch.profiler the device ops and the kernel's time an update; (f)
    CUDA-event times in turns: the kernel (a graph of 20 launches) and the
    op-by-op chain (a graph of one), the compiled update with either; the
    kernel beside benchmark/work_pe.py's bound. Every check is made before
    the phase fails on the first that did not hold. Returns its record."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType

    from benchmark import work, work_pe
    from ccv_mppi_path_tracker_tpu_torch.core.random import PROPAGATION_ROBOT
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.kernels import build
    from ccv_mppi_path_tracker_tpu_torch.kernels import pets_rollout as pr
    from ccv_mppi_path_tracker_tpu_torch.models import pets_pe
    from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals, sample_controls
    from ccv_mppi_path_tracker_tpu_torch.paths import resample_reference
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step, mppi_step
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record, failed = {}, []

    def check(ok, what):
        if not ok:
            failed.append(what)
            print(f"  FAILED: {what}", flush=True)

    # (a) the build
    lib_path, build_s, log = build.build("pets_rollout")
    ptxas = build.ptxas_summary(log or "")
    print(f"[40 build] {lib_path.name} in {build_s:.2f} s; ptxas {ptxas}", flush=True)
    require(all("rollout_cost_kernel" not in name for name in ptxas),
            "a PETS rollout entry point carries the fused kernel's name")
    record["ptxas"] = ptxas
    dt = torch.full((), 0.1, device=dev)

    def operands(k, t, seed):
        """(state (7,), controls, normals, params, ref, cp) of the cell's
        course at K=k, T=t: a seeded start with a seeded roll and velocities,
        a seeded warm start's samples, the step's propagation normals."""
        conf, course, cfg, sp, cp, path, pose = pe_cell_case(seed, dev)
        g = torch.Generator().manual_seed(seed)
        pose = pose.clone()
        pose[3:] = (0.2 * torch.randn(4, generator=g)).to(dev)
        ref = resample_reference(path, pose[:2], cp.v_ref, dt, t)
        u_prev = torch.clamp(0.4 * torch.randn((t - 1, 2), generator=g), -1.0, 1.0).to(dev)
        noise = draw_standard_normals(None, seed, 3, shape=(t - 1, k, 2), device=dev)
        u = sample_controls(u_prev, sp, k, noise=noise)
        normals = draw_standard_normals(None, seed, 3, shape=(t - 1, k * pets_pe.PARTICLES, 4),
                                        robot=PROPAGATION_ROBOT, device=dev)
        return pose, u, normals, pets_pe.default_params(dev), ref, cp

    def plain_costs(state, u, normals, p, ref, cp):
        k = u.shape[1]
        return pets_pe.states_cost(pets_pe.particle_states(
            state.expand(k, 7), u, dt, p, normals), ref.xy, cp)

    # (b) the costs against the op-by-op version, and the dispatch
    worst = {}
    for k, t, seed in [(*PE_CELL, seed) for seed in PE_SEEDS] + [(*PE_RAGGED, 77)]:
        state, u, normals, p, ref, cp = operands(k, t, seed)
        evals = torch.zeros(1, dtype=torch.int64, device=dev)
        fused = torch.zeros(1, dtype=torch.int64, device=dev)
        got = pr.pets_rollout_cost(state, u, normals, dt, p, ref.xy.contiguous(), cp,
                                   evals, fused)
        want = plain_costs(state, u, normals, p, ref, cp)
        torch.cuda.synchronize()
        rel = float(((got.double() - want.double()).abs() / want.double().abs()).max())
        key = f"K{k}_T{t}"
        worst[key] = max(worst.get(key, 0.0), rel)
        print(f"  K={k} T={t} seed {seed}: costs {float(want.min()):.4f} .. "
              f"{float(want.max()):.4f}, max rel {rel:.3e}; counters "
              f"{evals.item()} {fused.item()}", flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= PE_COST_RTOL,
              f"K={k} T={t} seed {seed}: the kernel's costs differ by {rel}")
        n = k * pets_pe.PARTICLES * (t - 1)
        check(evals.item() == fused.item() == n,
              f"K={k} T={t}: counters {evals.item()} {fused.item()}, not {n}")
    record["cost_max_rel"] = worst
    state, u, normals, p, ref, cp = operands(*PE_CELL, 9)
    state0 = state.expand(PE_CELL[0], -1)
    rng = dict(seed=9, step=3)
    before = pr.pets_rollout_cost.launches
    pets_pe.rollout_cost(state0, u, dt, p, ref, cp, **rng)
    check(pr.pets_rollout_cost.launches == before + 1,
          "rollout_cost did not launch the kernel on the cell's shape")
    torch.cuda.synchronize()
    few = min(64, PE_CELL[0])
    p64 = pets_pe.default_params(dev, torch.float64)
    cp64 = dataclasses.replace(cp, **{f.name: getattr(cp, f.name).double()
                                      for f in dataclasses.fields(cp)})
    plain_calls = {
        "float64": lambda: pets_pe.rollout_cost(state0[:few].double(), u[:, :few].double(),
                                                dt.double(), p64, type(ref)(
                                                    ref.xy.double(), ref.yaw.double()),
                                                cp64, **rng),
        "grad": lambda: pets_pe.rollout_cost(state0[:few], u[:, :few].clone().requires_grad_(True),
                                             dt, p, ref, cp, **rng),
        "vmap": lambda: torch.func.vmap(
            lambda s: pets_pe.rollout_cost(s.expand(few, -1), u[:, :few], dt, p, ref, cp,
                                           **rng))(state[None].expand(2, -1)),
    }
    for name, call in plain_calls.items():
        before = pr.pets_rollout_cost.launches
        with torch.enable_grad():
            call()
        check(pr.pets_rollout_cost.launches == before,
              f"rollout_cost launched the kernel under {name}")
    print(f"[40 compare] the kernel against the op-by-op version: max rel cost {worst} "
          f"(gate {PE_COST_RTOL}); counters K·P·(T-1) each; the dispatch launches on the "
          f"cell's shape, not under {list(plain_calls)}", flush=True)

    # (c) compiled updates against the op-by-op update
    fused_operands = pets_pe._fused_operands

    def plain_arm():
        pets_pe._fused_operands = lambda *a: None

    def kernel_arm():
        pets_pe._fused_operands = fused_operands

    def updates(seed, chained, box):
        conf, course, cfg, sp, cp, path, pose = pe_cell_case(seed, dev)
        step = compile_step(cfg, use_kernel="auto", lean=True)
        ctrl = ControllerState.initial(seed, conf["horizon"], 2, device=dev)
        gaps = []
        for _ in range(chained):
            before = pr.pets_rollout_cost.launches
            nxt, res_k = step(ctrl, pose, path, dt, sp, cp)
            plain_arm()
            try:
                _, res_p = mppi_step(cfg, ctrl, pose, path, dt, sp, cp, lean=True)
            finally:
                kernel_arm()
            torch.cuda.synchronize()
            check(pr.pets_rollout_cost.launches == before + 1, "not one launch an update")
            gaps.append(float(((res_k.u_opt.double() - res_p.u_opt.double()).abs()
                               / box).max()))
            ctrl = nxt
        return gaps

    gaps = {}
    for seed in PE_SEEDS:
        gaps[seed] = updates(seed, 3, 2.0)
        print(f"  cell seed {seed}: |du|/box {gaps[seed]}", flush=True)
        check(max(gaps[seed]) <= PE_U_GAP,
              f"seed {seed}: the compiled update differs by {max(gaps[seed])} of the box")
    record["u_gap"] = max(max(g) for g in gaps.values())
    print(f"[40 update] compiled updates with the kernel against op-by-op updates: max "
          f"|du|/box {record['u_gap']:.3e} on the cell's inputs (gate {PE_U_GAP})", flush=True)

    # (d) weights changed in place reach the kernel at a replay
    conf, course, cfg, sp, cp, path, pose = pe_cell_case(PE_SEEDS[1], dev)
    ctrl = ControllerState.initial(11, conf["horizon"], 2, device=dev)
    params = pets_pe.default_params(dev)
    step = compile_step(cfg, use_kernel="auto", lean=True)
    for _ in range(2):
        _, before_res = step(ctrl, pose, path, dt, sp, cp)

    def flip():
        params.w[2].mul_(-1.0)
        params.w[-1][:, :4].mul_(-1.0)
        params.b[-1][:, :4].mul_(-1.0)

    flip()
    try:
        _, after_res = step(ctrl, pose, path, dt, sp, cp)
        plain_arm()
        try:
            _, want = mppi_step(cfg, ctrl, pose, path, dt, sp, cp, lean=True)
        finally:
            kernel_arm()
        torch.cuda.synchronize()
    finally:
        flip()
    moved = float(((after_res.u_opt - before_res.u_opt).double().abs() / 2.0).max())
    gap = float(((after_res.u_opt - want.u_opt).double().abs() / 2.0).max())
    print(f"[40 in place] W3 and the head's mean rows negated in place between replays "
          f"(captures {step.captures}): the update moved {moved:.3e} of the box, {gap:.3e} "
          f"from the op-by-op update with the new weights", flush=True)
    check(step.captures == 1 and moved > 1e-3 and gap <= PE_U_GAP,
          "weights changed in place did not reach the kernel")

    # (e) one launch a replay, the counters, the device ops
    conf, course, cfg, sp, cp, path, pose = pe_cell_case(PE_SEEDS[0], dev)
    step = compile_step(cfg, use_kernel="auto", lean=True)
    carry = [ControllerState.initial(5, conf["horizon"], 2, device=dev)]

    def update():
        carry[0], _ = step(carry[0], pose, path, dt, sp, cp)

    for _ in range(3):
        update()
    torch.cuda.synchronize()
    profiling.reset()
    before = pr.pets_rollout_cost.launches
    for _ in range(20):
        update()
    torch.cuda.synchronize()
    launched = pr.pets_rollout_cost.launches - before
    counted = profiling.counters()
    n_evals = 20 * conf["num_samples"] * conf["particles"] * (conf["horizon"] - 1)
    print(f"[40 replay] 20 replays of the compiled update: {launched} kernel launches, "
          f"counters {counted}", flush=True)
    check(launched == 20 and counted.get("model.pe_evals") == n_evals
          and counted.get("model.pe_fused") == n_evals,
          "the replayed update does not take the kernel once")
    record["launches_20_replays"] = launched
    with profiling.device_profile() as prof:
        for _ in range(3):
            update()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine_ev = [e for e in events if "pets_rollout_kernel" in e.name]
    if events:
        kernel_us = [e.time_range.elapsed_us() for e in mine_ev]
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 3
        others = sorted(((n, us) for n, us in by_name.items()
                         if "pets_rollout_kernel" not in n), key=lambda kv: -kv[1])[:6]
        record["replay"] = dict(device_ops=len(events) / 3, kernel_us=kernel_us,
                                busy_us=sum(by_name.values()),
                                top_others_us=[[n[:80], us] for n, us in others])
        print(f"[40 profile] 3 replays: {len(events) / 3:.1f} device ops an update, "
              f"{record['replay']['busy_us']:.1f} us busy an update; {len(mine_ev)} "
              f"pets_rollout_kernel events of {kernel_us} us; others (us an update): "
              + "; ".join(f"{n[:50]} {us:.1f}" for n, us in others), flush=True)
        check(len(mine_ev) == 3, "not one PETS rollout launch a replay")
    else:
        print("[40 profile] the profiler recorded no device activity: not measured",
              flush=True)

    # (f) times in turns
    state, u, normals, p, ref, cp = operands(*PE_CELL, 400)
    xy = ref.xy.contiguous()
    steps = {}

    def updater(key):
        conf, course, cfg, sp, cp_, path, pose = pe_cell_case(PE_SEEDS[1], dev)
        step = compile_step(cfg, use_kernel="auto", lean=True)
        steps[key] = [ControllerState.initial(13, conf["horizon"], 2, device=dev)]

        def fn():
            steps[key][0], _ = step(steps[key][0], pose, path, dt, sp, cp_)
        fn()
        return fn

    update_kernel = updater("kernel")
    plain_arm()
    try:
        update_plain = updater("plain")
        chain_plain = graph_replay(lambda: plain_costs(state, u, normals, p, ref, cp), 1)
    finally:
        kernel_arm()
    arms = {
        "kernel": (graph_replay(lambda: pr.pets_rollout_cost(state, u, normals, dt, p, xy, cp),
                                20), 1),
        "plain_graphed": (chain_plain, 1),
        "update/kernel": (update_kernel, 5),
        "update/plain": (update_plain, 3),
    }
    times = time_interleaved(arms, 3, warm=1)
    med = {name: statistics.median(v) for name, v in times.items()}
    med["kernel"] /= 20
    bound_ms = work_pe.update_flops(*PE_CELL, pets_pe.PARTICLES) / work.FP32_PEAK * 1e3
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    props = {k: PE_CELL[0] * (PE_CELL[1] - 1) / (v * 1e-3) for k, v in med.items() if k.startswith("update/")}
    record.update(times_ms=med, bound_ms=bound_ms, propagations_per_s=props)
    print(f"[40 timing] median of 3 CUDA-event reps on {card} (after: sm clock, draw, limit, "
          f"temp = {clocks}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in med.items())
          + f"; the kernel at {100 * bound_ms / med['kernel']:.2f} % of work_pe's bound "
            f"{bound_ms:.4f} ms; propagations/s "
          + ", ".join(f"{k} {v:.4e}" for k, v in props.items()), flush=True)
    require(not failed, "; ".join(failed))
    return record


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
    from ccv_mppi_path_tracker_tpu_torch.kernels.step_prologue import step_prologue_cuda
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
    from ccv_mppi_path_tracker_tpu_torch.solver.mppi import (
        REFINE_GRAPHS,
        _refine,
        _sigma_suggest,
        refine_stage,
    )

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
        fused_sample_rollout_cost.launches = step_prologue_cuda.launches = 0
        t0 = time.perf_counter()
        logs, m = lean_loop(cfg, sp, cp, course, opts)
        wall = time.perf_counter() - t0
        n = fused_sample_rollout_cost.launches
        name = cfg.model + ("_elite_stale" if opts.get("elite_stale")
                            else "_elite" if opts else "")
        launches[name] = n
        launches[f"{name}/prologue"] = step_prologue_cuda.launches
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
        require(launches[f"{name}/prologue"] == STEPS,
                f"{name}: the step prologue launched {launches[f'{name}/prologue']} times, "
                f"not {STEPS}")
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
    fleet_lines = None   # the kernel arm's (argv, printed lines), for phase 34
    for extra in (["--kernel"], ["--no-kernel"]):
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
        require(rc == 0 and worst < 0.15 and n == (0 if "--no-kernel" in extra else STEPS),
                f"cli {' '.join(argv)}")
        if "--kernel" in extra:
            fleet_lines = (argv, lines)
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
                     "--num-samples", str(K_MAIN), "--horizon", str(T_MAIN), "--kernel"], 31)
    require(float(lines[3].split(": ")[1]) < 0.15 and lines[4].startswith("rate: 30 cycles"),
            "cli realtime full_body")
    lines = cli_run(["realtime", "--pipelined", "--micro-batch", "4", "--hz", "50", "--steps",
                     "48", "--kernel"], 52)
    require(lines[1].startswith("pipelined: micro_batch=4") and
            lines[-1].startswith("rate: 48 cycles"), "cli realtime --pipelined")
    lines = cli_run(["compare", "--steps", str(STEPS), "--kernel"], STEPS)
    rmse_mppi, rmse_pp = (float(line.split("RMSE=")[1].split()[0]) for line in lines)
    require(rmse_mppi < rmse_pp, f"cli compare: MPPI {rmse_mppi} vs pure pursuit {rmse_pp}")
    lines = cli_run(["course", "--kind", "dkan", "--out", str(tmp / "dkan.csv")], 0)
    require(lines[0].startswith("dkan course: "), "cli course")
    ck = tmp / "cli.npz"
    lines = cli_run(["run", "--record", str(tmp / "log"), "--course", "dkan", "--save-ckpt",
                     str(ck), "--steps", str(STEPS), "--kernel"], STEPS)
    require(lines[-1].startswith("recorded: ") and float(lines[-2].split(": ")[1]) < 0.15,
            "cli run --record --course dkan --save-ckpt")
    lines = cli_run(["run", "--resume-ckpt", str(ck), "--steps", str(STEPS), "--kernel"], STEPS)
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
            # the card's _refine is a CUDA graph's replay: against the eager stage
            require(REFINE_GRAPHS.cache_key(cfg, *stage_inputs(torch.float64, dev), 3, 0.02, m)
                    in REFINE_GRAPHS.graphs,
                    f"{model} {m}: the refine stage was not captured as a CUDA graph")
            eager = refine_stage(cfg, *stage_inputs(torch.float64, dev), 3, 0.02, m).cpu()
            graph_d = float((a - eager).abs().max())
            require(bool(((a - eager).abs() <= 1e-8 * eager.abs() + 1e-12).all()),
                    f"{model} {m}: the graphed refine stage differs from the eager one "
                    f"beyond rtol 1e-8 at float64 (max |d| {graph_d})")
            errs[m] += (graph_d,)
        # (b) the trajectory cost of the update, unrefined and refined, on the card
        args32 = stage_inputs(torch.float32, dev)
        cost_fn = make_trajectory_cost(cfg)
        costs = {"unrefined": float(cost_fn(args32[0], *args32[1:4], args32[5], args32[6]))}
        for m in methods:
            u = _refine(cfg, *args32, 3, 0.02, m)
            costs[m] = float(cost_fn(u, *args32[1:4], args32[5], args32[6]))
        print(f"[22 refine stage] {model} K={K_MAIN} T={T_MAIN}, the kernel's update: "
              + "; ".join(f"{m} card vs CPU max |d| {e64:.3e} at float64 (rtol 1e-8), "
                          f"{e32:.3e} at float32 (printed only), graphed vs eager on the "
                          f"card {eg:.3e} at float64 (rtol 1e-8), moved the update by "
                          f"{moved:.3e}" for m, (e64, e32, moved, eg) in errs.items())
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
        if preset == "full_body":
            # the refine stage alone on the kernel's update: eager, and the
            # CUDA graph's replay that mppi_step runs
            _, res = mppi_step(s["cfg"], ControllerState(s["u_prev"], 0, 0), s["state"],
                               s["path"], s["dt"], s["sp"], s["cp"], model_params=s["mp"],
                               use_kernel=True)
            st = (s["cfg"], res.u_opt, s["state"], res.ref, s["dt"], s["sp"], s["cp"], s["mp"])
            for meth in methods:
                arms[f"{model}/refine_stage_{meth}_eager"] = (
                    lambda st=st, meth=meth: refine_stage(*st, 3, 0.02, meth), 3)
                arms[f"{model}/refine_stage_{meth}_graphed"] = (
                    lambda st=st, meth=meth: _refine(*st, 3, 0.02, meth), 3)
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

    # --- 24. the sample offset ----------------------------------------------
    print(f"[24 sample offset] K={K_MAIN} T={T_MAIN}, RNG mode", flush=True)
    half = K_MAIN // 2
    offset_arms = {}
    for preset in ("full_body",) + NEW_PRESETS:
        s = kernel_case(preset, K_MAIN, T_MAIN, seed=24)
        model = s["model"]
        kw = dict(seed=31, step=4, model=model)
        err = compare(f"{model} first_sample={OFFSET}",
                      kernel_fn(*s["kargs"], num_samples=K_MAIN, first_sample=OFFSET, **kw),
                      plain_fn(*s["kargs"], num_samples=K_MAIN, first_sample=OFFSET, **kw))
        max_abs_err[f"{model}_offset"] = err
        whole = kernel_fn(*s["kargs"], num_samples=K_MAIN, **kw)[0]
        halves = torch.cat([kernel_fn(*s["kargs"], num_samples=half, first_sample=f, **kw)[0]
                            for f in (0, half)])
        same = bool(torch.equal(halves, whole))
        print(f"  {model}: two launches of K/2 at first_sample 0 and {half} bit-equal to "
              f"one launch of K: {same}", flush=True)
        require(same, f"{model}: the sharded launches' costs differ from one launch")
        mkw = dict(kw, num_samples=K_MAIN)
        offset_arms[f"{model}/first_sample_0"] = (KernelLaunch(*s["kargs"], **mkw).run, 50)
        offset_arms[f"{model}/first_sample_{OFFSET}"] = (
            KernelLaunch(*s["kargs"], first_sample=OFFSET, **mkw).run, 50)
        offset_arms[f"{model}/shard_of_2"] = (
            KernelLaunch(*s["kargs"], first_sample=half, **dict(kw, num_samples=half)).run, 50)
        if model == "full_body":
            offset_arms["full_body/plain_first_sample"] = (
                lambda s=s, mkw=mkw: plain_fn(*s["kargs"], first_sample=OFFSET, **mkw), 3)
    counters_zero("sample offset")
    times = time_interleaved(offset_arms, 7)
    med.update({name: statistics.median(v) for name, v in times.items()})
    print(f"  CUDA-event times, median of 7 reps, on {card}:", flush=True)
    for name, v in times.items():
        print(f"  {name}: {statistics.median(v):.4f} ms [{min(v):.4f}, {max(v):.4f}]",
              flush=True)
    counters_zero("sample offset timing")

    # --- 25. the sharded step ------------------------------------------------
    import torch.distributed as dist

    from ccv_mppi_path_tracker_tpu_torch.parallel import (
        build_sharded_step,
        initialize_multihost,
        samples_group,
        shutdown_multihost,
    )

    sharded = {}
    s = kernel_case("full_body", K_MAIN, T_MAIN, seed=25)
    ctrl = ControllerState(u_prev=s["u_prev"], seed=7, step=9)
    step_args = (ctrl, s["state"], s["path"], s["dt"], s["sp"], s["cp"])
    require(initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="nccl",
                                 timeout_s=120), "the NCCL group of one process")
    group, _ = samples_group(device=dev)
    option_sets = {"vanilla": {}, "elite": {"elite_frac": ELITE},
                   "adapt_sigma": {"adapt_sigma": True}}
    ws1 = {}
    for use_kernel in (True, False):
        for tag, opts in option_sets.items():
            step = build_sharded_step(s["cfg"], group, use_kernel=use_kernel,
                                      solver_options=opts)
            ws1[use_kernel, tag] = step
            _, a = step(*step_args, model_params=s["mp"])
            _, b = mppi_step(s["cfg"], *step_args, model_params=s["mp"],
                             use_kernel=use_kernel, **opts)
            same = bool(torch.equal(a.u_opt, b.u_opt)) and a.stats.keys() == b.stats.keys() \
                and all(bool(torch.equal(a.stats[k], b.stats[k])) for k in a.stats)
            print(f"[25 world size 1] NCCL on {dev}, full_body K={K_MAIN} T={T_MAIN} "
                  f"{'kernel' if use_kernel else 'eager'} {tag}: bit-equal to mppi_step "
                  f"{same}", flush=True)
            require(same, f"world size 1 {tag}: the sharded step differs from mppi_step")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for (use_kernel, tag), step in ws1.items():
            step(*step_args, model_params=s["mp"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  no host sync inside the sharded step at world size 1 (kernel and eager, "
          "vanilla, elite and adapt_sigma)", flush=True)
    carry = {"sharded": [ctrl], "unsharded": [ctrl]}

    def chained(name, step):
        def fn():
            carry[name][0], _ = step(carry[name][0], *step_args[1:], model_params=s["mp"])
        return fn

    unsharded = functools.partial(mppi_step, s["cfg"], use_kernel=True)
    times = time_interleaved({"sharded": (chained("sharded", ws1[True, "vanilla"]), 20),
                              "unsharded": (chained("unsharded", unsharded), 20)}, 7)
    sharded["world_size_1"] = {k: statistics.median(v) for k, v in times.items()}
    print(f"  kernel update, CUDA events, median of 7 reps: sharded at world size 1 "
          f"{sharded['world_size_1']['sharded']:.4f} ms, mppi_step "
          f"{sharded['world_size_1']['unsharded']:.4f} ms on {card}", flush=True)
    shutdown_multihost()   # forgets the graphs that hold the group, then leaves it
    counters_zero("world size 1")

    # world size 2: two processes over gloo sharing the card
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    t0 = time.perf_counter()
    ranks = launch_workers("card", 2, str(dev), tmp)
    wall = time.perf_counter() - t0
    one = kernel_fn(*s["kargs"], seed=7, step=9, num_samples=K_MAIN, model="full_body")[0]
    costs_same = bool(np.array_equal(np.concatenate([r["costs"] for r in ranks]),
                                     one.cpu().numpy()))
    _, ref = mppi_step(s["cfg"], *step_args, model_params=s["mp"], use_kernel=True)
    _, eref = mppi_step(s["cfg"], *step_args, model_params=s["mp"], use_kernel=True,
                        elite_frac=ELITE)
    u_ref = ref.u_opt.cpu()
    err = float(np.abs(ranks[0]["vanilla/u_opt"] - u_ref.numpy()).max())
    bound = u_bound(u_ref)
    replicated = all(np.array_equal(ranks[0][k], ranks[1][k])
                     for k in ("vanilla/u_opt", "elite/u_opt", "loop/xy"))
    min_same = float(ranks[0]["vanilla/min_cost"]) == float(ref.stats["min_cost"])
    thresh_same = float(ranks[0]["elite/elite_thresh"]) == float(eref.stats["elite_thresh"])
    e_err = float(np.abs(ranks[0]["elite/u_opt"] - eref.u_opt.cpu().numpy()).max())
    loop = tracking_metrics(ranks[0]["loop/xy"], ranks[0]["loop/course"], dt=0.1)
    loop_launches = [int(r["loop/launches"]) for r in ranks]
    launches["full_body_sharded"] = loop_launches[1]  # rank 1: first_sample = K/2
    max_abs_err["full_body_sharded"] = err
    sharded["world_size_2"] = {
        "update_ms": float(np.median(ranks[0]["update_ms"])),
        "update_ms_spread": [float(ranks[0]["update_ms"].min()),
                             float(ranks[0]["update_ms"].max())],
        "loop_wall_s": float(ranks[0]["loop/wall_s"]), "loop_rmse": loop["rmse"],
        "workers_wall_s": wall}
    print(f"[25 world size 2] gloo, two processes on {dev}, full_body K={K_MAIN} "
          f"T={T_MAIN} kernel RNG mode: per-sample costs of the two shards bit-equal to "
          f"one launch {costs_same}; u_opt max abs err {err:.3e} vs the one-card kernel "
          f"update (bound {bound:.3e}); min_cost equal {min_same}; elite {ELITE}: "
          f"threshold bit-equal {thresh_same}, u_opt err {e_err:.3e}; outputs replicated "
          f"{replicated}", flush=True)
    print(f"[25 sharded loop] world size 2, {STEPS} cycles: RMSE {loop['rmse']:.4f} m, "
          f"max error {loop['max_error']:.4f} m, kernel launches per rank {loop_launches}; "
          f"wall {float(ranks[0]['loop/wall_s']):.3f} s (host clock); sharded update "
          f"{sharded['world_size_2']['update_ms']:.4f} ms (CUDA events, median of 5, "
          f"spread {sharded['world_size_2']['update_ms_spread']}) beside the one-card "
          f"{sharded['world_size_1']['unsharded']:.4f} ms on {card}", flush=True)
    require(costs_same and err <= bound and min_same and thresh_same
            and e_err <= u_bound(eref.u_opt.cpu()) and replicated,
            "world size 2: the sharded update differs from the one-card update")
    require(loop["rmse"] < 0.15 and loop_launches == [STEPS, STEPS],
            f"world size 2 loop: RMSE {loop['rmse']}, launches {loop_launches}")

    # --- 26. use_kernel="auto" ---------------------------------------------
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import should_use_kernel

    auto = {}
    for preset in ("full_body",) + NEW_PRESETS:
        rows = []
        for t in AUTO_T:
            for k in AUTO_K:
                c = kernel_case(preset, k, t, roll_off=True, seed=26)
                times = time_interleaved({"kernel": (updater(c, "kernel"), 5),
                                          "eager": (updater(c, "eager"), 5)}, 5)
                rows.append((k * (t - 1), k, t, statistics.median(times["kernel"]),
                             statistics.median(times["eager"])))
        rows.sort()
        model = PRESET_MODELS[preset][0]
        measured = crossover(rows)
        pick = should_use_kernel(model, dev)
        # a point where auto's arm is slower than the other beyond a tie
        misses = [r for r in rows if (r[3] if pick else r[4]) > (1 + TIE) * min(r[3], r[4])]
        auto[model] = {"crossover": measured, "auto": "kernel" if pick else "eager",
                       "misses": len(misses), "rows": rows}
        print(f"[26 auto] {model}: kernel-lean vs eager-lean update, CUDA events, median "
              f"of 5 on {card}:", flush=True)
        for props, k, t, kern, eager in rows:
            print(f"  K={k} T={t} K*(T-1)={props}: kernel {kern:.4f} ms, eager "
                  f"{eager:.4f} ms -> {'kernel' if kern < eager else 'eager'}", flush=True)
        where = measured if measured is not None else \
            "none, the kernel was the faster at every point"
        print(f"  crossover: {where}; auto picks the {auto[model]['auto']} at every point; slower than the "
              f"other beyond {int(TIE * 100)} % at {len(misses)} points", flush=True)
        require(not misses, f"{model}: auto's arm is the slower at {misses}")
    fused_sample_rollout_cost.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run", "--preset", "full_body", "--steps", "5", "--num-samples",
                       str(K_MAIN), "--horizon", str(T_MAIN)])
    first = buf.getvalue().splitlines()[0]
    n = fused_sample_rollout_cost.launches
    print(f"[26 auto cli] run with no flag at the flagship: {first}; kernel launches {n}",
          flush=True)
    require(rc == 0 and first.startswith("solver path: fused kernel (auto)") and n == 5,
            "run with no flag at the flagship")
    sys.path.insert(0, str(ROOT / "examples"))
    import custom_model_torch as bicycle

    fused_sample_rollout_cost.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        m = bicycle.main(["--device", str(dev)])
    wall = time.perf_counter() - t0
    n = fused_sample_rollout_cost.launches
    lines = buf.getvalue().splitlines()
    print(f"[26 bicycle] examples/custom_model_torch.py on {dev}: {' | '.join(lines)}; "
          f"kernel launches {n}; {wall:.2f} s", flush=True)
    require(m["rmse"] < 0.15 and n == 0 and "eager (auto)" in lines[1]
            and not dist.is_initialized(), "the bicycle example on the card")
    counters_zero("auto")

    # --- 27. export on the card ---------------------------------------------
    from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
    from ccv_mppi_path_tracker_tpu_torch.runtime.export import load_control_step

    # the export command (export_control_step) at the flagship, then the file
    cfg = s["cfg"]
    out = tmp / "step.pt2"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export", "--preset", "full_body", "--num-samples", str(K_MAIN),
                       "--horizon", str(T_MAIN), "--out", str(out)])
    export_s = time.perf_counter() - t0
    print(f"[27 export cli] rc {rc}: {buf.getvalue().strip()} in {export_s:.2f} s",
          flush=True)
    require(rc == 0, "the export command")
    blob = out.read_bytes()
    call = load_control_step(blob)
    c2, xres = call(*step_args)
    _, kres = mppi_step(cfg, *step_args, model_params=s["mp"], use_kernel=True)

    def eager_philox():
        noise = philox_normals(ctrl.seed, ctrl.step, K_MAIN, T_MAIN - 1, 5, device=dev)
        return mppi_step(cfg, *step_args, model_params=s["mp"], noise=noise)

    eres = eager_philox()[1]
    k_err, k_bound = u_err("export vs kernel", xres.u_opt, kres.u_opt)
    e_rel = float(((xres.u_opt - eres.u_opt).abs() / (eres.u_opt.abs() + 1e-30)).max())
    e_ok = bool(torch.allclose(xres.u_opt, eres.u_opt, rtol=1e-5, atol=1e-6))
    ok = (bool(torch.isfinite(xres.u_opt).all()) and xres.u_opt.device == dev
          and c2.step == ctrl.step + 1)
    times = time_interleaved({
        "exported": (lambda: call(*step_args), 10),
        "eager_philox": (eager_philox, 10),
        "eager": (lambda: mppi_step(cfg, *step_args, model_params=s["mp"]), 10)}, 5)
    exported = {"export_s": export_s, "bytes": len(blob),
                **{k: statistics.median(v) for k, v in times.items()}}
    print(f"[27 export] full_body K={K_MAIN} T={T_MAIN}, loaded and run on "
          f"{xres.u_opt.device} (finite, next step {c2.step}: {ok}): vs the kernel path "
          f"(RNG mode, same seed and step) max abs err {k_err:.3e} (bound {k_bound:.3e}); "
          f"vs eager mppi_step on philox_normals max rel err {e_rel:.3e} (rtol 1e-5 atol "
          f"1e-6: {e_ok}); a step {exported['exported']:.4f} ms exported, "
          f"{exported['eager_philox']:.4f} ms eager on the same Philox draw passed in, "
          f"{exported['eager']:.4f} ms eager drawing it itself (the draw kernel; CUDA "
          f"events, median of 5, on {card})", flush=True)
    require(ok and e_ok, "the exported step on the card")

    # --- 28. profile -------------------------------------------------------
    trace_dir = tmp / "trace"
    fused_sample_rollout_cost.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["profile", "--preset", "full_body", "--steps", str(PROFILE_STEPS),
                       "--num-samples", str(K_MAIN), "--horizon", str(T_MAIN), "--out",
                       str(trace_dir)])
    n = fused_sample_rollout_cost.launches
    lines = buf.getvalue().splitlines()
    summary = json.loads(lines[-2])
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    kern = [e for e in events if "rollout_cost_kernel" in str(e.get("name", ""))
            and e.get("cat") == "kernel"]
    print(f"[28 profile] {lines[0]}; {lines[-1]}; phases {summary}; rollout_cost device "
          f"events in the trace {len(kern)} ({PROFILE_STEPS} steps), kernel launches "
          f"{n} (the steps and the warm step)", flush=True)
    require(rc == 0 and len(kern) == PROFILE_STEPS and n == PROFILE_STEPS + 1
            and summary["control_cycle"]["count"] == PROFILE_STEPS, "the profile command")
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=K_MAIN, horizon=T_MAIN,
                                                device=dev)
    path = PathBuffer.from_points(course, 0.1, device=dev)
    start = torch.tensor([course[0, 0], course[0, 1], 0.0], device=dev)
    for use_kernel, opts in ((False, {"debug_candidates": 24}), (True, {})):
        _, logs = simulate(cfg, ControllerState.initial(0, T_MAIN, 2, device=dev), start,
                           path, torch.full((), 0.1, device=dev), sp, cp, num_steps=20,
                           use_kernel=use_kernel, solver_options=opts, with_paths=True)
        keys = [k for k in ("opt_xy", "ref_xy", "candidates") if k in logs]
        ok = all(logs[k].device == dev and bool(torch.isfinite(logs[k]).all()) for k in keys)
        print(f"[28 with_paths] diff_drive {'kernel' if use_kernel else 'eager'} 20 cycles: "
              f"{', '.join(f'{k} {tuple(logs[k].shape)}' for k in keys)} on {dev}, finite "
              f"{ok} (no figure drawn: the card's machine has no matplotlib)", flush=True)
        require(ok and ("candidates" in keys) != use_kernel, "with_paths logs")
    shutil.rmtree(tmp)
    counters_zero("export and profile")
    print(json.dumps({"sharded": sharded, "auto": {m: {k: v for k, v in a.items()
                                                       if k != "rows"}
                                                   for m, a in auto.items()},
                      "export": exported}))

    # --- 29. the benchmark's cells, short ----------------------------------
    torch.cuda.empty_cache()
    phase_29()

    # --- 30. the compiled paths: CUDA graphs and the device key ----------------
    med30 = {}
    compiled = phase_30(dev, card, launches, max_abs_err, med30, counters_zero)
    print(json.dumps({"compiled": compiled}), flush=True)

    # --- 31. the eager arm's compiled programs: the keyed draw ------------------
    med31 = {}
    eager = phase_31(dev, card, log, launches, max_abs_err, med31, counters_zero)
    print(json.dumps({"eager_compiled": eager}), flush=True)

    # --- 32. the reference's evaluations: matrix, robustness, session -----------
    evaluations, launches32 = phase_32(dev, card, counters_zero)
    print(json.dumps({"evaluations": evaluations}), flush=True)

    # --- 33. the differentiable side's compiled programs ------------------------
    programs, launches33 = phase_33(dev, card, counters_zero)
    print(json.dumps({"training_programs": programs}), flush=True)

    # --- 34. the sharded programs over NCCL, the fleet plant, the figures ----------
    sharded_programs, launches34 = phase_34(dev, card, fleet_lines, counters_zero)
    print(json.dumps({"sharded_programs": sharded_programs}), flush=True)

    # --- 35. fleets past 65535 robots, the measuring twins' quick forms -----------
    big_fleets, launches35 = phase_35(dev, card, counters_zero)
    print(json.dumps({"big_fleets": big_fleets}), flush=True)

    # --- 36. the refine stage's kernel ------------------------------------------
    print(json.dumps({"gauss_newton_kernel": phase_36(dev, card, counters_zero)}),
          flush=True)

    # --- 37. the control step's prologue -------------------------------------------
    prologue = phase_37(dev, card, counters_zero)
    print(json.dumps({"step_prologue": prologue}), flush=True)

    # --- 38. the eager update's network rollout ------------------------------------
    network = phase_38(dev, card, counters_zero)
    print(json.dumps({"network_rollout": network}), flush=True)

    # --- 39. PETS's probabilistic ensemble through the eager arm --------------------
    print(json.dumps({"pets_ensemble": phase_39(dev, card)}), flush=True)

    # --- 40. the eager update's PETS ensemble rollout ------------------------------
    pets = phase_40(dev, card)
    print(json.dumps({"pets_rollout": pets}), flush=True)

    def entry(name, path_key, err_key, ms, plain_ms, bound, replaces=REPLACES):
        """One kernels entry; launches and launches_per_update are those of
        path_key's STEPS-cycle (or -tick) main-path run."""
        n = launches[path_key]
        require(n > 0 and n % STEPS == 0,
                f"{name}: {n} launches in its main path's {STEPS}-cycle run")
        bound_ms, which = bound
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
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
    # the sample offset (phase 24); launches: rank 1's (first_sample = K/2)
    # 200-cycle sharded loop of phase 25
    kernels.append(entry("rollout_cost_full_body_first_sample", "full_body_sharded",
                         "full_body_offset", med[f"full_body/first_sample_{OFFSET}"],
                         med["full_body/plain_first_sample"], bound("full_body")))
    # the key read from device memory (phase 30); launches: the graphed
    # 200-cycle full_body loop's replays
    kernels.append(entry("rollout_cost_full_body_device_key", "full_body_graphed",
                         "full_body_key", med30["kernel/device_key"],
                         med30["kernel/plain_key"], bound("full_body")))
    # the eager arm's draw (phase 31) at the flagship (T-1, K, U) = (29, 102400,
    # 5); launches: the graphed eager 200-cycle full_body loop's replays. It
    # ports no Pallas kernel (the JAX package's eager draw is XLA's RBG
    # normal); torch.randn of the same shape is a different stream, so its
    # time is a yardstick beside library_ms, not library_ms
    draw = entry("philox_normals", "philox_eager_loop", "philox_normals",
                 med31["draw/kernel"], med31["draw/plain"], philox_bound(),
                 replaces=REPLACES_DRAW)
    draw["randn_ms_yardstick"] = med31["draw/randn"]
    # meta_train's step draw, (B, T-1, K, U) = (64, 7, 64, 2)
    draw["meta_train_ms"] = med31["draw_graph50/meta_train"]
    draw["meta_train_bound_ms"] = philox_bound(*META_DRAW)[0]
    kernels.append(draw)
    # the control step's prologue (phase 37), in the same library; launches: the
    # lean full_body 200-cycle loop's (phase 6), one an update
    max_abs_err["step_prologue"] = prologue["max_abs_err"]
    kernels.append(entry("step_prologue", "full_body/prologue", "step_prologue",
                         prologue["alone_ms"]["kernel"], prologue["alone_ms"]["plain"],
                         (prologue["bound"]["ms"], "bytes"), replaces=REPLACES_PROLOGUE))
    kernels[-1]["bound_bytes"] = prologue["bound"]["bytes"]
    # the eager update's network rollout (phase 38); launches: 20 replays of the
    # compiled autorally_nn update, one an update
    kernels.append({"name": "network_rollout", "route": "cuda",
                    "source": "ccv_mppi_path_tracker_tpu_torch/csrc/network_rollout.cu",
                    "replaces": None, "launches": network["launches_20_replays"],
                    "launches_per_update": network["launches_20_replays"] // 20,
                    "max_rel_cost_err": max(network["cost_max_rel"].values()),
                    "ms": network["times_ms"]["kernel"],
                    "plain_ms": network["times_ms"]["plain_graphed"],
                    "bound_ms": network["bound_ms"], "bound_by": "operations",
                    "library_ms": None})
    # the eager update's PETS ensemble rollout (phase 40); launches: 20 replays
    # of the compiled pets_pe update, one an update
    kernels.append({"name": "pets_rollout", "route": "cuda",
                    "source": "ccv_mppi_path_tracker_tpu_torch/csrc/pets_rollout.cu",
                    "replaces": None, "launches": pets["launches_20_replays"],
                    "launches_per_update": pets["launches_20_replays"] // 20,
                    "max_rel_cost_err": max(pets["cost_max_rel"].values()),
                    "ms": pets["times_ms"]["kernel"],
                    "plain_ms": pets["times_ms"]["plain_graphed"],
                    "bound_ms": pets["bound_ms"], "bound_by": "operations",
                    "library_ms": None})
    # phase 32's, 33's, 34's and 35's runs, each counted from 0 just before it
    # (phase 34: the graphed sharded 200-cycle loop over NCCL; phase 35: one
    # replayed tick of a fleet of B_SPLIT robots, three launches)
    for k in kernels:
        for phase, counts in ((32, launches32), (33, launches33), (34, launches34),
                              (35, launches35)):
            if k["name"] in counts:
                k[f"launches_phase_{phase}"] = counts[k["name"]]
    split = next(k for k in kernels if k["name"] == "rollout_cost_unicycle_fleet")
    split.update(split_tick_robots=B_SPLIT,
                 split_tick_ms=big_fleets["tick"]["ms"][f"tick/B{B_SPLIT}"],
                 one_launch_tick_robots=B_SPLIT_ONE,
                 one_launch_tick_ms=big_fleets["tick"]["ms"][f"tick/B{B_SPLIT_ONE}"])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
