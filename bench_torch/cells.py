"""The seven cells: the twin of ``scripts/bench_suite.py:96-104``,
``:133-137`` and of PERF.md §4.

Every cell takes one card, float32, RNG mode (the kernel's Philox stream),
the preset's course, and ``--seed`` as the workload seed: the seed moves the
course by a uniform offset in [-1, 1] m, perturbs the start pose (each robot's
for the fleet) and keys the controller's Philox stream where the entry point
takes a seed. The same seed gives bit-equal inputs; another seed gives
others. Each cell has a correctness gate, run once a process before the
timing, and one end-to-end metric:

- ``propagations_per_s`` = K*(T-1) / update time (``bench.py:164-165``),
  CUDA events around chains of calls of the arm's ``compile_step`` (on the
  card a CUDA graph's replay, as ``bench.py:121-127`` times ``jax.jit``),
  each taking the previous ControllerState; the update time is all the
  chains' time over all their updates;
- ``cycles_per_s``: closed-loop cycles over the runs' time, on the host
  clock, each run ending in a device-to-host copy (the loop), or the
  unpaced serving loop's own clock;
- ``robot_updates_per_s`` = B / tick time, the ticks' time as the updates'.

The median and a tail percentile of the single updates (ticks, runs) stand
beside the metric as per-layer statistics: a stall every few updates moves
the metric and may leave the median where it was.

The package is called through its public entry points only: the presets,
``PathBuffer.from_points``, ``ControllerState.initial``, ``compile_step``,
``init_fleet`` / ``build_fleet_step``, ``run_tracking_experiment``,
``run_realtime_experiment``, and for the gate the kernel's plain version
``fused_sample_rollout_cost_reference`` with the arguments the kernel takes
(``resample_reference``, ``pack_scalars``, ``elite_threshold``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from bench_torch import timing, trace, work

# the reference CPU node's implied ceiling: K*(T-1)*rate = 10000*14*10
# (bench.py:166, BASELINE.md)
BASELINE_PROPAGATIONS = 10_000 * 14 * 10
U_RTOL, U_ATOL = 5e-4, 5e-5     # scripts/tpu_smoke.py's u_opt bound, relative to max|u|
THRESH_RTOL = 2e-5              # tests/test_kernel.py's costs tolerance
RMSE_MAX = 0.15                 # closed-loop RMSE gate, m
FLEET_MAX = 0.3                 # tests/test_fleet.py:51-54, m from the course
SERVING_HZ = 1e6                # a period no cycle meets: the serving loop unpaced

PRESET_MODEL = {"full_body": "full_body", "diff_drive": "unicycle"}


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str                     # "update", "loop", "fleet" or "serving"
    preset: str
    num_samples: int
    horizon: int
    robots: int = 1
    elite_frac: Optional[float] = None
    arms: tuple = ("kernel_lean",)
    chain: int = 50               # updates (ticks) a timed chain
    cycles: int = 200             # a loop's cycles, the fleet gate's ticks
    why: str = ""

    @property
    def model(self):
        return PRESET_MODEL[self.preset]

    @property
    def metric(self):
        return {"update": "propagations_per_s", "fleet": "robot_updates_per_s"}.get(
            self.kind, "cycles_per_s")

    @property
    def unit(self):
        return {"propagations_per_s": "propagations/s", "cycles_per_s": "cycles/s",
                "robot_updates_per_s": "robot-updates/s"}[self.metric]


CELLS = {c.name: c for c in (
    Cell("full_body-K102400-T30", "update", "full_body", 102_400, 30,
         arms=("kernel_lean", "kernel_full", "eager_lean"),
         why="bench.py's headline (bench.py:116-127): one full-body update at "
             "bench.py:51-52's K and T, its three arms in one window"),
    Cell("unicycle-K102400-T30", "update", "diff_drive", 102_400, 30,
         arms=("kernel_lean", "kernel_full", "eager_lean"),
         why="the lightest model, so the host's share is largest "
             "(scripts/bench_suite.py:97)"),
    Cell("full_body-K10000-T15", "update", "full_body", 10_000, 15,
         why="the reference node's operating point (src/full_body_mppi.cpp:10), "
             "a launch whose last block is masked"),
    Cell("full_body-K102400-T30-elite0.1", "update", "full_body", 102_400, 30,
         elite_frac=0.1,
         why="two-pass elite: two kernel passes and elite_threshold's sort"),
    Cell("full_body-loop200-K102400-T30", "loop", "full_body", 102_400, 30,
         why="the closed loop users run: solver and plant, run_tracking_experiment"),
    Cell("fleet-unicycle-B256-K1024-T15", "fleet", "diff_drive", 1024, 15, robots=256,
         arms=("kernel", "eager"),
         why="the fleet grid, one launch a tick (scripts/bench_suite.py:133-137)"),
    Cell("full_body-serving-K102400-T30", "serving", "full_body", 102_400, 30,
         why="the live-robot path unpaced: gate, command geometry, host plant, "
             "one device-to-host read a cycle (chip_smoke.py phase 19)"),
)}


class GateError(RuntimeError):
    """A cell's gate failed; ``gate`` holds the numbers it compared."""

    def __init__(self, gate):
        super().__init__(f"gate failed: {gate}")
        self.gate = gate


# --- inputs -------------------------------------------------------------------

def inputs(cell: Cell, seed: int, device):
    """The cell's inputs from ``seed`` and its preset, on ``device``."""
    from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu_torch.models import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer

    rng = np.random.RandomState(seed)
    cfg, sp, cp, course = PRESETS[cell.preset](num_samples=cell.num_samples,
                                               horizon=cell.horizon, device=device)
    course = (course + rng.uniform(-1.0, 1.0, 2)).astype(course.dtype)
    m = get_model(cfg.model)
    heading = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    if cell.robots == 1:
        start = np.zeros(m.num_states)
        start[:3] = course[0, 0], course[0, 1], heading
        start[:3] += rng.normal(0.0, (0.05, 0.05, 0.05))
    else:
        start = np.zeros((cell.robots, m.num_states))
        start[:, 0] = course[0, 0] + rng.uniform(0.0, 0.2, cell.robots)
        start[:, 1] = course[0, 1] + rng.uniform(-0.4, 0.4, cell.robots)
        start[:, 2] = heading
    return {"cfg": cfg, "sp": sp, "cp": cp, "course": course, "model": m,
            "path": PathBuffer.from_points(course, 0.1, device=device),
            "start": start,
            "state": torch.tensor(start, dtype=torch.float32, device=device),
            "dt": torch.full((), 0.1, device=device), "seed": seed}


# --- gates --------------------------------------------------------------------

def gate_u(u_kernel, u_plain):
    """The kernel's u_opt against the plain version's: max|d| <= 5e-4 max|u|
    + 5e-5."""
    err = float((u_kernel - u_plain).abs().max())
    bound = U_RTOL * float(u_plain.abs().max()) + U_ATOL
    finite = bool(torch.isfinite(u_kernel).all())
    return {"name": "u_opt vs plain version", "max_abs_err": err, "bound": bound,
            "ok": finite and err <= bound}


def gate_thresh(t_kernel, t_plain):
    rel = abs(float(t_kernel) - float(t_plain)) / abs(float(t_plain))
    return {"name": "elite threshold vs plain version", "rel_err": rel,
            "rtol": THRESH_RTOL, "ok": rel <= THRESH_RTOL}


def gate_rmse(rmse):
    return {"name": "closed-loop RMSE", "rmse_m": float(rmse), "max_m": RMSE_MAX,
            "ok": bool(np.isfinite(rmse)) and rmse < RMSE_MAX}


def gate_fleet(distances):
    d = np.asarray(distances)
    return {"name": "every robot near the course", "max_distance_m": float(d.max()),
            "max_m": FLEET_MAX, "ok": bool(np.isfinite(d).all() and (d < FLEET_MAX).all())}


def gate_reads(syncs, cycles, sites=None):
    """One device-to-host read a cycle: the host syncs counted over runs of
    two lengths differ by as many as the cycles do (the set-up's reads
    cancel); None (CPU) is not counted. ``sites``: where each run's syncs
    were called, [{file:line: count}, ...]."""
    (s1, s2), (c1, c2) = syncs, cycles
    per = None if s1 is None else (s1 - s2) / (c1 - c2)
    return {"name": "host syncs a cycle", "host_syncs": list(syncs), "cycles": list(cycles),
            "per_cycle": per, "sites": sites, "ok": per is None or s1 - s2 == c1 - c2}


def check(*gates):
    """The gates; GateError if any failed."""
    gates = list(gates)
    if not all(g["ok"] for g in gates):
        raise GateError(gates)
    return gates


def plain_update(x, elite_frac=None):
    """The first update's (u_opt, elite threshold or None) by the kernel's
    plain version on the kernel's own Philox draw (seed, step 0)."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
        fused_sample_rollout_cost_reference as plain,
        pack_scalars,
    )
    from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import elite_threshold
    from ccv_mppi_path_tracker_tpu_torch.paths import resample_reference

    cfg, sp, cp, state, dt = x["cfg"], x["sp"], x["cp"], x["state"], x["dt"]
    m = x["model"]
    mp = m.default_params(device=state.device) if m.default_params else None
    u0 = torch.zeros((cfg.horizon - 1, m.num_controls), device=state.device)
    ref = resample_reference(x["path"], state[:2], cp.v_ref, dt, cfg.horizon)
    args = (u0, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state)
    kw = dict(seed=x["seed"], step=0, num_samples=cfg.num_samples, model=cfg.model,
              steer_off=cfg.steer_off)

    def scal(thresh=None):
        return pack_scalars(dt, cp, ref.yaw[0], mp, sp.noise_beta, sp.lam,
                            cost_thresh=thresh)

    if elite_frac is None:
        _, u_num, norm = plain(*args, scal(), **kw)
        return u_num / norm, None
    costs = plain(*args, scal(), accumulate=False, **kw)[0]
    thresh = elite_threshold(costs, elite_frac)
    _, u_num, norm = plain(*args, scal(thresh), costs_in=costs, **kw)
    return u_num / norm, thresh


# --- the cells ------------------------------------------------------------------

def _update_step(cell, x, name):
    """The compiled step of update arm ``name`` (``compile_step`` with the
    arm's options and the cell's elite fraction), built once a run of the
    cell: the arm's chain and the gate step the same one."""
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step

    steps = x.setdefault("compiled", {})
    if name not in steps:
        opts = {} if cell.elite_frac is None else {"elite_frac": cell.elite_frac}
        steps[name] = compile_step(x["cfg"], use_kernel=name.startswith("kernel"),
                                   lean=name.endswith("lean"), **opts)
    return steps[name]


def _update_arms(cell, x, device):
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState

    cfg, m = x["cfg"], x["model"]
    args = (x["state"], x["path"], x["dt"], x["sp"], x["cp"])

    def start():
        return ControllerState.initial(x["seed"], cfg.horizon, m.num_controls,
                                       device=device)

    def arm(name):
        step = _update_step(cell, x, name)
        return timing.Chain(start, lambda c: step(c, *args)[0], cell.chain)

    return {name: arm(name) for name in cell.arms}


def _fleet_arms(cell, x, device):
    from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, init_fleet

    cfg = x["cfg"]
    args = (x["state"], x["path"], x["dt"], x["sp"], x["cp"])

    def arm(use_kernel):
        step = build_fleet_step(cfg, use_kernel=use_kernel)
        return timing.Chain(lambda: init_fleet(cfg, cell.robots, seed=x["seed"],
                                               device=device),
                            lambda c: step(c, *args)[0], cell.chain)

    return {"kernel": arm(True), "eager": arm(False)}


def _gate_update(cell, x, device):
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState

    cfg, m = x["cfg"], x["model"]
    ctrl = ControllerState.initial(x["seed"], cfg.horizon, m.num_controls, device=device)
    _, res = _update_step(cell, x, "kernel_lean")(ctrl, x["state"], x["path"], x["dt"],
                                                  x["sp"], x["cp"])
    u_plain, t_plain = plain_update(x, cell.elite_frac)
    gates = [gate_u(res.u_opt, u_plain)]
    if cell.elite_frac is not None:
        gates.append(gate_thresh(res.stats["elite_thresh"], t_plain))
    return check(*gates)


def _fleet_loop(cell, x, device):
    """``cell.cycles`` ticks of the kernel arm with the plant fed back; each
    robot's distance to the course at the end."""
    from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, init_fleet

    cfg, plant, dt = x["cfg"], x["model"], x["dt"]
    step = build_fleet_step(cfg, use_kernel=True)
    ctrls, states = init_fleet(cfg, cell.robots, seed=x["seed"], device=device), x["state"]
    for _ in range(cell.cycles):
        ctrls, res = step(ctrls, states, x["path"], dt, x["sp"], x["cp"])
        states = plant.step(states, res.u0, dt)
    final = states.cpu().numpy()
    return np.min(np.linalg.norm(final[:, None, :2] - x["course"][None], axis=-1), axis=1)


def _tracking(x, cycles):
    from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment

    return run_tracking_experiment(x["cfg"], x["sp"], x["cp"], x["course"],
                                   num_steps=cycles, seed=x["seed"], use_kernel=True,
                                   state0=x["start"])


def _serving(x, cycles):
    from ccv_mppi_path_tracker_tpu_torch.runtime.realtime import run_realtime_experiment

    # unpaced: at SERVING_HZ every deadline is missed, so a cycle's dt is its
    # own time and no cycle waits for its period (at 1000 Hz, as chip_smoke.py
    # phase 19 runs it, a cycle under 1 ms would read 1 ms). The pose channel's
    # max age, three periods, is then below any cycle, so the gate takes its
    # stale branch (hold the last command) every cycle; the plant steps on the
    # solution's u0 either way, so the track is the loop's.
    return run_realtime_experiment(x["cfg"], x["sp"], x["cp"], x["course"], hz=SERVING_HZ,
                                   num_cycles=cycles, use_kernel=True)


# torch's warning at each synchronizing call in sync debug mode (and not its
# one-time "Synchronization debug mode is a prototype feature ..." on the
# first set_sync_debug_mode of a process)
SYNC_WARNING = "called a synchronizing CUDA operation"


def sync_sites(caught) -> dict:
    """{file:line: count} of the sync warnings among ``caught``."""
    return dict(collections.Counter(
        "/".join(Path(w.filename).parts[-3:]) + f":{w.lineno}"
        for w in caught if SYNC_WARNING in str(w.message)).most_common())


def count_syncs(fn, device):
    """(fn(), the device's host syncs, {file:line: count} of where they were
    called) by torch's sync debug mode, which warns once a synchronizing
    call; (fn(), None, None) on the CPU."""
    if device.type != "cuda":
        return fn(), None, None
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = sync_sites(caught)
    return out, sum(sites.values()), sites


def metric_value(cell: Cell, step_ms: float) -> float:
    """The end-to-end metric at ``step_ms`` an update (tick, cycle): K*(T-1)
    propagations (bench.py:164-165), B robot-updates, or one cycle."""
    per = {"update": cell.num_samples * (cell.horizon - 1), "fleet": cell.robots}
    return per.get(cell.kind, 1.0) / (step_ms * 1e-3)


def timed(cell: Cell, samples, rounds=None) -> dict:
    """The record's timed fields from ``samples``, ms an update (tick, or
    cycle over a run). The metric is all the time over all the work: the
    samples' mean, as each chain (run) holds as many updates (cycles) as the
    next. The median and the tail stand beside it."""
    stats = timing.summary(samples)
    value = metric_value(cell, stats["mean"])
    out = {"value": value, "step_ms": stats["mean"], "step_ms_median": stats["median"],
           "step_ms_tail": {"p": stats["p"], "value": stats["p_value"]},
           "samples": stats["n"], "replan_hz": 1e3 / stats["mean"],
           "samples_ms": samples if rounds is None else None, "rounds_ms": rounds}
    if cell.kind == "update":
        out["vs_baseline"] = value / BASELINE_PROPAGATIONS
    return out


def kernel_work(cell):
    """The fused kernels' work in one update (tick, cycle) of the cell."""
    return work.update_work(cell.model, cell.num_samples, cell.horizon,
                            elite=cell.elite_frac is not None, num_robots=cell.robots)


def run(cell: Cell, seed: int, device, quick: bool = False):
    """Gate, then time, then trace one cell in this process. Returns the
    record (see ``bench_torch/__main__.py``); GateError if the gate fails.
    On the CPU every time, rate and share is None: a CPU run gives counts
    and gates only. ``quick``: short chains, one timed run a loop, and no
    traced run (the profiler's start-up alone takes 7-10 s a process)."""
    t0 = time.perf_counter()
    x = inputs(cell, seed, device)
    on_card = device.type == "cuda"
    reps = 3 if quick else 10
    runs = 1 if quick else 5
    window = 20
    if quick:
        cell = dataclasses.replace(cell, chain=10)
    layers, samples = {}, None

    if cell.kind in ("update", "fleet"):
        gates = (_gate_update(cell, x, device) if cell.kind == "update"
                 else check(gate_fleet(_fleet_loop(cell, x, device))))
        arms = (_update_arms if cell.kind == "update" else _fleet_arms)(cell, x, device)
        head = cell.arms[0]
        times = timing.interleaved(arms, reps, device)
        samples = times[head]
        rounds = [float(np.mean(samples[i:i + cell.chain]))
                  for i in range(0, len(samples), cell.chain)]
        host = arms[head].host
        if on_card:
            layers["host_enqueue_us_per_update"] = float(np.mean(host)) * 1e6
            for name in cell.arms[1:]:
                layers[f"{name}_ms"] = timing.summary(times[name])["mean"]
        head_arm = arms[head]

        def window_fn(mark):
            carry = head_arm.start()
            for _ in range(window):
                with mark():
                    carry = head_arm.step(carry)
        units = None   # one range an update
    elif cell.kind == "loop":
        rounds = None
        out = _tracking(x, cell.cycles)
        gates = check(gate_rmse(out["metrics"]["rmse"]))
        samples = []
        for _ in range(runs):
            sec, out = timing.host_seconds(lambda: _tracking(x, cell.cycles),
                                           device)
            check(gate_rmse(out["metrics"]["rmse"]))
            samples.append(sec * 1e3 / cell.cycles)

        def window_fn(mark):
            with mark():
                _tracking(x, window)
        units = window
    else:
        rounds = None
        _serving(x, 2)   # first use of the card's buffers, out of the count
        half = cell.cycles // 2
        out, syncs, sites = count_syncs(lambda: _serving(x, cell.cycles), device)
        _, short, short_sites = count_syncs(lambda: _serving(x, half), device)
        gates = check(gate_rmse(out["metrics"]["rmse"]),
                      gate_reads((syncs, short), (cell.cycles, half), [sites, short_sites]))
        samples, longest = [], 0.0
        for _ in range(runs):
            out = _serving(x, cell.cycles)
            check(gate_rmse(out["metrics"]["rmse"]))
            # the rate's dts add up to the first sleep (one period) and the
            # cycles but the last
            samples.append(out["rate_stats"]["mean_dt"] * cell.cycles / (cell.cycles - 1)
                           * 1e3)
            longest = max(longest, out["rate_stats"]["max_abs_jitter"] + 1.0 / SERVING_HZ)
        if on_card:
            layers["max_cycle_ms"] = longest * 1e3

        def window_fn(mark):
            with mark():
                _serving(x, window)
        units = window + 1   # the warm-up cycle

    t1 = time.perf_counter()
    rec = {"cell": cell.name, "metric": cell.metric, "unit": cell.unit,
           "model": cell.model, "num_samples": cell.num_samples,
           "horizon": cell.horizon, "robots": cell.robots,
           "elite_frac": cell.elite_frac, "kernel": True,
           "lean": cell.kind in ("update", "serving"), "seed": seed,
           "gate": {"ok": True, "checks": gates}, "quick": quick}
    bound, by = work.bound_ms(kernel_work(cell))
    rec["kernel_bound_ms"], rec["kernel_bound_by"] = bound, by
    if not on_card:
        rec.update(value=None, vs_baseline=None, step_ms=None,
                   note="CPU run: gates and counts only, no device metric")
        if not quick:
            trace.traced(window_fn, window, device, units=units)
        rec["seconds"] = {"gate_and_timing": t1 - t0, "trace": time.perf_counter() - t1}
        return rec
    rec.update(timed(cell, samples, rounds))
    layers.update(step_ms_median=rec["step_ms_median"], step_ms_tail=rec["step_ms_tail"]["value"])
    if not quick:
        bd = trace.traced(window_fn, window, device, units=units)
        layers.update(kernel_ms=bd["kernel_ms"],
                      kernel_bound_share=bound / bd["kernel_ms"] if bd["kernel_ms"] else None,
                      launches_per_update=bd["launches_per_update"],
                      device_busy_share=bd["device_busy_share"])
        rec["breakdown"] = bd
    rec["layers"] = layers
    rec["seconds"] = {"gate_and_timing": t1 - t0, "trace": time.perf_counter() - t1}
    return rec
