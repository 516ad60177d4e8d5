#!/usr/bin/env python3
"""Stage-level breakdown of the PyTorch port's eager arm (``use_kernel=False``,
the path every user-registered model runs) on one NVIDIA card: the twin of
scripts/xla_breakdown.py.

At the flagship (full_body, K=102400, T=30, float32) each stage of the eager
update is captured as a CUDA graph of its own, and each graph's outputs are
the next stage's inputs (the data dependency that chains them):

  sample             draw_standard_normals (the philox_normals kernel, its
                     key a device tensor) and sample_controls
  rollout_cumsum     rollout_closed_form (prefix sums)
  rollout_trimatmul  the JAX script's triangular-product variant of the
                     same rollout (a measuring variant: torch.matmul, TF32
                     off), with its max |diff| against the cumsum form
  zmp                models/full_body.py zmp_chain
  cost               ops/costs.py full_body_cost
  softmax_update     softmax_weights and weighted_update

and beside them the whole update, ``compile_step(cfg, use_kernel=False,
lean=True)`` called as a user calls it (each call a replay of its graph).
For each: ms of a replay (CUDA events, the median of 9 repetitions of 50
replays, the arms timed in turns), its device launches and busy share
(torch.profiler, as chip_smoke.py phase 31 counts them: device events a
replay), and its share of the whole; then the sum of the stages (all but
the trimatmul variant) against the whole.

    python3 scripts/torch_eager_breakdown.py [--out FILE]
        writes FILE (default artifacts/eager_breakdown_torch.json)
    python3 scripts/torch_eager_breakdown.py --quick [--out FILE]
        K=10240, 3 repetitions of 10 replays (chip_smoke.py phase 35)

Prints the card's name and power limit beside the numbers. Exits non-zero
without a CUDA device.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (timing in turns, busy share, nvidia-smi)

# the stages that make up the update, in order (the trimatmul variant is
# timed beside them, not summed)
STAGES = ("sample", "rollout_cumsum", "zmp", "cost", "softmax_update")


def capture(fn, *args):
    """(graph, outputs): one CUDA graph of fn(*args), captured after two
    warm calls on a side stream; a replay rewrites the outputs in place."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    torch.cuda.synchronize()
    return graph, out


def trimatmul_rollout(state0, u, dt):
    """scripts/xla_breakdown.py's f_rollout_mm: each prefix sum as a product
    with the lower-triangular ones, (T-1, T-1) @ (T-1, K)."""
    import torch

    tm1 = u.shape[0]
    tri = torch.tril(torch.ones((tm1, tm1), dtype=u.dtype, device=u.device))

    def integrate(rate):
        run = torch.matmul(tri, rate) * dt
        return torch.cat([torch.zeros_like(run[:1]), run], dim=0)

    v, w = u[..., 0], u[..., 1]
    yaw = state0[2] + integrate(w)
    heading = yaw[:-1] + u[..., 2]
    x = state0[0] + integrate(v * torch.cos(heading))
    y = state0[1] + integrate(v * torch.sin(heading))
    roll = state0[3] + integrate(u[..., 3])
    pitch = state0[4] + integrate(u[..., 4])
    return torch.stack([x, y, yaw, roll, pitch], dim=-1)


def breakdown(num_samples, horizon, reps, inner, device="cuda"):
    """The record of one breakdown at (K, T) = (num_samples, horizon)."""
    import numpy as np
    import torch

    from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow, make_key
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import philox_normals_cuda
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params, zmp_chain
    from ccv_mppi_path_tracker_tpu_torch.ops.costs import full_body_cost
    from ccv_mppi_path_tracker_tpu_torch.ops.rollout import rollout_closed_form
    from ccv_mppi_path_tracker_tpu_torch.ops.sampling import (
        draw_standard_normals,
        sample_controls,
    )
    from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import (
        softmax_weights,
        weighted_update,
    )
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.solver import compile_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    k, t = num_samples, horizon
    cfg, sp, cp, course = full_body_launch(num_samples=k, horizon=t, device=dev)
    mp = default_params(device=dev)
    rng = np.random.RandomState(0)
    u_prev = torch.tensor(rng.randn(t - 1, 5) * 0.05, dtype=torch.float32, device=dev)
    state0 = torch.zeros(5, device=dev)
    ref = RefWindow(xy=torch.tensor(course[:t, :2], dtype=torch.float32, device=dev),
                    yaw=torch.zeros(t, device=dev))
    dt = torch.full((), 0.1, device=dev)
    key = make_key(3, 7, dev)

    def f_sample(key, u_prev):
        noise = draw_standard_normals(key, None, None, (t - 1, k, 5), device=dev)
        return sample_controls(u_prev, sp, k, noise=noise)

    def f_rollout(u):
        return rollout_closed_form("full_body", state0.expand(k, -1), u, dt)

    def f_rollout_mm(u):
        return trimatmul_rollout(state0, u, dt)

    def f_zmp(states, u):
        return zmp_chain(states, u, dt, mp)

    def f_cost(states, u, zmp):
        return full_body_cost(states, u, zmp, ref, cp)

    def f_update(costs, u):
        weights, stats = softmax_weights(costs, sp.lam)
        return weighted_update(weights, u), stats["min_cost"]

    graphs = {}
    graphs["sample"], u = capture(f_sample, key, u_prev)
    graphs["rollout_cumsum"], states = capture(f_rollout, u)
    graphs["rollout_trimatmul"], states_mm = capture(f_rollout_mm, u)
    graphs["zmp"], zmp = capture(f_zmp, states, u)
    graphs["cost"], costs = capture(f_cost, states, u, zmp)
    graphs["softmax_update"], (u_opt, min_cost) = capture(f_update, costs, u)
    for graph in graphs.values():
        graph.replay()
    torch.cuda.synchronize()
    outs = dict(u=u, states=states, zmp=zmp, costs=costs, u_opt=u_opt)
    bad = [name for name, v in outs.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise SystemExit(f"non-finite stage outputs: {bad}")
    maxdiff = float((states_mm - states).abs().max())

    # the whole update as a user calls it: compile_step's replay
    path = PathBuffer.from_points(course, 0.1, device=dev)
    step = compile_step(cfg, use_kernel=False, lean=True)
    ctrl = ControllerState(u_prev, 3, 7, make_key(3, 7, dev))
    state = torch.tensor([0.05, float(course[0, 1]) + 0.1, 0.1, 0.02, -0.03], device=dev)

    def whole():
        step(ctrl, state, path, dt, sp, cp, model_params=mp)

    whole()
    draws = philox_normals_cuda.launches
    whole()
    torch.cuda.synchronize()
    if philox_normals_cuda.launches - draws != 1 or step.graph.captures != 1:
        raise SystemExit(f"the compiled eager update replayed "
                         f"{philox_normals_cuda.launches - draws} draws, "
                         f"{step.graph.captures} captures")
    arms = {name: (graph.replay, inner) for name, graph in graphs.items()}
    arms["whole"] = (whole, inner)
    times = smoke.time_interleaved(arms, reps)
    rows = {}
    for name, v in times.items():
        ms = statistics.median(v)
        busy, events = smoke.busy_share(arms[name][0], 5, ms)
        rows[name] = dict(ms=ms, ms_min=min(v), ms_max=max(v), launches=events, busy=busy)
    whole_ms = rows["whole"]["ms"]
    for row in rows.values():
        row["share_of_whole"] = row["ms"] / whole_ms
    stage_sum = sum(rows[name]["ms"] for name in STAGES)
    return dict(num_samples=k, horizon=t, stages=rows, trimatmul_maxdiff=maxdiff,
                sum_of_stages_ms=stage_sum, whole_ms=whole_ms,
                sum_over_whole=stage_sum / whole_ms,
                launches_sum_of_stages=sum(rows[name]["launches"] for name in STAGES))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "eager_breakdown_torch.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    card = smoke.nvidia_smi("name,power.limit")
    if args.quick:
        rec = breakdown(10_240, smoke.T_MAIN, reps=3, inner=10)
    else:
        rec = breakdown(smoke.K_MAIN, smoke.T_MAIN, reps=9, inner=50)
    rec.update(card=card, device=torch.cuda.get_device_name(0),
               clocks=smoke.nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"),
               method="each stage one CUDA graph, its inputs the previous stage's outputs; "
                      "CUDA events, median of the repetitions, the arms in turns; launches "
                      "and busy share by torch.profiler; the whole update compile_step's "
                      "replay", quick=args.quick)
    print(f"eager arm breakdown, full_body K={rec['num_samples']} T={rec['horizon']} float32 "
          f"on {card}:")
    for name, row in rec["stages"].items():
        busy = "not measured" if row["busy"] is None else f"{row['busy']:.3f}"
        print(f"  {name}: {row['ms']:.4f} ms [{row['ms_min']:.4f}, {row['ms_max']:.4f}], "
              f"{row['launches']:.0f} launches, busy {busy}, "
              f"{100 * row['share_of_whole']:.1f} % of the whole", flush=True)
    print(f"  sum of the stages {rec['sum_of_stages_ms']:.4f} ms "
          f"({rec['launches_sum_of_stages']:.0f} launches) against the whole "
          f"{rec['whole_ms']:.4f} ms: {rec['sum_over_whole']:.3f}; trimatmul max |diff| "
          f"against cumsum {rec['trimatmul_maxdiff']:.3e}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
