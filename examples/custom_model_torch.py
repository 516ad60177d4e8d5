#!/usr/bin/env python
"""Register a fifth, user-defined dynamics model with the PyTorch port and
run it end to end (the port's twin of examples/custom_model.py).

A new model family is one batched step function plus ``register_model``, no
edit to the package. This example adds a **kinematic bicycle** (state (x, y,
yaw), controls (v, delta), wheelbase L: yaw' = yaw + v*tan(delta)/L * dt)
and its steering-effort cost variant, and drives them through:

  1. the single-device ``mppi_step``, and gradient refinement of the custom
     cost (diff/gradients.py rolls a model without a closed form out
     sequentially and differentiates its ``cost_fn``);
  2. ``use_kernel="auto"``, which picks the eager path: the fused kernel
     implements the four built-in models only. On the card the eager step
     replays as a CUDA graph, its normals drawn from the cycle's key by a
     CUDA kernel (ops/sampling.py draw_standard_normals);
  3. the sample-sharded step (``build_sharded_step`` over a
     ``torch.distributed`` group: the processes of a ``torchrun`` launch, or
     else a group of this one process; over NCCL on the card a CUDA graph's
     replay with the collectives inside);
  4. a closed-loop tracking run with the calc_e_rmse-style metrics.

Run:  python examples/custom_model_torch.py [--device cpu]
      torchrun --nproc-per-node 2 examples/custom_model_torch.py   (rank r on cuda:r)
      torchrun --nproc-per-node 2 examples/custom_model_torch.py --device cpu
Test: tests/test_torch_custom_model.py runs the four stages.
"""

from __future__ import annotations

import argparse
import math
import socket
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ccv_mppi_path_tracker_tpu_torch.core import (  # noqa: E402
    ControllerState,
    SolverConfig,
    make_cost_params,
    make_solver_params,
)
from ccv_mppi_path_tracker_tpu_torch.models import Model, register_model  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.ops.costs import tracking_cost  # noqa: E402

WHEELBASE = 0.5  # m, about the CCV's footprint
STEER_MAX = 35.0 * math.pi / 180.0


def bicycle_step(state, u, dt):
    """Batched Euler step, rows broadcast: (..., 3) x (..., 2). The steering
    clip is min(max(.)), whose derivative at a bound is 1/2 as jnp.clip's."""
    x, y, yaw = state[..., 0], state[..., 1], state[..., 2]
    v = u[..., 0]
    limit = torch.full_like(u[..., 1], STEER_MAX)
    delta = torch.minimum(torch.maximum(u[..., 1], -limit), limit)
    return torch.stack([
        x + v * torch.cos(yaw) * dt,
        y + v * torch.sin(yaw) * dt,
        yaw + v * torch.tan(delta) / WHEELBASE * dt,
    ], dim=-1)


BICYCLE = register_model(Model(
    name="kinematic_bicycle",
    state_names=("x", "y", "yaw"),
    control_names=("v", "delta"),
    step=bicycle_step,
))


def bicycle_effort_cost(states, controls, aux, ref, cp):
    """The built-in tracking cost plus a steering-effort penalty: the
    ``Model.cost_fn`` extension point (the reference hardwires its costs in
    each controller node, src/diff_drive_mppi.cpp:194-210)."""
    delta = controls[..., 1]
    return tracking_cost(states, controls, ref, cp) + 2.0 * torch.sum(delta * delta, dim=0)


# the same dynamics with the custom cost, registered as its own family: the
# solver and gradient refinement (which differentiates the same cost) use it
BICYCLE_EFFORT = register_model(Model(
    name="kinematic_bicycle_effort",
    state_names=BICYCLE.state_names,
    control_names=BICYCLE.control_names,
    step=bicycle_step,
    cost_fn=bicycle_effort_cost,
))


def make_problem(num_samples=2048, horizon=20, device=None):
    """(cfg, sp, cp, course, path) of the bicycle tracker on ``device``
    (None: the card)."""
    from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, sum_of_cosines_course

    cfg = SolverConfig(model="kinematic_bicycle", num_samples=num_samples, horizon=horizon)
    # steering needs wider exploration and a sharper softmax than the
    # diff-drive tuning: the yaw rate is v*tan(delta)/L, so small delta noise
    # barely bends the candidate rollouts
    sp = make_solver_params(control_noise=[0.3, 0.2], lam=0.3, u_min=[-1.0, -STEER_MAX],
                            u_max=[2.0, STEER_MAX], device=device)
    cp = make_cost_params(v_ref=1.2, path_weight=10.0, v_weight=1.0, device=device)
    course = sum_of_cosines_course(
        amplitudes=(1.0, 0.0, 0.0), frequencies=(0.2, 0.0, 0.0), deltas=(0.0, 0.0, 0.0),
        resolution=0.1, course_length=18.0, dtype=np.float32)
    path = PathBuffer.from_points(course, 0.1, device=device)
    return cfg, sp, cp, course, path


def closed_loop_rmse(steps=150, num_samples=2048, horizon=20, device=None, group=None):
    """Track the course with the bicycle as controller model and plant
    through ``MPPISolver(use_kernel="auto")``, or the sharded step over
    ``group`` when one is given; the calc_e_rmse-style metrics."""
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.parallel import build_sharded_step
    from ccv_mppi_path_tracker_tpu_torch.solver import MPPISolver

    cfg, sp, cp, course, path = make_problem(num_samples, horizon, device)
    ctrl = ControllerState.initial(0, horizon, BICYCLE.num_controls, device=device)
    if group is None:
        step = MPPISolver(cfg, use_kernel="auto", device=ctrl.u_prev.device).step
    else:
        step = build_sharded_step(cfg, group)
    dt = torch.full((), 0.1, device=ctrl.u_prev.device)
    state = torch.tensor([0.0, float(course[0, 1]), 0.0], device=ctrl.u_prev.device)
    xs = []
    for _ in range(steps):
        ctrl, res = step(ctrl, state, path, dt, sp, cp)
        state = bicycle_step(state, res.u0, dt)  # the plant is the model here
        xs.append(state[:2])
    return tracking_metrics(torch.stack(xs).cpu().numpy(), course, dt=0.1)


def _join_group(device):
    """Join the group of a configured launch, or else make a group of this
    process alone (gloo on the CPU, NCCL on the card)."""
    from ccv_mppi_path_tracker_tpu_torch.parallel import initialize_multihost

    backend = "nccl" if device.type == "cuda" else "gloo"
    if initialize_multihost(backend=backend):
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"localhost:{port}", 1, 0, backend=backend)


def main(argv=None):
    import torch.distributed as dist

    from ccv_mppi_path_tracker_tpu_torch.diff.gradients import make_trajectory_cost
    from ccv_mppi_path_tracker_tpu_torch.parallel import (
        build_sharded_step,
        samples_group,
        shutdown_multihost,
    )
    from ccv_mppi_path_tracker_tpu_torch.solver import MPPISolver, mppi_step

    p = argparse.ArgumentParser(description="the kinematic bicycle, end to end")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=150, help="closed-loop cycles")
    p.add_argument("--num-samples", type=int, default=2048)
    p.add_argument("--horizon", type=int, default=20)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    # join the launch's group first: each rank of a torchrun launch then takes
    # its own card, cuda:{LOCAL_RANK}
    _join_group(device)
    if device.type == "cuda" and device.index is None:
        device = samples_group()[1]
        torch.cuda.set_device(device)

    # 1. the single-device step, and refinement of the custom cost
    cfg, sp, cp, course, path = make_problem(num_samples=512, horizon=12, device=device)
    ctrl = ControllerState.initial(0, cfg.horizon, 2, device=device)
    state = torch.tensor([0.0, float(course[0, 1]) + 0.4, 0.0], device=device)
    effort = SolverConfig(model="kinematic_bicycle_effort", num_samples=512, horizon=12)
    _, res = mppi_step(effort, ctrl, state, path, 0.1, sp, cp)
    _, refined = mppi_step(effort, ctrl, state, path, 0.1, sp, cp, refine_steps=3,
                           refine_step_size=0.01)
    cost_fn = make_trajectory_cost(effort)
    c0 = float(cost_fn(res.u_opt, state, res.ref, 0.1, cp))
    c1 = float(cost_fn(refined.u_opt, state, refined.ref, 0.1, cp))
    print(f"model registered: {BICYCLE.name} (S={cfg.num_states}, U={cfg.num_controls}); "
          f"effort-cost step u0 {res.u0.cpu().numpy().round(4).tolist()}; refinement "
          f"lowered its cost {c0:.4f} -> {c1:.4f}")

    # 2. auto takes the eager path for a user model, on any device
    solver = MPPISolver(cfg, use_kernel="auto", device=device)
    replay = ", replayed as a CUDA graph" if device.type == "cuda" else ""
    print(f"solver path: {'fused kernel' if solver.use_kernel else 'eager'} (auto) "
          f"on {device}{replay}")

    # 3. the sharded step
    _, sharded = build_sharded_step(cfg)(ctrl, state, path, 0.1, sp, cp)
    print(f"sharded step over {dist.get_world_size()} process(es): u0 "
          f"{sharded.u0.cpu().numpy().round(4).tolist()}")
    shutdown_multihost()   # over NCCL the step is a graph holding the group

    # 4. the closed loop
    m = closed_loop_rmse(steps=args.steps, num_samples=args.num_samples,
                         horizon=args.horizon, device=device)
    print(f"single-device closed loop: RMSE {m['rmse']:.3f} m, max {m['max_error']:.3f} m")
    return m


if __name__ == "__main__":
    main()
