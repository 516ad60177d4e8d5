"""Pure-pursuit baseline controller (port of ``runtime/pure_pursuit.py``).

The reference evaluates its MPPI trackers against a pure-pursuit controller
from a sibling package (launch/pure_pursuit.launch; comparison plots in
src/graph2.py and per-method log directories in src/record_state.py:84-91).
This is the same baseline on the PathBuffer: classic lookahead pure
pursuit, as tensor ops on the path's device with no host read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer, nearest_index


@dataclasses.dataclass(frozen=True)
class PurePursuitConfig:
    lookahead: float = 1.0  # m
    v_ref: float = 1.2
    w_max: float = 2.0


def pure_pursuit_step(cfg: PurePursuitConfig, state, path: PathBuffer):
    """One control step: returns u0 = (v, w).

    Picks the first path point at least ``lookahead`` ahead of the nearest
    index, transforms it into the robot frame, and commands the arc through
    it: w = 2 v y_local / L^2. v is the path's dtype, as in the JAX package.
    """
    x, y, yaw = state[0], state[1], state[2]
    cur = nearest_index(path, state[:2])
    xy = path.xy
    diff = xy - torch.stack([x, y])
    dist = torch.hypot(diff[:, 0], diff[:, 1])
    idx = torch.arange(xy.shape[0], device=xy.device)
    valid = (idx >= cur) & (idx < path.num_valid) & (dist >= cfg.lookahead)
    # the first qualifying index; the last valid point near the course end
    target_idx = torch.where(valid.any(), torch.argmax(valid.to(torch.int32)),
                             path.num_valid - 1)
    # a 1-element index gathers on the device (a 0-d one would be read back)
    target = xy[target_idx.view(1)][0]
    dx, dy = target[0] - x, target[1] - y
    y_local = -torch.sin(yaw) * dx + torch.cos(yaw) * dy
    l2 = dx * dx + dy * dy
    curvature = 2.0 * y_local / torch.clamp(l2, min=1e-9)
    v = torch.full((), cfg.v_ref, dtype=xy.dtype, device=xy.device)
    w = torch.clamp(v * curvature, -cfg.w_max, cfg.w_max)
    return torch.stack([v.to(w.dtype), w])


def run_pure_pursuit_experiment(
    course, num_steps=200, dt=0.1, cfg: PurePursuitConfig = PurePursuitConfig(),
    dtype=torch.float32, device=None,
):
    """Closed-loop pure-pursuit tracking on the unicycle, for the MPPI
    comparison, on ``device`` (None: the card). The path is float32, the
    state ``dtype``. Returns {"logs" (state, u0), "metrics", "course"}."""
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model

    device = resolve_device(device)
    path = PathBuffer.from_points(course, 0.1, dtype=torch.float32, device=device)
    plant = get_model("unicycle")
    heading = float(np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0]))
    state0 = torch.tensor([course[0, 0], course[0, 1], heading], dtype=dtype,
                          device=device)
    state, states, u0s = state0, [], []
    for _ in range(num_steps):
        u0 = pure_pursuit_step(cfg, state, path)
        state = plant.step(state, u0, dt)
        states.append(state)
        u0s.append(u0)
    logs = {"state": torch.stack(states).cpu().numpy(), "u0": torch.stack(u0s).cpu().numpy()}
    xy = np.concatenate([state0[None, :2].cpu().numpy(), logs["state"][:, :2]])
    return {"logs": logs, "metrics": tracking_metrics(xy, course, dt=dt), "course": course}
