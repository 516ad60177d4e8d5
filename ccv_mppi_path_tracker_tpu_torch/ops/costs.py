"""Per-trajectory costs (port of ``ops/costs.py``).

- unicycle / steering models (src/diff_drive_mppi.cpp:194-210): path and
  velocity terms. The path term covers all T states and the velocity term
  the T-1 defined controls (the reference reads one control past the end).
- full-body model (src/full_body_mppi.cpp:404-424): path distance, velocity,
  ZMP-y, roll-rate smoothness, backward motion and the initial-yaw term,
  summed over t in [0, T-3] as the reference's ``t < horizon_-2``.
"""

from __future__ import annotations

import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.mindist import min_sq_distance


def tracking_cost(states, controls, ref: RefWindow, cp: CostParams):
    """Cost of the unicycle / steering models. states: (T, K, S); controls:
    (T-1, K, U). Returns (K,)."""
    d2 = min_sq_distance(states[..., :2], ref.xy)
    dv = controls[..., 0] - cp.v_ref
    return (cp.path_weight * torch.sum(d2, dim=0)
            + cp.v_weight * torch.sum(dv * dv, dim=0))


def full_body_cost(states, controls, zmp, ref: RefWindow, cp: CostParams):
    """states: (T, K, 5); controls: (T-1, K, 5); zmp: (T-2, K, 2).
    Returns (K,)."""
    tm2 = states.shape[0] - 2
    d2 = min_sq_distance(states[:tm2, ..., :2], ref.xy)
    v = controls[:tm2, ..., 0]
    dv = v - cp.v_ref
    zmp_y = zmp[..., 1]
    roll_v = controls[..., 3]
    droll_v = roll_v[1 : tm2 + 1] - roll_v[:tm2]
    back = torch.where(v < 0.0, v * v, 0.0)
    dyaw0 = states[0, ..., 2] - ref.yaw[0]
    return (
        cp.path_weight * torch.sum(d2, dim=0)
        + cp.v_weight * torch.sum(dv * dv, dim=0)
        + cp.zmp_weight * torch.sum(zmp_y * zmp_y, dim=0)
        + cp.roll_v_weight * torch.sum(droll_v * droll_v, dim=0)
        + cp.back_weight * torch.sum(back, dim=0)
        + cp.yaw_weight * dyaw0 * dyaw0
    )


def trajectory_costs(model_name, states, controls, aux, ref, cp):
    """Per-trajectory costs for ``model_name``: the registered model's
    ``cost_fn`` where it has one, else the built-in cost above."""
    custom = get_model(model_name).cost_fn
    if custom is not None:
        return custom(states, controls, aux, ref, cp)
    if model_name == "full_body":
        return full_body_cost(states, controls, aux["zmp"], ref, cp)
    return tracking_cost(states, controls, ref, cp)
