"""Per-trajectory costs (port of ``ops/costs.py``).

- unicycle / steering models (src/diff_drive_mppi.cpp:194-210): path and
  velocity terms. The path term covers all T states and the velocity term
  the T-1 defined controls (the reference reads one control past the end).
- full-body model (src/full_body_mppi.cpp:404-424): path distance, velocity,
  ZMP-y, roll-rate smoothness, backward motion and the initial-yaw term,
  summed over t in [0, T-3] as the reference's ``t < horizon_-2``.

Each sample's terms are summed over time in a row of their own
(:func:`sums_over_time`), so a sample's cost does not depend on how many
samples share the tensor: the K/N costs of a shard are its slice of the
unsharded costs, bit for bit.
"""

from __future__ import annotations

import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.mindist import min_sq_distance


def sums_over_time(*terms):
    """The sums of equal-shape (T, ...) terms over their leading time axis,
    (len(terms), ...). The terms are stacked and moved, in one copy, to rows
    of their own, one per sample and term, and each row is reduced. (A sum
    over the outer time axis is vectorized across the samples, and its
    rounding then depends on their count.)"""
    x = terms[0][None] if len(terms) == 1 else torch.stack(terms)
    return torch.sum(x.movedim(1, -1).contiguous(), dim=-1)


def tracking_cost(states, controls, ref: RefWindow, cp: CostParams):
    """Cost of the unicycle / steering models. states: (T, K, S); controls:
    (T-1, K, U). Returns (K,)."""
    d2 = min_sq_distance(states[..., :2], ref.xy)
    dv = controls[..., 0] - cp.v_ref
    return (cp.path_weight * sums_over_time(d2)[0]
            + cp.v_weight * sums_over_time(dv * dv)[0])


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
    path, vel, zmp_s, roll, bwd = sums_over_time(d2, dv * dv, zmp_y * zmp_y,
                                                 droll_v * droll_v, back)
    return (
        cp.path_weight * path
        + cp.v_weight * vel
        + cp.zmp_weight * zmp_s
        + cp.roll_v_weight * roll
        + cp.back_weight * bwd
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
