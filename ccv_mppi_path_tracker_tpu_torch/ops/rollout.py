"""Batched trajectory rollout (port of ``ops/rollout.py``)."""

from __future__ import annotations

import torch

from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model

# Models whose Euler chain collapses to prefix sums. rate_limited_steering
# clips the steering state each step: that chain stays sequential, but only
# (K,)-wide, and its position and yaw integrals are prefix sums given it.
CLOSED_FORM_MODELS = (
    "unicycle", "steering_unicycle", "full_body", "rate_limited_steering"
)


def rollout(step_fn, state0: torch.Tensor, controls: torch.Tensor, dt):
    """Integrate ``controls`` (T-1, ..., U) from ``state0`` (..., S) with the
    sequential Euler recurrence. Returns states (T, ..., S), state0 first."""
    states = [state0]
    for u in controls:
        states.append(step_fn(states[-1], u, dt))
    return torch.stack(states)


def model_rollout(model, state0: torch.Tensor, controls: torch.Tensor, dt, params=None):
    """The sequential rollout of the registered ``model``: its own
    (``Model.rollout``, which takes the model's parameters ``params``) where
    it supplies one, else :func:`rollout` of its step."""
    if model.rollout is not None:
        return model.rollout(state0, controls, dt, params)
    return rollout(model.step, state0, controls, dt)


def steer_limits(model_name: str):
    """(steer_max, rate_max) of a rate-limited steering variant, read from
    the registered model's constants (not the module defaults), so that a
    custom-limit variant re-registered under the same name keeps the closed
    form and the fused kernel in agreement with its own step function."""
    from ccv_mppi_path_tracker_tpu_torch.models.rate_limited_steering import (
        RATE_MAX,
        STEER_MAX,
    )

    consts = get_model(model_name).constants or {}
    return consts.get("steer_max", STEER_MAX), consts.get("rate_max", RATE_MAX)


def _steer_sequence(model_name, steer0, rates, dt):
    """(T-1, ...) commanded rates -> the (T-1, ...) steering angles that the
    position integral uses at steps 0..T-2 (the angle before each step's
    slew), and the final angle. The clips are the model step's
    (``symmetric_clip``), so derivatives through them agree too."""
    from ccv_mppi_path_tracker_tpu_torch.models.rate_limited_steering import symmetric_clip

    steer_max, rate_max = steer_limits(model_name)
    used = []
    s = steer0
    for rate in rates:
        used.append(s)
        s = symmetric_clip(s + symmetric_clip(rate, rate_max) * dt, steer_max)
    return torch.stack(used), s


def rollout_closed_form(model_name: str, state0: torch.Tensor,
                        controls: torch.Tensor, dt):
    """Scan-free rollout via prefix sums: yaw_t = yaw_0 + dt*sum_{s<t} w_s;
    heading_t = yaw_t, plus the steer control (steering_unicycle,
    full_body) or the sequentially clipped steer state
    (rate_limited_steering); x_t = x_0 + dt*sum_{s<t} v_s cos(heading_s),
    likewise y; roll and pitch are plain control integrals. Agrees with
    :func:`rollout` to round-off.

    The prefix sums are ``torch.cumsum``: the JAX package's tril matmul at
    HIGHEST precision would, as a float32 matmul allowed to use TF32, lose
    the parity this path is tested at.

    state0: (..., S); controls: (T-1, ..., U). Returns (T, ..., S).
    """
    if model_name not in CLOSED_FORM_MODELS:
        raise ValueError(f"no closed-form rollout for model {model_name!r}")

    def integrate(rate):
        run = torch.cumsum(rate, dim=0) * dt
        return torch.cat([torch.zeros_like(run[:1]), run], dim=0)

    v, w = controls[..., 0], controls[..., 1]
    yaw = state0[..., 2] + integrate(w)
    heading = yaw[:-1]
    cols_after = []
    if model_name == "rate_limited_steering":
        steer_used, steer_last = _steer_sequence(
            model_name, state0[..., 3], controls[..., 2], dt)
        heading = heading + steer_used
        cols_after.append(torch.cat([steer_used, steer_last[None]], dim=0))
    elif model_name != "unicycle":
        heading = heading + controls[..., 2]
    x = state0[..., 0] + integrate(v * torch.cos(heading))
    y = state0[..., 1] + integrate(v * torch.sin(heading))
    if model_name == "full_body":
        cols_after.append(state0[..., 3] + integrate(controls[..., 3]))
        cols_after.append(state0[..., 4] + integrate(controls[..., 4]))
    return torch.stack([x, y, yaw, *cols_after], dim=-1)
