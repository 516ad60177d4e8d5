"""Rate-limited steering diff-drive: the steering angle is a state (port of
``models/rate_limited_steering.py``).

    state    (x, y, yaw, steer)
    controls (v, w, steer_rate)

    steer'  = clip(steer + clip(steer_rate, +-rate_max) dt, +-steer_max)
    x'      = x + v cos(yaw + steer) dt
    y'      = y + v sin(yaw + steer) dt
    yaw'    = yaw + w dt

Position integrates with the *current* steering angle, before this step's
slew. The limits are constants of the model variant (:func:`make_model`
builds a custom-limit one); the closed-form rollout and the fused kernel
read them from ``Model.constants``.
"""

from __future__ import annotations

import math

import torch

from ccv_mppi_path_tracker_tpu_torch.models.base import Model
from ccv_mppi_path_tracker_tpu_torch.models.registry import register_model

STEER_MAX = 30.0 * math.pi / 180.0
RATE_MAX = 2.6


def symmetric_clip(x, bound):
    """clip(x, -bound, bound) as ``jnp.clip`` computes it, a maximum then a
    minimum: ``torch.clamp``'s values, with derivative 1/2 (clamp's is 1)
    where x sits on a bound. Refinement's box projection puts the rate
    exactly on rate_max, so the gradients there match the JAX package's; the
    closed-form rollout's steer sequence clips the same way."""
    b = x.new_full((), bound)
    return torch.minimum(torch.maximum(x, -b), b)


def make_step(steer_max: float = STEER_MAX, rate_max: float = RATE_MAX):
    def step(state, u, dt):
        x, y, yaw, steer = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
        v, w, rate = u[..., 0], u[..., 1], u[..., 2]
        heading = yaw + steer
        rate = symmetric_clip(rate, rate_max)
        new_steer = symmetric_clip(steer + rate * dt, steer_max)
        return torch.stack(
            [x + v * torch.cos(heading) * dt, y + v * torch.sin(heading) * dt,
             yaw + w * dt, new_steer],
            dim=-1,
        )

    return step


def make_model(name="rate_limited_steering", steer_max=STEER_MAX,
               rate_max=RATE_MAX) -> Model:
    return Model(
        name=name,
        state_names=("x", "y", "yaw", "steer"),
        control_names=("v", "w", "steer_rate"),
        step=make_step(steer_max, rate_max),
        constants={"steer_max": steer_max, "rate_max": rate_max},
    )


MODEL = register_model(make_model())
