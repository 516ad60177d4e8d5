"""Steering ("crab") differential drive (port of
``models/steering_unicycle.py``).

State (x, y, yaw); controls (v, w, steer). The motion direction is decoupled
from the body yaw by the steering angle (src/steering_diff_drive_mppi.cpp:120-125):

    x'   = x   + v cos(yaw + steer) dt
    y'   = y   + v sin(yaw + steer) dt
    yaw' = yaw + w dt
"""

from __future__ import annotations

import torch

from ccv_mppi_path_tracker_tpu_torch.models.base import Model
from ccv_mppi_path_tracker_tpu_torch.models.registry import register_model


def step(state, u, dt):
    x, y, yaw = state[..., 0], state[..., 1], state[..., 2]
    v, w, steer = u[..., 0], u[..., 1], u[..., 2]
    heading = yaw + steer
    return torch.stack(
        [x + v * torch.cos(heading) * dt, y + v * torch.sin(heading) * dt,
         yaw + w * dt],
        dim=-1,
    )


MODEL = register_model(
    Model(
        name="steering_unicycle",
        state_names=("x", "y", "yaw"),
        control_names=("v", "w", "steer"),
        step=step,
    )
)
