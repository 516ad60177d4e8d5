"""Unicycle (plain differential-drive) kinematics (port of
``models/unicycle.py``).

State (x, y, yaw); controls (v, w). Forward-Euler step of the diff-drive
node's model (src/diff_drive_mppi.cpp:104-109):

    x'   = x   + v cos(yaw) dt
    y'   = y   + v sin(yaw) dt
    yaw' = yaw + w dt
"""

from __future__ import annotations

import torch

from ccv_mppi_path_tracker_tpu_torch.models.base import Model
from ccv_mppi_path_tracker_tpu_torch.models.registry import register_model


def step(state, u, dt):
    x, y, yaw = state[..., 0], state[..., 1], state[..., 2]
    v, w = u[..., 0], u[..., 1]
    return torch.stack(
        [x + v * torch.cos(yaw) * dt, y + v * torch.sin(yaw) * dt, yaw + w * dt],
        dim=-1,
    )


MODEL = register_model(
    Model(
        name="unicycle",
        state_names=("x", "y", "yaw"),
        control_names=("v", "w"),
        step=step,
    )
)
