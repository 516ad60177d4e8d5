"""Full-body CCV model: steered base plus actuated upper body, with ZMP
(port of ``models/full_body.py``).

State (x, y, yaw, roll, pitch); controls (v, w, direction, roll_v, pitch_v).
Euler step as in src/full_body_mppi.cpp:445-452. The zero-moment point is a
post-rollout pass over the whole trajectory because step t's ZMP reads the
controls at t+1 (src/full_body_mppi.cpp:468-486). Physical constants are the
reference ctor's: a 60 kg upper-body box 0.208 x 0.208 x 0.8075 m with its
CoM at half height (src/full_body_mppi.cpp:86-91).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.models.base import Model
from ccv_mppi_path_tracker_tpu_torch.models.registry import register_model

UPPER_BODY_HEIGHT = 0.8075
UPPER_BODY_DEPTH = 0.208
UPPER_BODY_WIDTH = 0.208
# Geometry of the command mapping and the force-sensor ZMP, not of the
# dynamics (src/full_body_mppi.cpp:6, :57-63).
TREAD = 0.501
WHEEL_RADIUS = 0.1435
CONTACT_POSITIONS = np.array(
    [
        [0.0, 0.225, 0.075],  # left wheel
        [0.0, -0.225, 0.075],  # right wheel
        [0.245, 0.167, -0.003],  # front-left caster
        [0.245, -0.167, -0.004],  # front-right caster
        [-0.245, -0.167, -0.004],  # back-left caster
        [-0.245, 0.167, -0.003],  # back-right caster
    ]
)


@dataclasses.dataclass
class FullBodyParams:
    """Physical parameters of the upper-body ZMP model (tensors)."""

    mass: torch.Tensor
    base2com: torch.Tensor
    inertia: torch.Tensor  # (3,) diagonal of I_O
    gravity_z: torch.Tensor  # -9.8 (src/full_body_mppi.h:30)


def default_params(device=None, dtype=torch.float32) -> FullBodyParams:
    """Reference ctor values on ``device`` (None: the card). Built with
    ``torch.full`` (a fill on the device, no copy from the host)."""
    m = 60.0
    h, d, w = UPPER_BODY_HEIGHT, UPPER_BODY_DEPTH, UPPER_BODY_WIDTH
    c = h / 2.0  # src/full_body_mppi.cpp:86
    device = resolve_device(device)

    def full(v):
        return torch.full((), v, dtype=dtype, device=device)

    inertia = torch.stack([
        full(m * (w * w + h * h) / 12.0 + m * c * c),
        full(m * (h * h + d * d) / 12.0 + m * c * c),
        full(m * (d * d + w * w) / 12.0),
    ])  # src/full_body_mppi.cpp:87-91
    return FullBodyParams(mass=full(m), base2com=full(c), inertia=inertia,
                          gravity_z=full(-9.8))


def step(state, u, dt):
    x, y, yaw = state[..., 0], state[..., 1], state[..., 2]
    roll, pitch = state[..., 3], state[..., 4]
    v, w, direction = u[..., 0], u[..., 1], u[..., 2]
    roll_v, pitch_v = u[..., 3], u[..., 4]
    heading = yaw + direction
    return torch.stack(
        [
            x + v * torch.cos(heading) * dt,
            y + v * torch.sin(heading) * dt,
            yaw + w * dt,
            roll + roll_v * dt,
            pitch + pitch_v * dt,
        ],
        dim=-1,
    )


def zmp_from_model(com, accel, hg_dot, params: FullBodyParams):
    """ZMP of the box model from CoM position, base acceleration and dHG/dt,
    all (..., 3); returns (..., 2) (src/full_body_mppi.cpp:597-603)."""
    m = params.mass
    bx = -m * accel[..., 0]
    by = -m * accel[..., 1]
    bz = m * (params.gravity_z - accel[..., 2])
    mo_x = com[..., 1] * bz - com[..., 2] * by - hg_dot[..., 0]
    mo_y = com[..., 2] * bx - com[..., 0] * bz - hg_dot[..., 1]
    return torch.stack([-mo_y / bz, mo_x / bz], dim=-1)


def com_position(roll, pitch, params: FullBodyParams):
    """Upper-body CoM in the base frame (src/full_body_mppi.cpp:482)."""
    c = params.base2com
    return torch.stack(
        [
            c * torch.sin(pitch),
            -c * torch.sin(roll),
            c * torch.cos(pitch) * torch.cos(roll),
        ],
        dim=-1,
    )


def zmp_chain(states, controls, dt, params: FullBodyParams):
    """Per-step ZMP over a rollout (src/full_body_mppi.cpp:468-486).

    states: (T, ..., 5); controls: (T-1, ..., 5). Returns (T-2, ..., 2):
    entry t uses state[t], controls[t] and controls[t+1].
    """
    v, w = controls[..., 0], controls[..., 1]
    direction = controls[..., 2]
    drive_accel = (v[1:] - v[:-1]) / dt
    ac = v[:-1] * w[:-1]
    cos_d, sin_d = torch.cos(direction[:-1]), torch.sin(direction[:-1])
    ax = drive_accel * cos_d - ac * sin_d
    ay = drive_accel * sin_d + ac * cos_d
    accel = torch.stack([ax, ay, torch.zeros_like(ax)], dim=-1)

    omega = torch.stack(
        [controls[..., 3], controls[..., 4], controls[..., 1]], dim=-1
    )
    hg_dot = (omega[1:] - omega[:-1]) * (params.inertia / dt)

    com = com_position(states[:-2, ..., 3], states[:-2, ..., 4], params)
    return zmp_from_model(com, accel, hg_dot, params)


def aux_from_rollout(states, controls, dt, params):
    return {"zmp": zmp_chain(states, controls, dt, params)}


MODEL = register_model(
    Model(
        name="full_body",
        state_names=("x", "y", "yaw", "roll", "pitch"),
        control_names=("v", "w", "direction", "roll_v", "pitch_v"),
        step=step,
        aux_from_rollout=aux_from_rollout,
        default_params=default_params,
    )
)
