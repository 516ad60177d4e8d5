"""Typed configuration for the MPPI solver (port of ``core/config.py``).

- :class:`SolverConfig` — static structure: model family, sample count K,
  horizon T, feature flags.
- :class:`SolverParams` / :class:`CostParams` — numeric parameters as
  dataclasses of tensors that live on the solver's device, so the control
  update never copies a parameter from the host. The builders below make
  them on ``device``, the card when it is None (core/device.py).

Defaults reproduce the reference node ctors (file:line on each constructor
below), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver structure.

    model: a registered model name: "unicycle", "steering_unicycle",
        "rate_limited_steering", "full_body" or a user-registered one.
    num_samples: K, rollouts per control step.
    horizon: T, states per rollout; controls have length T-1.
    steer_off: zero the direction control channel after sampling
        (reference src/full_body_mppi.cpp:517).
    """

    model: str = "full_body"
    num_samples: int = 10000
    horizon: int = 15
    steer_off: bool = False

    @property
    def num_controls(self) -> int:
        from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model

        return get_model(self.model).num_controls

    @property
    def num_states(self) -> int:
        from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model

        return get_model(self.model).num_states


@dataclasses.dataclass
class SolverParams:
    """Sampling/update parameters (tensors on the solver's device).

    control_noise: per-dim Gaussian sigma, (U,). lam: softmax temperature.
    u_min / u_max: box bounds per control dim, (U,). noise_beta: temporal
    correlation of the exploration noise in [0, 1); 0 is white noise.
    """

    control_noise: torch.Tensor
    lam: torch.Tensor
    u_min: torch.Tensor
    u_max: torch.Tensor
    noise_beta: torch.Tensor


@dataclasses.dataclass
class CostParams:
    """Cost weights, a superset across the model families. The unicycle and
    steering models read only v_ref, path_weight and v_weight
    (src/diff_drive_mppi.cpp:194-210); the full-body model adds the others
    (src/full_body_mppi.cpp:404-424). The reference's ``roll_off`` flag
    zeroes zmp_weight and roll_v_weight."""

    v_ref: torch.Tensor
    path_weight: torch.Tensor
    v_weight: torch.Tensor
    zmp_weight: torch.Tensor
    roll_v_weight: torch.Tensor
    back_weight: torch.Tensor
    yaw_weight: torch.Tensor


def _t(x, dtype, device):
    """A parameter tensor on ``device`` (None: the card, core/device.py)."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                           device=resolve_device(device))


def make_solver_params(
    control_noise,
    lam,
    u_min,
    u_max,
    noise_beta=0.0,
    dtype=torch.float32,
    device=None,
) -> SolverParams:
    u_min = _t(u_min, dtype, device)
    u_max = _t(u_max, dtype, device)
    noise = _t(control_noise, dtype, device).expand(u_min.shape).clone()
    return SolverParams(
        control_noise=noise,
        lam=_t(lam, dtype, device),
        u_min=u_min,
        u_max=u_max,
        noise_beta=_t(noise_beta, dtype, device),
    )


def make_cost_params(
    v_ref=0.8,
    path_weight=1.0,
    v_weight=1.0,
    zmp_weight=0.0,
    roll_v_weight=0.0,
    back_weight=0.0,
    yaw_weight=0.0,
    roll_off=False,
    dtype=torch.float32,
    device=None,
) -> CostParams:
    if roll_off:  # src/full_body_mppi.cpp:43-46
        zmp_weight = 0.0
        roll_v_weight = 0.0
    return CostParams(
        v_ref=_t(v_ref, dtype, device),
        path_weight=_t(path_weight, dtype, device),
        v_weight=_t(v_weight, dtype, device),
        zmp_weight=_t(zmp_weight, dtype, device),
        roll_v_weight=_t(roll_v_weight, dtype, device),
        back_weight=_t(back_weight, dtype, device),
        yaw_weight=_t(yaw_weight, dtype, device),
    )


_DEG = math.pi / 180.0


def diff_drive_config(
    num_samples: int = 1000,
    horizon: int = 15,
    control_noise: float = 0.5,
    lam: float = 1.0,
    v_max: float = 1.2,
    v_min: float = -1.2,
    w_max: float = 2.0,
    w_min: float = -2.0,
    v_ref: float = 0.8,
    path_weight: float = 1.0,
    v_weight: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[SolverConfig, SolverParams, CostParams]:
    """Defaults of the diff-drive node ctor (src/diff_drive_mppi.cpp:17-34)."""
    cfg = SolverConfig(model="unicycle", num_samples=num_samples, horizon=horizon)
    sp = make_solver_params(control_noise, lam, [v_min, w_min], [v_max, w_max],
                            dtype=dtype, device=device)
    cp = make_cost_params(v_ref=v_ref, path_weight=path_weight,
                          v_weight=v_weight, dtype=dtype, device=device)
    return cfg, sp, cp


def steering_diff_drive_config(
    num_samples: int = 10000,
    horizon: int = 15,
    control_noise: float = 0.5,
    lam: float = 1.0,
    v_max: float = 1.2,
    v_min: float = -1.2,
    w_max: float = 1.0,
    w_min: float = -1.0,
    steer_max: float = 30.0 * _DEG,
    steer_min: float = -30.0 * _DEG,
    v_ref: float = 0.8,
    path_weight: float = 1.0,
    v_weight: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[SolverConfig, SolverParams, CostParams]:
    """Defaults of the steering node ctor (src/steering_diff_drive_mppi.cpp:18-36)."""
    cfg = SolverConfig(model="steering_unicycle", num_samples=num_samples,
                       horizon=horizon)
    sp = make_solver_params(control_noise, lam, [v_min, w_min, steer_min],
                            [v_max, w_max, steer_max], dtype=dtype, device=device)
    cp = make_cost_params(v_ref=v_ref, path_weight=path_weight,
                          v_weight=v_weight, dtype=dtype, device=device)
    return cfg, sp, cp


def rate_limited_steering_config(
    num_samples: int = 10000,
    horizon: int = 15,
    control_noise: float = 0.5,
    lam: float = 1.0,
    v_max: float = 1.2,
    v_min: float = -1.2,
    w_max: float = 1.0,
    w_min: float = -1.0,
    steer_rate_max: float = 2.6,
    v_ref: float = 0.8,
    path_weight: float = 1.0,
    v_weight: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[SolverConfig, SolverParams, CostParams]:
    """The steering family with the steering angle as a state and its rate as
    the control (models/rate_limited_steering.py); not in the reference."""
    cfg = SolverConfig(model="rate_limited_steering", num_samples=num_samples,
                       horizon=horizon)
    sp = make_solver_params(control_noise, lam, [v_min, w_min, -steer_rate_max],
                            [v_max, w_max, steer_rate_max], dtype=dtype,
                            device=device)
    cp = make_cost_params(v_ref=v_ref, path_weight=path_weight,
                          v_weight=v_weight, dtype=dtype, device=device)
    return cfg, sp, cp


def full_body_config(
    num_samples: int = 10000,
    horizon: int = 15,
    control_noise: float = 0.5,
    lam: float = 1.0,
    v_max: float = 1.2,
    v_min: float = -3.0,
    w_max: float = 1.0,
    w_min: float = -1.0,
    steer_max: float = 30.0 * _DEG,
    steer_min: float = -30.0 * _DEG,
    roll_v_max: float = 30.0 * _DEG,
    roll_v_min: float = -30.0 * _DEG,
    pitch_v_max: float = 15.0 * _DEG,
    pitch_v_min: float = -15.0 * _DEG,
    v_ref: float = 1.2,
    path_weight: float = 1.0,
    v_weight: float = 1.0,
    zmp_weight: float = 1.0,
    roll_v_weight: float = 1.0,
    back_weight: float = 1.0,
    yaw_weight: float = 1.0,
    roll_off: bool = False,
    steer_off: bool = False,
    dtype=torch.float32,
    device=None,
) -> Tuple[SolverConfig, SolverParams, CostParams]:
    """Defaults of the full-body node ctor (src/full_body_mppi.cpp:8-46)."""
    cfg = SolverConfig(
        model="full_body",
        num_samples=num_samples,
        horizon=horizon,
        steer_off=steer_off,
    )
    sp = make_solver_params(
        control_noise,
        lam,
        [v_min, w_min, steer_min, roll_v_min, pitch_v_min],
        [v_max, w_max, steer_max, roll_v_max, pitch_v_max],
        dtype=dtype,
        device=device,
    )
    cp = make_cost_params(
        v_ref=v_ref,
        path_weight=path_weight,
        v_weight=v_weight,
        zmp_weight=zmp_weight,
        roll_v_weight=roll_v_weight,
        back_weight=back_weight,
        yaw_weight=yaw_weight,
        roll_off=roll_off,
        dtype=dtype,
        device=device,
    )
    return cfg, sp, cp
