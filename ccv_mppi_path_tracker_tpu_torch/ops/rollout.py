"""Batched trajectory rollout (port of ``ops/rollout.py``)."""

from __future__ import annotations

import torch


def rollout(step_fn, state0: torch.Tensor, controls: torch.Tensor, dt):
    """Integrate ``controls`` (T-1, ..., U) from ``state0`` (..., S) with the
    sequential Euler recurrence. Returns states (T, ..., S), state0 first."""
    states = [state0]
    for u in controls:
        states.append(step_fn(states[-1], u, dt))
    return torch.stack(states)


def rollout_closed_form(model_name: str, state0: torch.Tensor,
                        controls: torch.Tensor, dt):
    """Scan-free full-body rollout via prefix sums: yaw_t = yaw_0 +
    dt*sum_{s<t} w_s, heading_t = yaw_t + direction_t, x_t = x_0 +
    dt*sum_{s<t} v_s cos(heading_s), likewise y; roll/pitch are plain
    control integrals. Agrees with :func:`rollout` to round-off.

    The prefix sums are ``torch.cumsum``: the JAX package's tril matmul at
    HIGHEST precision would, as a float32 matmul allowed to use TF32, lose
    the parity this path is tested at.

    state0: (..., S); controls: (T-1, ..., U). Returns (T, ..., S).
    """
    if model_name != "full_body":
        raise ValueError(f"closed-form rollout is ported for full_body only, "
                         f"not {model_name!r}")

    def integrate(rate):
        run = torch.cumsum(rate, dim=0) * dt
        return torch.cat([torch.zeros_like(run[:1]), run], dim=0)

    v, w = controls[..., 0], controls[..., 1]
    yaw = state0[..., 2] + integrate(w)
    heading = yaw[:-1] + controls[..., 2]
    x = state0[..., 0] + integrate(v * torch.cos(heading))
    y = state0[..., 1] + integrate(v * torch.sin(heading))
    roll = state0[..., 3] + integrate(controls[..., 3])
    pitch = state0[..., 4] + integrate(controls[..., 4])
    return torch.stack([x, y, yaw, roll, pitch], dim=-1)
