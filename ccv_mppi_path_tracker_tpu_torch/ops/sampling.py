"""Gaussian control-perturbation sampling (port of ``ops/sampling.py``).

Samples are centered on the previous optimal sequence (no one-step shift,
src/diff_drive_mppi.cpp:89-90), clamped to the box afterwards (:98-99), and
``steer_off`` zeroes control channel 2, the direction or steer channel
(src/full_body_mppi.cpp:517), of any model that has one.
Layout is time-major (T-1, K, U).
"""

from __future__ import annotations

from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import SolverParams

# Control-channel index of the "direction" input of the full-body model.
STEER_DIM = 2


def color_noise(white, beta):
    """eps_t = b*eps_{t-1} + sqrt(1-b^2)*eta_t over the horizon (axis 0),
    eps_0 = eta_0. ``beta`` may be a tensor on the device: the recurrence
    always runs, so no branch reads it back to the host. At b = 0 every
    step is 0*eps + 1*eta, which is eta bit for bit: white noise is the
    exact identity, as in the JAX package."""
    scale = torch.sqrt(1.0 - beta * beta)
    rows = [white[0]]
    for t in range(1, white.shape[0]):
        rows.append(beta * rows[-1] + scale * white[t])
    return torch.stack(rows)


def sample_controls(
    u_prev: torch.Tensor,
    params: SolverParams,
    num_samples: int,
    steer_off: bool = False,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Draw K clamped-Gaussian control sequences, (T-1, K, U).

    u_prev: (T-1, U) sampling mean. noise: optional standard normals of
    shape (T-1, K, U) (the parity tests inject the same tensor into every
    implementation); otherwise they are drawn from ``generator``.
    """
    tm1, u_dim = u_prev.shape
    if noise is None:
        if generator is None:
            raise ValueError("sample_controls needs noise or a generator")
        noise = torch.randn((tm1, num_samples, u_dim), generator=generator,
                            dtype=u_prev.dtype, device=u_prev.device)
    noise = color_noise(noise, params.noise_beta)
    u = u_prev[:, None, :] + noise * params.control_noise
    u = torch.clamp(u, params.u_min, params.u_max)
    if steer_off and u_dim > STEER_DIM:  # no such channel: nothing to zero
        u[..., STEER_DIM] = 0.0
    return u
