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
from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals

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


def draw_standard_normals(key: Optional[torch.Tensor], seed: Optional[int],
                          step: Optional[int], shape, robot: int = 0,
                          first_sample: int = 0, dtype=torch.float32, device=None):
    """The eager arm's exploration noise: standard normals of ``shape``, (T-1,
    K, U) for robot ``robot``, or (B, T-1, K, U) for robots robot ...
    robot+B-1: the fused kernel's RNG-mode stream (core/random.py), sample
    k at counter first_sample + k. The counterpart of the JAX package's
    ``draw_standard_normals`` (the cycle's key in, the step's normals out).

    The key is ``key``, a (2,) int64 tensor [seed, step] on the device of the
    draw (``ControllerState.key``: a CUDA graph's replay then draws anew),
    or, with ``key`` None, the host integers ``seed`` and ``step`` on
    ``device``. On a CUDA device the CUDA kernel draws
    (kernels/rollout_cost.py philox_normals_cuda) or the call raises; on the
    CPU its plain version does (core/random.py philox_normals)."""
    if key is not None:
        device = key.device
    device = torch.device(device if device is not None else "cuda")
    *lead, tm1, num_samples, u_dim = shape
    robots = lead[0] if lead else 1
    if len(lead) > 1:
        raise ValueError(f"shape must be (T-1, K, U) or (B, T-1, K, U), got {tuple(shape)}")
    if device.type == "cpu":
        if key is not None:
            seed, step = key.tolist()  # host integers: fewer ops than 0-d tensors
        rob = robot + torch.arange(robots) if lead else robot
        return philox_normals(seed, step, num_samples, tm1, u_dim, robot=rob, device=device,
                              dtype=dtype, first_sample=first_sample)
    from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import philox_normals_cuda

    out = philox_normals_cuda(key, seed, step, num_samples=num_samples, tm1=tm1,
                              u_dim=u_dim, robots=robots, robot_base=robot,
                              first_sample=first_sample, device=device)
    return (out if lead else out[0]).to(dtype)


def sample_controls(
    u_prev: torch.Tensor,
    params: SolverParams,
    num_samples: int,
    steer_off: bool = False,
    noise: Optional[torch.Tensor] = None,
):
    """Draw K clamped-Gaussian control sequences, (T-1, K, U), from the
    standard normals ``noise`` (T-1, K, U): the eager step's draw
    (:func:`draw_standard_normals`), or a tensor that the parity tests
    inject into every implementation.

    u_prev: (T-1, U) sampling mean.
    """
    if noise is None:
        raise ValueError("sample_controls needs the standard normals, noise "
                         "(draw_standard_normals draws the step's)")
    noise = color_noise(noise, params.noise_beta)
    u = u_prev[:, None, :] + noise * params.control_noise
    u = torch.clamp(u, params.u_min, params.u_max)
    if steer_off and u_prev.shape[1] > STEER_DIM:  # no such channel: nothing to zero
        u[..., STEER_DIM] = 0.0
    return u
