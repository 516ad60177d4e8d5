"""Named experiment presets: the reference's launch-file operating points
(port of ``core/presets.py``). Each returns (cfg, sp, cp, course), the course
a NumPy (N, 2) array and the parameters on ``device`` (None: the card,
core/device.py).

- :func:`diff_drive_launch`: launch/diff_drive_mppi.launch:6-17 (path_weight
  10, v_ref 1.2, v_max 2.0; sine course A=1.0, f=0.25, delta=0).
- :func:`steering_launch`: launch/steering_diff_drive_mppi.launch:7-28 (K=1000
  override, same weights and course).
- :func:`full_body_launch`: launch/full_body_mppi.launch:7-22,29-31 (v_ref
  2.0, path 10, zmp 10, roll_v 0.5, yaw 2, back 1, roll_off true; course
  A=1.5, f=0.127, delta=0).
- :func:`rate_limited_launch`: the rate-limited steering family (not in the
  reference) on the diff-drive course.
- :func:`autorally_nn_launch`: AutoRally's learned network model
  (models/autorally_nn.py) on the full-body course: steering and throttle in
  [-1, 1], sigma 0.3, lambda 1, v_ref 2.0, path 10, speed 1.
- :func:`pets_pe_launch`: PETS's probabilistic ensemble (models/pets_pe.py)
  at K=5120 sequences of 20 particles, on the same course under the same
  box, noise, temperature and cost.
"""

from __future__ import annotations

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import (
    SolverConfig,
    diff_drive_config,
    full_body_config,
    make_cost_params,
    make_solver_params,
    rate_limited_steering_config,
    steering_diff_drive_config,
)
from ccv_mppi_path_tracker_tpu_torch.paths.courses import sum_of_cosines_course


def _course(amplitude, frequency, length, dtype):
    return sum_of_cosines_course(
        amplitudes=(amplitude, 0.0, 0.0),
        frequencies=(frequency, 0.0, 0.0),
        deltas=(0.0, 0.0, 0.0),
        resolution=0.1,
        course_length=length,
        dtype=np.float64 if dtype == torch.float64 else np.float32,
    )


def diff_drive_launch(num_samples=1000, horizon=15, dtype=torch.float32, device=None):
    cfg, sp, cp = diff_drive_config(
        num_samples=num_samples, horizon=horizon, path_weight=10.0,
        v_weight=1.0, v_ref=1.2, v_max=2.0, dtype=dtype, device=device,
    )
    return cfg, sp, cp, _course(1.0, 0.25, 10.0, dtype)


def steering_launch(num_samples=1000, horizon=15, dtype=torch.float32, device=None):
    cfg, sp, cp = steering_diff_drive_config(
        num_samples=num_samples, horizon=horizon, path_weight=10.0,
        v_weight=1.0, v_ref=1.2, v_max=2.0, dtype=dtype, device=device,
    )
    return cfg, sp, cp, _course(1.0, 0.25, 10.0, dtype)


def full_body_launch(num_samples=10000, horizon=15, dtype=torch.float32,
                     roll_off=True, device=None):
    cfg, sp, cp = full_body_config(
        num_samples=num_samples,
        horizon=horizon,
        v_ref=2.0,
        v_max=2.0,
        path_weight=10.0,
        v_weight=1.0,
        zmp_weight=10.0,
        roll_v_weight=0.5,
        back_weight=1.0,
        yaw_weight=2.0,
        roll_off=roll_off,
        dtype=dtype,
        device=device,
    )
    return cfg, sp, cp, _course(1.5, 0.127, 20.0, dtype)


def rate_limited_launch(num_samples=10000, horizon=15, dtype=torch.float32,
                        device=None):
    cfg, sp, cp = rate_limited_steering_config(
        num_samples=num_samples, horizon=horizon, path_weight=10.0,
        dtype=dtype, device=device,
    )
    return cfg, sp, cp, _course(1.0, 0.25, 10.0, dtype)


def autorally_nn_launch(num_samples=102400, horizon=30, dtype=torch.float32, device=None):
    """The AutoRally network model at the project's target K and T on the
    flagship's course (sum of cosines, A=1.5, f=0.127, 20 m): the box of the
    normalised chassis commands, sigma (0.3, 0.3), lambda 1, and the tracking
    cost with v_ref 2.0, path weight 10 and speed weight 1."""
    cfg = SolverConfig(model="autorally_nn", num_samples=num_samples, horizon=horizon)
    sp = make_solver_params([0.3, 0.3], 1.0, [-1.0, -1.0], [1.0, 1.0], dtype=dtype,
                            device=device)
    cp = make_cost_params(v_ref=2.0, path_weight=10.0, v_weight=1.0, dtype=dtype,
                          device=device)
    return cfg, sp, cp, _course(1.5, 0.127, 20.0, dtype)


def pets_pe_launch(num_samples=5120, horizon=30, dtype=torch.float32, device=None):
    """PETS's probabilistic ensemble at K=5120 sequences (K·P = 102400
    particle rollouts, the project's target count) and T=30, with
    :func:`autorally_nn_launch`'s course, box, sigma, lambda and cost."""
    cfg = SolverConfig(model="pets_pe", num_samples=num_samples, horizon=horizon)
    sp = make_solver_params([0.3, 0.3], 1.0, [-1.0, -1.0], [1.0, 1.0], dtype=dtype,
                            device=device)
    cp = make_cost_params(v_ref=2.0, path_weight=10.0, v_weight=1.0, dtype=dtype,
                          device=device)
    return cfg, sp, cp, _course(1.5, 0.127, 20.0, dtype)


PRESETS = {
    "diff_drive": diff_drive_launch,
    "steering_diff_drive": steering_launch,
    "full_body": full_body_launch,
    "rate_limited_steering": rate_limited_launch,
}
