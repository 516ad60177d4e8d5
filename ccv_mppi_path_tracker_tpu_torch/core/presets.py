"""Named experiment presets (port of ``core/presets.py``).

:func:`full_body_launch` is the operating point of
launch/full_body_mppi.launch:7-22,29-31 (v_ref 2.0, path 10, zmp 10,
roll_v 0.5, yaw 2, back 1, roll_off true; course A=1.5, f=0.127, delta=0).
"""

from __future__ import annotations

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import full_body_config
from ccv_mppi_path_tracker_tpu_torch.paths.courses import sum_of_cosines_course


def _course(amplitude, frequency, length, dtype):
    return sum_of_cosines_course(
        amplitudes=(amplitude, 0.0, 0.0),
        frequencies=(frequency, 0.0, 0.0),
        deltas=(0.0, 0.0, 0.0),
        resolution=0.1,
        course_length=length,
        dtype=dtype,
    )


def full_body_launch(num_samples=10000, horizon=15, dtype=torch.float32,
                     roll_off=True, device=None):
    """Returns (cfg, sp, cp, course); the course is a NumPy (N, 2) array."""
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
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return cfg, sp, cp, _course(1.5, 0.127, 20.0, np_dtype)


PRESETS = {"full_body": full_body_launch}
