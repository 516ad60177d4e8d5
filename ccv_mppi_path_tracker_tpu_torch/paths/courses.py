"""Course generators (NumPy), carried from the JAX package's
``paths/courses.py``: that package's ``paths/__init__.py`` imports jax, so
this port keeps its own copy of the generator the slice needs.

:func:`sum_of_cosines_course` is the sinusoid course of
``reference_path_creator`` (src/reference_path_creator.cpp:37-56).
"""

from __future__ import annotations

import math

import numpy as np


def sum_of_cosines_course(
    amplitudes=(1.0, 0.0, 0.0),
    frequencies=(0.25, 0.0, 0.0),
    deltas=(1.57, 1.57, 1.57),
    resolution: float = 0.1,
    course_length: float = 10.0,
    init_x: float = 0.0,
    init_y: float = 0.0,
    dtype=np.float64,
):
    """y(s) = sum_k A_k cos(2 pi f_k s + delta_k) + init_y - sum_k A_k.
    Returns an (N, 2) array of points sampled every ``resolution``."""
    s = np.arange(0.0, course_length, resolution, dtype=dtype)
    x = init_x + s
    y = np.full_like(s, init_y - float(np.sum(amplitudes)))
    for a, f, d in zip(amplitudes, frequencies, deltas):
        y = y + a * np.cos(2.0 * math.pi * f * s + d)
    return np.stack([x, y], axis=-1)
