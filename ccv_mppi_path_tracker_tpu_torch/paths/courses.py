"""Course generators (NumPy), carried from the JAX package's
``paths/courses.py``: that package's ``paths/__init__.py`` imports jax, so
this port keeps its own copy. Each returns an (N, 2) array of world-frame
points; feed it to :meth:`PathBuffer.from_points`.

- :func:`sum_of_cosines_course` — the sinusoid course of
  ``reference_path_creator`` (src/reference_path_creator.cpp:37-56).
- :func:`circle_course` — its circle branch (:57-68). The reference's
  parameter step ``resolution_/2*M_PI*R_`` parses as ``(resolution/2)*pi*R``
  radians, a radius-proportional angular step; the default here is a
  constant arc-length step (resolution/R radians) and ``legacy_step=True``
  keeps the quirk.
- :func:`waypoint_course` / :func:`dkan_course` — the piecewise-linear
  corridor course of ``dkan_path_creator`` (src/dkan_path_creator.cpp:11-52).
- :func:`filtered_square_course` — the Butterworth-low-passed square wave of
  src/reference_path_creator.py:34-47.
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


def circle_course(
    radius: float = 10.0,
    resolution: float = 0.1,
    init_x: float = 0.0,
    init_y: float = 0.0,
    turns: float = 1.0,
    legacy_step: bool = False,
    dtype=np.float64,
):
    """Circle course. As in the reference, the center sits at
    (init_x, init_y + R), so the course starts at (init_x + R, init_y + R)
    (src/reference_path_creator.cpp:62-63)."""
    if legacy_step:
        step = resolution / 2.0 * math.pi * radius  # the quirk, see above
        end = 200.0 * math.pi
    else:
        step = resolution / radius  # constant arc length
        end = 2.0 * math.pi * turns
    s = np.arange(0.0, end + step * 0.5, step, dtype=dtype)
    x = init_x + radius * np.cos(s)
    y = init_y + radius * np.sin(s) + radius
    return np.stack([x, y], axis=-1)


def waypoint_course(waypoints, resolution: float = 0.1, dtype=np.float64):
    """Straight segments between consecutive waypoints, sampled every
    ``resolution`` (add_pose_to_path, src/dkan_path_creator.cpp:37-52). Each
    segment contributes points at s = 0, resolution, ... strictly below its
    length, as the reference samples."""
    waypoints = np.asarray(waypoints, dtype=dtype)
    pts = []
    for p1, p2 in zip(waypoints[:-1], waypoints[1:]):
        d = p2 - p1
        length = float(np.hypot(d[0], d[1]))
        s = np.arange(0.0, length, resolution, dtype=dtype)
        pts.append(p1 + s[:, None] * (d / length))
    return np.concatenate(pts, axis=0)


def dkan_course(resolution: float = 0.1, dtype=np.float64):
    """The hard-coded building-corridor course (src/dkan_path_creator.cpp:11-35)."""
    return waypoint_course(
        [[0.0, 0.0], [17.7, 0.0], [17.7, 8.0], [0.0, 8.0]],
        resolution=resolution,
        dtype=dtype,
    )


def filtered_square_course(
    length: float = 20.0,
    amplitude: float = 2.0,
    wave_hz: float = 1.0,
    fs: float = 1000.0,
    cutoff: float = 1.0,
    order: int = 6,
    dtype=np.float64,
):
    """Low-pass-filtered square wave, a smoothed slalom
    (src/reference_path_creator.py:34-47)."""
    from scipy.signal import butter, lfilter, square

    t = np.linspace(0.0, length, int(length * fs), endpoint=False)
    wave = amplitude * square(2.0 * math.pi * wave_hz * t)
    nyq = 0.5 * fs
    b, a = butter(order, cutoff / nyq, btype="low", analog=False)
    y = lfilter(b, a, wave)
    n = len(y)
    x = np.arange(n, dtype=dtype) * (length / n)
    return np.stack([x, y.astype(dtype)], axis=-1)
