"""Tracking-quality evaluation (NumPy), carried from the JAX package's
``metrics/tracking.py``: that package's ``metrics/__init__.py`` imports jax.

Same semantics as the reference's offline evaluator
(src/calc_e_rmse.py:29-49): for every robot position, the distance to the
nearest point of the full global path; max error, RMSE and completion time.
"""

from __future__ import annotations

import numpy as np


def nearest_point_errors(robot_xy: np.ndarray, path_xy: np.ndarray) -> np.ndarray:
    """Per-sample nearest-point distance (find_closest_point,
    src/calc_e_rmse.py:30-32). Chunked so huge logs stay in cache."""
    robot_xy = np.asarray(robot_xy, np.float64)
    path_xy = np.asarray(path_xy, np.float64)
    out = np.empty(len(robot_xy))
    chunk = max(1, 2_000_000 // max(len(path_xy), 1))
    for i in range(0, len(robot_xy), chunk):
        d = np.linalg.norm(
            robot_xy[i : i + chunk, None, :] - path_xy[None, :, :], axis=-1
        )
        out[i : i + chunk] = d.min(axis=1)
    return out


def tracking_metrics(robot_xy, path_xy, dt: float = 0.1) -> dict:
    """Max Error + RMSE + Time (src/calc_e_rmse.py:36-49)."""
    errors = nearest_point_errors(robot_xy, path_xy)
    return {
        "time": float((len(robot_xy) - 1) * dt),
        "max_error": float(errors.max()),
        "rmse": float(np.sqrt(np.mean(np.square(errors)))),
        "errors": errors,
    }
