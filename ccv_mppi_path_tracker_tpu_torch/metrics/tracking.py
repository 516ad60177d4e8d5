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


def curvature(path_xy: np.ndarray) -> np.ndarray:
    """Signed curvature along a course (offline analysis parity with
    src/calc_curveture.py). Finite-difference form; endpoints are zero."""
    p = np.asarray(path_xy, np.float64)
    d1 = np.gradient(p, axis=0)
    d2 = np.gradient(d1, axis=0)
    num = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    den = (d1[:, 0] ** 2 + d1[:, 1] ** 2) ** 1.5
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.where(den > 0, num / den, 0.0)
    return k
