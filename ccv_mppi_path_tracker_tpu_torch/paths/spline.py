"""Natural cubic spline path smoothing (NumPy), carried from the JAX
package's ``paths/spline.py``.

The reference ships a cubic-spline header (include/ccv_mppi_path_tracker/
spline.h: tridiagonal solve and binary-search evaluation) that its
controllers include but never instantiate. Here it resamples a sparse
waypoint course into a smooth dense path before it enters the PathBuffer.
"""

from __future__ import annotations

import numpy as np


class CubicSpline:
    """Natural cubic spline y(x) through knots (x strictly increasing)."""

    def __init__(self, x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n = len(x)
        if n < 2 or not np.all(np.diff(x) > 0):
            raise ValueError("need at least 2 knots with strictly increasing x")
        h = np.diff(x)
        # second derivatives m with the natural boundary m[0] = m[-1] = 0:
        # h[i-1] m[i-1] + 2 (h[i-1] + h[i]) m[i] + h[i] m[i+1]
        #     = 6 ((y[i+1] - y[i]) / h[i] - (y[i] - y[i-1]) / h[i-1])
        m = np.zeros(n)
        if n > 2:
            a = h[:-1].copy()
            b = 2.0 * (h[:-1] + h[1:])
            c = h[1:].copy()
            d = 6.0 * (np.diff(y[1:]) / h[1:] - np.diff(y[:-1]) / h[:-1])
            # Thomas algorithm
            for i in range(1, len(b)):
                w = a[i] / b[i - 1]
                b[i] -= w * c[i - 1]
                d[i] -= w * d[i - 1]
            sol = np.zeros_like(d)
            sol[-1] = d[-1] / b[-1]
            for i in range(len(b) - 2, -1, -1):
                sol[i] = (d[i] - c[i] * sol[i + 1]) / b[i]
            m[1:-1] = sol
        self.x, self.y, self.h, self.m = x, y, h, m

    def __call__(self, t):
        t = np.asarray(t, np.float64)
        j = np.clip(np.searchsorted(self.x, t, side="right") - 1, 0, len(self.x) - 2)
        x0, x1 = self.x[j], self.x[j + 1]
        h = self.h[j]
        m0, m1 = self.m[j], self.m[j + 1]
        y0, y1 = self.y[j], self.y[j + 1]
        a = (x1 - t) / h
        b = (t - x0) / h
        return a * y0 + b * y1 + ((a**3 - a) * m0 + (b**3 - b) * m1) * (h * h) / 6.0


def spline_resample_course(points, resolution: float, dtype=np.float64):
    """A sparse waypoint course resampled into a smooth dense path: x(s) and
    y(s) are natural splines over the cumulative chord length s, evaluated
    every ``resolution`` meters."""
    points = np.asarray(points, np.float64)
    chord = np.concatenate([[0.0], np.cumsum(np.hypot(*np.diff(points, axis=0).T))])
    sx = CubicSpline(chord, points[:, 0])
    sy = CubicSpline(chord, points[:, 1])
    s = np.arange(0.0, chord[-1], resolution)
    return np.stack([sx(s), sy(s)], axis=-1).astype(dtype)
