"""CSV experiment recording (port of ``metrics/recorder.py``).

Replaces the reference's side-car recorder node (src/record_state.py): one
row per control cycle with the same column layout (:126), and the full
reference path appended on close (:112-115) so the offline evaluator can
recover it from the same file. The file layout is the JAX package's.
"""

from __future__ import annotations

import csv
import datetime
import os
from typing import Optional

import numpy as np

# Column layout of the reference recorder (src/record_state.py:126).
COLUMNS = [
    "time", "x", "y", "omega", "yaw", "x_tf", "y_tf", "v", "cmd_v",
    "steer_r", "steer_l", "roll", "true_zmp", "zmp_y", "path_x", "path_y",
]
# Debug-recorder variants (src/record_for_debug.py:99,
# src/full_body_mppi_record_for_debug.py:110).
DEBUG_COLUMNS = [
    "time", "x", "y", "yaw", "v", "cmd_v", "pitch", "accel", "path_x", "path_y",
]
FULL_BODY_DEBUG_COLUMNS = ["time", "zmp_y", "roll", "drive_accel"]


class Recorder:
    """Writes ``<log_dir>/<method>/<stamp>.csv`` (stamp: the start time)."""

    def __init__(
        self,
        log_dir: str,
        method: str = "mppi",
        stamp: Optional[str] = None,
        columns=None,
    ):
        os.makedirs(os.path.join(log_dir, method), exist_ok=True)
        if stamp is None:
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.path = os.path.join(log_dir, method, stamp + ".csv")
        self.columns = list(columns) if columns is not None else COLUMNS
        self._f = open(self.path, "w", newline="")
        self._w = csv.writer(self._f)
        self._w.writerow(self.columns)

    def write_row(self, values):
        """Generic row writer for custom column layouts."""
        self._w.writerow(list(values))

    def write_cycle(self, t, state, cmd, true_v=None, true_zmp=0.0, zmp_y=0.0):
        """state: (S,) plant state; cmd: a WheelSteerCommand
        (solver/command.py). Reads each value back with float()."""
        x, y, yaw = float(state[0]), float(state[1]), float(state[2])
        self._w.writerow(
            [
                t, x, y, float(cmd.w), yaw, x, y,
                float(true_v if true_v is not None else cmd.v), float(cmd.v),
                float(cmd.steer_r), float(cmd.steer_l), float(cmd.roll),
                float(true_zmp), float(zmp_y), "", "",
            ]
        )

    def close(self, course=None):
        if course is not None:
            for px, py in np.asarray(course):
                self._w.writerow([""] * 14 + [px, py])
        self._f.close()


def read_log(path: str) -> dict:
    """Load a recorded CSV back into arrays (robot rows + appended course)."""
    rows, course = [], []
    with open(path) as f:
        r = csv.reader(f)
        header = next(r)
        for row in r:
            if row[0] == "":
                course.append([float(row[14]), float(row[15])])
            else:
                rows.append([float(v) if v != "" else np.nan for v in row[:14]])
    return {
        "header": header[:14],
        "data": np.asarray(rows),
        "course": np.asarray(course) if course else None,
    }
