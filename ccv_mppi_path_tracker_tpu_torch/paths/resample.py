"""Global-path buffer and horizon resampling (port of ``paths/resample.py``).

Replaces the reference's ``get_CurrentIndex``/``calc_RefPath``
(src/diff_drive_mppi.cpp:126-181). The resampling runs on the path's device
with no host round-trip; :func:`resample_references` does it for a fleet in
one batched pass, on one shared path or on a path per robot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.ops.mindist import DIST_CAP


@dataclasses.dataclass
class PathBuffer:
    """A global reference path.

    xy: (N_max, 2) points; entries beyond num_valid are padding (copies of
        the last valid point).
    num_valid: number of valid points.
    resolution: () tensor, arc-length spacing the course was sampled at
        (the reference's ``resolution`` param, src/diff_drive_mppi.cpp:29).
        A tensor, so the index step below is a true division on the device.

    A fleet's per-robot paths (:meth:`stack`) carry a leading robot axis:
    xy (B, N_max, 2), num_valid a (B,) int64 tensor, resolution (B,).
    """

    xy: torch.Tensor
    num_valid: int | torch.Tensor
    resolution: torch.Tensor

    @staticmethod
    def from_points(points, resolution, capacity=None, dtype=torch.float32,
                    device=None):
        """The (N, 2) ``points`` padded to ``capacity``, on ``device``
        (None: the card, core/device.py)."""
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        device = resolve_device(device)
        points = np.asarray(points, dtype=np_dtype)
        n = points.shape[0]
        if capacity is None:
            capacity = n
        if not (capacity >= n >= 2):
            raise ValueError(f"need 2 <= num points {n} <= capacity {capacity}")
        pad = np.repeat(points[-1:], capacity - n, axis=0)
        return PathBuffer(
            xy=torch.as_tensor(np.concatenate([points, pad], axis=0),
                               device=device),
            num_valid=n,
            resolution=torch.as_tensor(np.asarray(resolution, np_dtype),
                                       device=device),
        )

    @staticmethod
    def stack(paths):
        """Per-robot paths of one capacity stacked along a leading robot
        axis (the JAX package stacks PathBuffer pytrees the same way)."""
        xy = torch.stack([p.xy for p in paths])
        return PathBuffer(
            xy=xy,
            num_valid=torch.as_tensor([int(p.num_valid) for p in paths],
                                      dtype=torch.int64, device=xy.device),
            resolution=torch.stack([p.resolution for p in paths]),
        )


def nearest_index(path: PathBuffer, pos):
    """Index of the nearest valid path point to ``pos`` (get_CurrentIndex,
    src/diff_drive_mppi.cpp:126-140). Reference quirk kept: the search
    starts from min_distance = 100 m, so if every point is farther than
    100 m the index is 0."""
    diff = path.xy - pos
    d2 = torch.sum(diff * diff, dim=-1)
    idx = torch.arange(d2.shape[0], device=d2.device)
    d2 = torch.where(idx < path.num_valid, d2, torch.inf)
    # min with its (first) index in one reduction: indexing d2 with a 0-d
    # device tensor would read the index back to the host
    d2_min, best = torch.min(d2, dim=0)
    return torch.where(d2_min < DIST_CAP * DIST_CAP, best, 0)


def resample_reference(path: PathBuffer, pos, v_ref, dt, horizon: int) -> RefWindow:
    """Horizon-length local reference (calc_RefPath,
    src/diff_drive_mppi.cpp:156-181).

    Index i maps to path point ``current + floor(i * v_ref*dt/resolution)``
    (the C++ truncates on int assignment, :160-163), clamped to the last
    valid point. yaw[i] is the heading of segment i -> i+1; the final entry
    repeats its neighbor's.
    """
    cur = nearest_index(path, pos)
    step = v_ref * dt / path.resolution
    offs = torch.floor(
        torch.arange(horizon, dtype=path.xy.dtype, device=path.xy.device) * step
    ).to(torch.int64)
    idx = torch.clamp(cur + offs, max=path.num_valid - 1)
    xy = path.xy[idx]
    seg = xy[1:] - xy[:-1]
    yaw = torch.atan2(seg[:, 1], seg[:, 0])
    yaw = torch.cat([yaw, yaw[-1:]])
    return RefWindow(xy=xy, yaw=yaw)


def resample_references(path: PathBuffer, pos, v_ref, dt, horizon: int) -> RefWindow:
    """:func:`resample_reference` for B robots at ``pos`` (B, 2), in one
    batched pass (``torch.func.vmap``: no loop over robots, no host read).
    ``path`` is one path shared by the fleet (xy (N, 2)) or a path per robot
    (xy (B, N, 2), from :meth:`PathBuffer.stack`). Returns xy (B, T, 2) and
    yaw (B, T)."""
    dims = 0 if path.xy.dim() == 3 else None

    def one(xy, num_valid, resolution, p):
        ref = resample_reference(PathBuffer(xy, num_valid, resolution), p, v_ref, dt,
                                 horizon)
        return ref.xy, ref.yaw

    xy, yaw = torch.func.vmap(one, in_dims=(dims, dims, dims, 0))(
        path.xy, path.num_valid, path.resolution, pos)
    return RefWindow(xy=xy, yaw=yaw)
