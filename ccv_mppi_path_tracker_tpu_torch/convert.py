"""Carry parameters from the JAX package into this port.

:func:`from_numpy` takes the JAX package's SolverParams, CostParams,
FullBodyParams, warm start and PathBuffer as plain NumPy data (the objects
themselves after ``np.asarray`` of each field, or dicts of field name to
array) and returns this port's dataclasses on one device and dtype, so both
packages compute on identical parameters. A fleet's warm start (B, T-1, U)
and a stacked per-robot PathBuffer (xy (B, N, 2), num_valid (B,)) carry over
with their robot axis. :func:`learned_from_numpy` carries the learned and
identified parameters (ControlGains, SamplerNet, UpdateRule, FullBodyParams)
the same way. Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverParams
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer


def _fields(obj, cls):
    if dataclasses.is_dataclass(cls):
        names = [f.name for f in dataclasses.fields(cls)]
    else:  # an nn.Module built from its parameters, e.g. SamplerNet(w1, b1, w2, b2)
        names = list(inspect.signature(cls).parameters)
    if isinstance(obj, dict):
        return {n: obj[n] for n in names}
    return {n: getattr(obj, n) for n in names}


def _tensors(obj, cls, dtype, device):
    return cls(**{
        n: torch.as_tensor(np.asarray(v), device=device).to(dtype)
        for n, v in _fields(obj, cls).items()
    })


def learned_from_numpy(cls, obj, device=None, dtype=torch.float32):
    """``cls`` (ControlGains, SamplerNet, UpdateRule or FullBodyParams of
    this port) built from ``obj``: the JAX package's object of that name, or a
    dict of field name to array."""
    return _tensors(obj, cls, dtype, device)


def from_numpy(sp, cp, model_params, u_prev, path, device=None, dtype=torch.float32):
    """Returns (SolverParams, CostParams, FullBodyParams, u_prev, PathBuffer)
    of this port. ``model_params`` may be None (then None is returned)."""
    mp = None
    if model_params is not None:
        mp = _tensors(model_params, FullBodyParams, dtype, device)
    p = path if isinstance(path, dict) else vars(path)
    num_valid = np.asarray(p["num_valid"])
    return (
        _tensors(sp, SolverParams, dtype, device),
        _tensors(cp, CostParams, dtype, device),
        mp,
        torch.as_tensor(np.asarray(u_prev), device=device).to(dtype),
        PathBuffer(
            xy=torch.as_tensor(np.asarray(p["xy"]), device=device).to(dtype),
            num_valid=(int(num_valid) if num_valid.ndim == 0 else
                       torch.as_tensor(num_valid, dtype=torch.int64, device=device)),
            resolution=torch.as_tensor(np.asarray(p["resolution"]),
                                       device=device).to(dtype),
        ),
    )
