"""Checkpoint / resume (port of ``runtime/checkpoint.py``), in the port's
own ``.npz`` format.

The reference has no persistence; the controller state that matters is
tiny: the warm-start sequence ``u_prev``, the run's integer ``seed`` and the
cycle counter ``step`` (with the seed, the step fixes every random draw of a
cycle, core/random.py), and the numeric parameter dataclasses. The device
key is [seed, step] and is rebuilt from them on load. Restarting from a
checkpoint reproduces the uninterrupted run bit-for-bit.

The file holds ``ctrl/u_prev``, ``ctrl/seed`` and ``ctrl/step``, one array
``<name>/<field>`` for each field of each named parameter dataclass, and
``__config__``: JSON of the SolverConfig fields and of each dataclass's
class name and fields. It does not read a JAX package checkpoint: that one
carries a JAX PRNG key, which means nothing to this port's Philox and
``torch.Generator`` streams.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, make_key
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams

FORMAT = "ccv_mppi_path_tracker_tpu_torch checkpoint 1"
PARAM_CLASSES = {cls.__name__: cls for cls in (SolverParams, CostParams, FullBodyParams)}


def save_checkpoint(path: str, cfg: SolverConfig, ctrl: ControllerState, **params):
    """Persist the controller state and any named parameter dataclasses
    (e.g. ``sp=sp, cp=cp``; SolverParams, CostParams or FullBodyParams)."""
    flat = {
        "ctrl/u_prev": ctrl.u_prev.detach().cpu().numpy(),
        "ctrl/seed": np.asarray(ctrl.seed, np.int64),
        "ctrl/step": np.asarray(ctrl.step, np.int64),
    }
    meta = {"format": FORMAT, "config": dataclasses.asdict(cfg), "params": {}}
    for name, obj in params.items():
        cls = type(obj).__name__
        if PARAM_CLASSES.get(cls) is not type(obj):
            raise TypeError(f"{name}: {cls} is not one of {sorted(PARAM_CLASSES)}")
        fields = [f.name for f in dataclasses.fields(obj)]
        meta["params"][name] = {"class": cls, "fields": fields}
        for f in fields:
            flat[f"{name}/{f}"] = getattr(obj, f).detach().cpu().numpy()
    flat["__config__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_checkpoint(path: str, device=None):
    """Restore (cfg, ctrl, params): the SolverConfig, the ControllerState
    (its key [seed, step] rebuilt on ``device``) and {name: dataclass} of
    every saved parameter set, their tensors on ``device`` (None: the card,
    core/device.py) in their saved dtypes."""
    device = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__config__"]).decode())
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path} is not a checkpoint of this port")
        seed, step = int(data["ctrl/seed"]), int(data["ctrl/step"])
        ctrl = ControllerState(
            u_prev=torch.as_tensor(data["ctrl/u_prev"], device=device),
            seed=seed,
            step=step,
            key=make_key(seed, step, device),
        )
        params = {
            name: PARAM_CLASSES[spec["class"]](**{
                f: torch.as_tensor(data[f"{name}/{f}"], device=device)
                for f in spec["fields"]})
            for name, spec in meta["params"].items()
        }
    return SolverConfig(**meta["config"]), ctrl, params
