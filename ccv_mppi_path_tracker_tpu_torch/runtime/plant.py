"""Simulation plant for closed-loop runs (port of ``runtime/plant.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.core.random import plant_normals
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model


@dataclasses.dataclass(frozen=True)
class Plant:
    """A plant = model step + control gain + additive process noise.

    control_gain scales the applied controls (e.g. 0.9 simulates actuator
    droop); process_noise is the per-state-dim std-dev of additive Gaussian
    noise, drawn from the cycle's device key [seed, step] passed to
    :meth:`step` (core/random.py plant_normals).
    """

    model_name: str
    control_gain: float = 1.0
    process_noise: float = 0.0
    substeps: int = 1

    def step(self, state, u, dt, key: Optional[torch.Tensor] = None):
        m = get_model(self.model_name)
        u = u * self.control_gain
        sub_dt = dt / self.substeps
        for _ in range(self.substeps):
            state = m.step(state, u, sub_dt)
        if self.process_noise:
            if key is None:
                raise ValueError("a plant with process noise needs the cycle's key")
            state = state + self.process_noise * plant_normals(key, state.shape, state.dtype)
        return state
