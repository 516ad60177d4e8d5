"""Simulation plant for closed-loop runs (port of ``runtime/plant.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.core.random import plant_normals
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import Graphed, capturable


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


def fleet_plant_step(model_name: str, states, u0, dt):
    """Every robot of a fleet stepped by ``model_name``'s model: states (B,
    S), u0 (B, U); the JAX package's ``jax.vmap(model.step)``."""
    return get_model(model_name).step(states, u0, dt)


# The fleet's plant compiled (the JAX CLI's jax.jit of that vmap): on the
# card one CUDA graph per model and shapes a process runs.
FLEET_PLANT = Graphed(fleet_plant_step, max_graphs=8)


def step_fleet_plant(model_name: str, states, u0, dt):
    """:func:`fleet_plant_step`, on the card a replay of its CUDA graph
    (:data:`FLEET_PLANT`), elsewhere op by op."""
    args = (model_name, states, u0, dt)
    return FLEET_PLANT(*args) if capturable(args) else fleet_plant_step(*args)
