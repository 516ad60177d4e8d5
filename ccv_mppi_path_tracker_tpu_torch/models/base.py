"""Dynamics model interface (port of ``models/base.py``).

A model is a batched Euler step ``(state, u, dt) -> state`` over rows of
shape (..., S) and (..., U), batched by broadcasting.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class Model:
    """A dynamics family.

    step: (state (..., S), u (..., U), dt) -> next state (..., S).
    aux_from_rollout: optional post-rollout pass over the whole trajectory,
        (states (T, ..., S), controls (T-1, ..., U), dt, params) -> dict.
    default_params: optional (device, dtype) -> the model's parameters.
    """

    name: str
    state_names: tuple
    control_names: tuple
    step: Callable
    aux_from_rollout: Optional[Callable] = None
    default_params: Optional[Callable] = None

    @property
    def num_states(self) -> int:
        return len(self.state_names)

    @property
    def num_controls(self) -> int:
        return len(self.control_names)
