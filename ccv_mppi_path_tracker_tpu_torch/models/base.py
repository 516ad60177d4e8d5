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
    cost_fn: optional per-trajectory cost override, (states (T, K, S),
        controls (T-1, K, U), aux, ref: RefWindow, cp: CostParams) -> (K,).
        The eager path uses it in place of the built-in cost; the fused
        kernel computes the built-in cost only.
    constants: numeric constants baked into ``step`` (rate_limited_steering's
        steer and rate limits). Code that re-derives the dynamics outside
        ``step`` (the closed-form rollout, the fused kernel) reads them from
        here, so a re-registered variant stays consistent with its step.
    rollout: optional sequential rollout that takes the model's parameters,
        (state0 (..., S), controls (T-1, ..., U), dt, params) -> states
        (T, ..., S). The eager path, the planned path and the refinement
        call it in place of the Euler recurrence over ``step`` (which gets
        no parameters): a model whose step reads parameters (a network's
        weights) supplies it.
    rollout_cost: optional rollout and cost in one, (state0 (K, S), controls
        (T-1, K, U), dt, params, ref: RefWindow, cp: CostParams) -> (K,), the
        costs that ``cost_fn`` gives of ``rollout``'s states. The eager path
        calls it in place of the two where nothing needs the sampled states
        (no ``debug_candidates``, no ``aux_from_rollout``): a model whose
        rollout and cost run as one kernel (models/autorally_nn.py) supplies
        it.
    stochastic: the model samples its own transitions. Its ``rollout_cost``
        then also takes the step's Philox key, as ``ControllerState.rng()``
        gives it (``key``, ``seed``, ``step``), and ``first_sample``; the
        eager path takes every sequence's cost from it, its particles' mean
        (models/pets_pe.py), and refuses ``debug_candidates``. Its
        ``rollout`` and ``step``, which get no key, are deterministic.
    """

    name: str
    state_names: tuple
    control_names: tuple
    step: Callable
    aux_from_rollout: Optional[Callable] = None
    default_params: Optional[Callable] = None
    cost_fn: Optional[Callable] = None
    constants: Optional[dict] = None
    rollout: Optional[Callable] = None
    rollout_cost: Optional[Callable] = None
    stochastic: bool = False

    @property
    def num_states(self) -> int:
        return len(self.state_names)

    @property
    def num_controls(self) -> int:
        return len(self.control_names)
