"""Core types flowing through the solver (port of ``core/types.py``).

States are ``(..., S)`` rows and control sequences are time-major
``(T-1, ..., U)`` tensors, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class RefWindow:
    """Horizon-length local reference resampled from the global path:
    ``xy`` is (T, 2), ``yaw`` is (T,) (src/diff_drive_mppi.cpp:156-181)."""

    xy: torch.Tensor
    yaw: torch.Tensor


@dataclasses.dataclass
class ControllerState:
    """Everything the controller carries between control cycles.

    u_prev: (T-1, U) previous optimal control sequence, the sampling mean
        (warm start without a one-step shift, src/diff_drive_mppi.cpp:89-90).
    seed: integer seed of the run. With ``step`` it fixes every random draw
        of the cycle (core/random.py), in place of the JAX package's carried
        PRNG key. Both stay host integers, so the control update never reads
        them back from the device.
    step: cycle counter.
    """

    u_prev: torch.Tensor
    seed: int
    step: int

    @staticmethod
    def initial(seed: int, horizon: int, num_controls: int,
                dtype=torch.float32, device=None) -> "ControllerState":
        """A zero warm start on ``device`` (None: the card)."""
        return ControllerState(
            u_prev=torch.zeros((horizon - 1, num_controls), dtype=dtype,
                               device=resolve_device(device)),
            seed=int(seed),
            step=0,
        )


@dataclasses.dataclass
class StepResult:
    """Outputs of one MPPI control step.

    u_opt: (T-1, U) new optimal sequence; u0: (U,) the actuated command.
    ref: the resampled local reference; opt_states: (T, S) rollout of u_opt.
    stats: min_cost, mean_cost and ess (0-d tensors).

    With ``mppi_step(..., lean=True)`` ``ref``/``opt_states`` are None and
    ``stats`` is empty; ``u_opt``/``u0`` are unchanged.
    """

    u_opt: torch.Tensor
    u0: torch.Tensor
    ref: Optional[RefWindow]
    opt_states: Optional[torch.Tensor]
    stats: dict
