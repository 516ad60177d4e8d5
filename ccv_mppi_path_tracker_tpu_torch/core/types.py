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
        of the cycle (core/random.py). Both stay host integers, so the
        control update never reads them back from the device.
    step: cycle counter.
    key: the same pair on the device, a (2,) int64 tensor [seed, step]: the
        counterpart of the JAX package's carried PRNG key. The fused kernel
        and the plant's process noise read it there, so a CUDA graph of a
        cycle draws anew at every replay (utils/cuda_graph.py); every step
        advances it beside ``step``, so ``key == [seed, step]`` holds. None
        (a state built without it): the kernel takes seed and step by value.
    """

    u_prev: torch.Tensor
    seed: int
    step: int
    key: Optional[torch.Tensor] = None

    @staticmethod
    def initial(seed: int, horizon: int, num_controls: int,
                dtype=torch.float32, device=None) -> "ControllerState":
        """A zero warm start and its key on ``device`` (None: the card)."""
        device = resolve_device(device)
        return ControllerState(
            u_prev=torch.zeros((horizon - 1, num_controls), dtype=dtype, device=device),
            seed=int(seed),
            step=0,
            key=make_key(seed, 0, device),
        )

    def with_key(self) -> "ControllerState":
        """This state, with its key made from seed and step where it has none."""
        if self.key is not None:
            return self
        return dataclasses.replace(self, key=make_key(self.seed, self.step,
                                                      self.u_prev.device))

    def advanced(self, u_prev: torch.Tensor, steps: int = 1) -> "ControllerState":
        """The state ``steps`` cycles on: warm start ``u_prev``, the step and
        the key (where there is one) advanced together."""
        key = None if self.key is None else advance_key(self.key, steps)
        return ControllerState(u_prev=u_prev, seed=self.seed, step=self.step + steps,
                               key=key)


def make_key(seed: int, step: int, device) -> torch.Tensor:
    """The (2,) int64 key [seed, step] on ``device``, by two fills (no copy
    from the host, so no host sync)."""
    key = torch.full((2,), int(seed), dtype=torch.int64, device=device)
    key[1:].fill_(int(step))
    return key


def advance_key(key: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """[seed, step + steps] from ``key`` [seed, step], on the device."""
    return torch.cat([key[:1], key[1:] + steps])


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
