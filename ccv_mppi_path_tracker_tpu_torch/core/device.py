"""The device an entry point runs on when its caller names none.

Every constructor of the port that makes tensors (the config builders, the
presets, ``PathBuffer.from_points``, ``ControllerState.initial``,
``MPPISolver.init``, ``init_fleet``, ``default_params``, ``load_checkpoint``
and the runtime entry points) resolves its ``device`` argument here, so the
port runs on the card unless the caller asks for another device.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None gives ``cuda``.

    Where there is no CUDA device, the first tensor made on the result
    raises torch's own error: nothing falls back to the CPU. Pass
    ``device="cpu"`` to run there.
    """
    return torch.device("cuda") if device is None else torch.device(device)
