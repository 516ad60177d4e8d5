"""Input freshness gating and failure handling (port of ``runtime/gating.py``).

The reference gates its loop on "all inputs received" booleans
(src/full_body_mppi.cpp:612) and, on tf lookup failure, silently reuses the
stale pose (src/diff_drive_mppi.cpp:316-328). This module makes both explicit:
each input channel carries a timestamp; the gate reports readiness and
staleness, and the policy on stale inputs (hold the last command or zero it)
is a declared choice instead of an accident.

The gate's bookkeeping is host-side (timestamps); a channel's value and the
commands it resolves stay whatever the caller passed, device tensors
included, and the gate never reads them.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Channel:
    max_age: float
    value: object = None
    stamp: float = -math.inf
    updates: int = 0


def _zeros_like(command):
    """Zeros of the command's shape: a tensor, an array, or each field of a
    command dataclass (solver/command.py WheelSteerCommand)."""
    if isinstance(command, torch.Tensor):
        return torch.zeros_like(command)
    if dataclasses.is_dataclass(command):
        return dataclasses.replace(command, **{
            f.name: _zeros_like(getattr(command, f.name))
            for f in dataclasses.fields(command)})
    return np.zeros_like(command)


class InputGate:
    """Tracks input channels and decides whether a control cycle may run."""

    def __init__(self, stale_policy: str = "hold"):
        if stale_policy not in ("hold", "zero"):
            raise ValueError(f"stale_policy is 'hold' or 'zero', not {stale_policy!r}")
        self.channels: Dict[str, Channel] = {}
        self.stale_policy = stale_policy
        self.stale_cycles = 0

    def add_channel(self, name: str, max_age: float):
        self.channels[name] = Channel(max_age=max_age)

    def update(self, name: str, value, stamp: Optional[float] = None):
        ch = self.channels[name]
        ch.value = value
        ch.stamp = time.monotonic() if stamp is None else stamp
        ch.updates += 1

    def ready(self) -> bool:
        """All channels have been received at least once (the reference's
        received-flags gate)."""
        return all(ch.updates > 0 for ch in self.channels.values())

    def stale(self, now: Optional[float] = None) -> Dict[str, float]:
        """Channels whose last update exceeds max_age; {name: age}."""
        now = time.monotonic() if now is None else now
        return {
            n: now - ch.stamp
            for n, ch in self.channels.items()
            if now - ch.stamp > ch.max_age
        }

    def get(self, name: str):
        return self.channels[name].value

    def resolve_command(self, fresh_command, last_command, now=None):
        """Apply the stale policy: fresh inputs pass the command through;
        stale inputs hold the previous command or zero it."""
        if not self.stale(now):
            return fresh_command
        self.stale_cycles += 1
        if self.stale_policy == "hold":
            return last_command
        return _zeros_like(last_command)
