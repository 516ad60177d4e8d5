"""Faults planted under the timed path, to show that ``correct`` catches them.

Each is the port (``programs.Port``) broken in one place:

- ``StaleState``: the update returns the controller state it was given, so
  the warm start, the step and the key never advance;
- ``HalfBatch``: the fused kernel runs over the first half of the samples
  only, and the update is the weighted mean over those;
- ``Altered``: the answer is altered where it is produced: u_opt's first
  control moves by 1 % of its box, and a serving cycle's left steering angle
  by 1e-3 rad and its steering mode by one.

``HalfBatch`` patches the kernel's wrapper in the solver's modules for the
life of the process (``restore`` undoes it). The exchange between chips has
no fault here: every cell runs on one card.
"""

from __future__ import annotations

import dataclasses
import types

from benchmark.programs import Port


class StaleState(Port):
    def update_step(self):
        step = super().update_step()
        return lambda ctrl, *args: (ctrl, step(ctrl, *args)[1])

    def fleet_step(self):
        step = super().fleet_step()
        return lambda ctrls, *args: (ctrls,) + step(ctrls, *args)[1:]

    def control_loop(self, path, seed: int):
        loop = super().control_loop(path, seed)
        compiled = loop.compiled
        loop.compiled = lambda ctrl, *a, **k: (ctrl, compiled(ctrl, *a, **k)[1])
        return loop


class HalfBatch(Port):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from ccv_mppi_path_tracker_tpu_torch.solver import batch, mppi

        self.patched = []
        for mod in (mppi, batch):
            orig = mod.fused_sample_rollout_cost

            def half(*args, num_samples, _orig=orig, **kw):
                return _orig(*args, num_samples=num_samples // 2, **kw)
            self.patched.append((mod, orig))
            mod.fused_sample_rollout_cost = half

    def restore(self):
        for mod, orig in self.patched:
            mod.fused_sample_rollout_cost = orig


class Altered(Port):
    def _bump(self, u):
        box = self.config["solver"]["u_max"][0] - self.config["solver"]["u_min"][0]
        u = u.clone()
        u[..., 0, 0] += 0.01 * box
        return u

    def update_step(self):
        step = super().update_step()

        def altered(*args):
            ctrl, u = step(*args)
            return ctrl, self._bump(u)
        return altered

    def fleet_step(self):
        step = super().fleet_step()

        def altered(*args):
            ctrls, u, _ = step(*args)
            u = self._bump(u)
            return ctrls, u, u[:, 0]
        return altered

    def control_loop(self, path, seed: int):
        loop = super().control_loop(path, seed)
        inner, outer = loop.step, self

        def step(pose, dt):
            res = inner(pose, dt)
            u = outer._bump(res.u_opt)
            return types.SimpleNamespace(u_opt=u, u0=u[0])
        loop.step = step
        return loop

    def command(self, u0, dt: float):
        cmd = super().command(u0, dt)
        return dataclasses.replace(cmd, steer_l=cmd.steer_l + 1e-3)

    def mode(self, cmd):
        return (super().mode(cmd) + 1) % 4


FAULTS = {"stale_state": StaleState, "half_batch": HalfBatch, "altered": Altered}
