"""The readings with faults planted in the eager arm, for the cells whose
update runs it (``use_kernel "auto"`` over a model with a ``rollout_cost``
hook: ``autorally_nn.update``, ``pets_pe.update``). ``faults.HalfBatch``
halves the fused kernel's samples, and that arm never launches the kernel.

    python3 -m benchmark.readings_eager --workload pets_pe.update \\
        --seeds 1,2,3 --seconds 2 --program half_sequences

- ``HalfSequences``: the update is the weighted mean over the first half of
  the sequences only: the model's hook gives the second half a cost of 1e30,
  whose weight is 0;
- ``HalfParticles`` (``pets_pe``): each sequence's cost is the mean over
  half of its particles, the first P/(2E) of each member, the others
  overwritten by copies of them.

Both patch the port for the life of the process (``restore`` undoes it).
The benchmark's own runs never run these programs.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from benchmark import readings
from benchmark.programs import Port

LEFT_OUT_COST = 1e30


class HalfSequences(Port):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from ccv_mppi_path_tracker_tpu_torch.models import registry

        self.model = registry.get_model(self.cfg.model)
        hook = self.model.rollout_cost
        if hook is None:
            raise ValueError(f"{self.cfg.model} has no rollout_cost hook: not an eager cell")

        def half(*args, **kwargs):
            costs = hook(*args, **kwargs)
            n = costs.shape[0] // 2
            return torch.cat([costs[:n], torch.full_like(costs[n:], LEFT_OUT_COST)])
        registry.register_model(dataclasses.replace(self.model, rollout_cost=half))

    def restore(self):
        from ccv_mppi_path_tracker_tpu_torch.models import registry

        registry.register_model(self.model)


class HalfParticles(Port):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from ccv_mppi_path_tracker_tpu_torch.models import pets_pe

        if self.cfg.model != "pets_pe":
            raise ValueError(f"{self.cfg.model} has no particles")
        self.orig = pets_pe.particle_states

        def half(state0, controls, dt, params, normals, _orig=self.orig):
            states = _orig(state0, controls, dt, params, normals)
            t, members, n, d = states.shape
            per = states.view(t, members, controls.shape[1], -1, d)
            keep = per.shape[3] // 2
            per[:, :, :, keep:] = per[:, :, :, :keep]
            return states
        pets_pe.particle_states = half

    def restore(self):
        from ccv_mppi_path_tracker_tpu_torch.models import pets_pe

        pets_pe.particle_states = self.orig


FAULTS = {"half_sequences": HalfSequences, "half_particles": HalfParticles}


if __name__ == "__main__":
    readings.PROGRAMS.update(FAULTS)
    sys.exit(readings.main())
