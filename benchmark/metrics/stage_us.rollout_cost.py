"""Device time of the control step's stage ``rollout_cost`` a traced update, in
microseconds: the fused kernel and its second pass, or the model's rollout
and cost (PETS's particle draw and particle mean included); from the update
graph's stage table laid over each traced unit's device operations
(``benchmark/stages.py``), the mean over the matched units. None where the
port keeps no stage table, fewer than half the units match, or the graph has
no such stage. Moves ``propagations_per_s``."""

from benchmark import stages


def read(obs):
    return stages.stage_us(obs, "rollout_cost")
