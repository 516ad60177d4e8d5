"""Device time of a traced update outside every stage of the control step, in
microseconds: the call's copies in and out and any device node of the update
graph that no stage marked, so that the stages and this add up to the unit's
device time; the mean over the units matched to the update graph's stage
table (``benchmark/stages.py``). None where the port keeps no stage table or
fewer than half the units match. Moves ``propagations_per_s``."""

from benchmark import stages


def read(obs):
    return stages.stage_us(obs, stages.OUTSIDE)
