"""Device time of the control step's stage ``refine`` a traced update, in
microseconds: the refine stage (``_refine``: the Gauss-Newton kernel and its
few ops); from the update graph's stage table laid over each traced unit's
device operations (``benchmark/stages.py``), the mean over the matched
units. None where the port keeps no stage table, fewer than half the units
match, or the graph has no such stage. Moves ``propagations_per_s``."""

from benchmark import stages


def read(obs):
    return stages.stage_us(obs, "refine")
