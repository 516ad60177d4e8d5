"""Device time of the control step's stage ``finish`` a traced update, in
microseconds: the state advanced (``ctrl.advanced``) and, where the step is
not lean, the planned path; from the update graph's stage table laid over
each traced unit's device operations (``benchmark/stages.py``), the mean
over the matched units. None where the port keeps no stage table, fewer than
half the units match, or the graph has no such stage. Moves
``propagations_per_s``."""

from benchmark import stages


def read(obs):
    return stages.stage_us(obs, "finish")
