"""Device time of the control step's stage ``average`` a traced update, in
microseconds: the softmax weights or the elite threshold, the weighted
update, the kernel path's ``u_num / norm`` and ``sigma_suggest``; from the
update graph's stage table laid over each traced unit's device operations
(``benchmark/stages.py``), the mean over the matched units. None where the
port keeps no stage table, fewer than half the units match, or the graph has
no such stage. Moves ``propagations_per_s``."""

from benchmark import stages


def read(obs):
    return stages.stage_us(obs, "average")
