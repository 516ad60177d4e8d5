"""The share of a traced update's units whose device operations the update
graph's stage table matches, in %: the units that every ``stage_us.*``
reading averages over (``benchmark/stages.py``), under half of which they
read nothing. None where no unit was traced or the port keeps no stage
table. Moves ``propagations_per_s``."""

from benchmark import stages


def read(obs):
    return stages.matched_share(obs)
