"""The update's share of the H100's float32 peak, in %: the operations of
one update over the network model (``benchmark/work_nn.py``, counted from
the algorithm) over the mean traced unit's device span, from its first
operation's start to its last one's end, times 67 TFLOP/s. None where no
unit was traced. Moves ``propagations_per_s``."""

from benchmark import work_nn


def read(obs):
    return work_nn.update_mfu(obs["units"].get("update"), obs["config"]["num_samples"],
                              obs["config"]["horizon"])
