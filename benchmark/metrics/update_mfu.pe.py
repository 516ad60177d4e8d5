"""The update's share of the H100's float32 peak, in %: the operations of
one update over PETS's probabilistic ensemble (``benchmark/work_pe.py``,
counted from the algorithm) over the mean traced unit's device span, from
its first operation's start to its last one's end, times 67 TFLOP/s. None
where no unit was traced. Moves ``propagations_per_s``."""

from benchmark import work_pe


def read(obs):
    conf = obs["config"]
    return work_pe.update_mfu(obs["units"].get("update"), conf["num_samples"],
                              conf["horizon"], conf["particles"])
