"""Device time of the refine stage a refined update, in microseconds: the
mean over the traced units of the summed lengths of the device operations
that start after the unit's ``rollout_cost_kernel`` ends
(``benchmark/work_refine.py after_the_kernel``, from ``obs["units"]``). It
includes the sampled update's tail after the kernel, about 7 us of the
flagship's update. None where no traced unit launched the kernel. Moves
``propagations_per_s``."""

from benchmark import work_refine


def read(obs):
    return work_refine.after_the_kernel(obs["units"].get("update"))[0]
