"""Device operations of the refine stage a refined update: the mean count,
over the traced units, of those that start after the unit's
``rollout_cost_kernel`` ends (``benchmark/work_refine.py after_the_kernel``),
the sampled update's tail after the kernel included. The launches a fused
Gauss-Newton kernel would collapse. None where no traced unit launched the
kernel. Moves ``propagations_per_s``."""

from benchmark import work_refine


def read(obs):
    return work_refine.after_the_kernel(obs["units"].get("update"))[1]
