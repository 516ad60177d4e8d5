"""The refine stage's share of its roofline, in percent: the least time an
H100 SXM at 700 W needs for the stage's guarded Gauss-Newton steps
(``benchmark/work_refine.py``, counted from the algorithm, so the same
whatever implements the stage) over ``refine_device_us.gn``'s device time a
unit. The count is a minimum, and the stage is a chain of small launches, so
the share reads far under 1 %. None where that time reads nothing. Moves
``propagations_per_s``."""

from benchmark import work_refine


def read(obs):
    us, _ = work_refine.after_the_kernel(obs["units"].get("update"))
    steps = obs["config"]["program"].get("options", {}).get("refine_steps", 0)
    if not us or not steps:
        return None
    bound = work_refine.bound_us(obs["config"]["horizon"], len(obs["config"]["solver"]["u_min"]),
                                 steps)
    return 100.0 * bound / us
