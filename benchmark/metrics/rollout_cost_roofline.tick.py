"""The fused kernel's share of its roofline, in percent: the least time an
H100 SXM at 700 W needs for the work of one tick's launch (``benchmark/work.py``,
counted from the algorithm, so the same whatever implements it) over the
device time of ``rollout_cost_kernel`` a tick, by name in the trace. The
count is a minimum: each precise sinf or log1pf is one operation."""

from benchmark import work


def read(obs):
    bd = obs["traces"].get("tick")
    if bd is None or not bd["kernel_ms"]:
        return None
    s = obs["shape"]
    bound, _ = work.bound_ms(work.update_work(s["model"], s["num_samples"], s["horizon"],
                                              num_robots=s["robots"]))
    return 100.0 * bound / bd["kernel_ms"]
