"""The benchmark's count of the Gauss-Newton refine stage's work, and its bound.

Counted from the algorithm (``benchmark/reference_gn.py``), not from any
implementation, so the share of the bound reads the same work whatever
computes it, a chain of small launches or one fused kernel. Each count is a
minimum, in the units of ``benchmark/work.py`` (a fused multiply-add 2
operations; each sin, cos, sqrt, min, compare and select 1). With T the
horizon, U the controls, m = 5(T-2)+1 residuals and n = (T-1)U unknowns, one
step is:

- ``jacobian``: the residuals and their n directional derivatives (J by
  forward mode, or its m rows by reverse mode: either computes at least
  one evaluation's work a direction), so (n + 1) evaluations;
- ``normal``: J^T J, 2·m·n^2 (every entry a dot product of two columns; the
  symmetry left unused, as a library's product computes it), and J^T r,
  2·m·n;
- ``solve``: the Cholesky factorization n^3/3 and the two triangular
  solves, n^2 each;
- ``trial``: the step and its clamp (3n), one evaluation at the trial point
  and its sum of squares (2m), the accept's compare and three selects (4).

One evaluation: the Euler steps the residuals read (T-3, ``work.STEP``), and
for each of the T-2 terms the distance scan of ``work.py`` (8 + 5R + 1 with
R = T window points), its root, the constant and the weight (3), the
velocity error and its weight (2), the lateral ZMP without its square sum
(22) and its weight (1), the roll-rate change and its weight (2), min(v, 0)
and its weight (2); once the yaw error and its weight (2).

Bytes: at least J and J^T J written once a step, in float32.
"""

from __future__ import annotations

import numpy as np

from benchmark import trace, work

ZMP = 22   # work.BODY's lateral ZMP, 24, less the square and its sum


def sizes(horizon: int, num_controls: int) -> tuple:
    """(m residuals, n unknowns) of one sequence."""
    return 5 * (horizon - 2) + 1, (horizon - 1) * num_controls


def evaluation(horizon: int) -> int:
    """Operations of one evaluation of the full-body residuals, against a
    window of T points."""
    scan = 8 + 5 * horizon + 1
    terms = horizon - 2
    return ((horizon - 3) * work.STEP["full_body"]
            + terms * ((scan + 3) + 2 + (ZMP + 1) + 2 + 2) + 2)


def step_work(horizon: int, num_controls: int) -> dict:
    """Operations of one guarded Gauss-Newton step, by part."""
    m, n = sizes(horizon, num_controls)
    ev = evaluation(horizon)
    return {"jacobian": (n + 1) * ev,
            "normal": 2 * m * n * n + 2 * m * n,
            "solve": n ** 3 / 3 + 2 * n * n,
            "trial": 3 * n + ev + 2 * m + 4}


def refine_work(horizon: int, num_controls: int, steps: int) -> dict:
    """{"flops", "int_ops", "bytes"} of ``steps`` guarded steps of one robot."""
    m, n = sizes(horizon, num_controls)
    flops = sum(step_work(horizon, num_controls).values())
    return {"flops": steps * flops, "int_ops": 0, "bytes": steps * 4 * (m * n + n * n)}


def bound_us(horizon: int, num_controls: int, steps: int) -> float:
    """The least time in microseconds an H100 SXM at 700 W takes for the
    stage (``work.bound_ms``)."""
    return 1e3 * work.bound_ms(refine_work(horizon, num_controls, steps))[0]


def after_the_kernel(units) -> tuple:
    """(mean device us, mean count) a unit of the device operations that
    start after the unit's last ``rollout_cost_kernel`` ends, from
    ``trace.unit_ops``'s arrays; (None, None) where no unit launched the
    kernel. In a refined update these are the refine stage's operations and
    the sampled update's tail after the kernel (its finish and the copies
    out, about 7 us)."""
    if units is None or not len(units["unit_us"]):
        return None, None
    kernel = np.array([trace.KERNEL_NAME in n for n in units["names"]], dtype=bool)
    if not kernel.any():
        return None, None
    is_kernel = kernel[units["name"]]
    end = units["start_us"] + units["dur_us"]
    us, count = [], []
    for i in range(len(units["unit_us"])):
        mine = units["unit"] == i
        if not (mine & is_kernel).any():
            continue
        after = mine & (units["start_us"] >= end[mine & is_kernel].max())
        us.append(float(units["dur_us"][after].sum()))
        count.append(int(after.sum()))
    if not us:
        return None, None
    return sum(us) / len(us), sum(count) / len(count)
