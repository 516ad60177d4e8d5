"""Softmax importance weights, elite selection and the weighted control
update (port of ``ops/softmax_update.py``).

``w_i = exp(-(cost_i - min cost)/lambda) / sum_j (...)``: the reference
(calc_Weights, src/diff_drive_mppi.cpp:212-223) has no baseline and
underflows once costs exceed ~700*lambda; subtracting the minimum is
identical wherever the reference is finite.
"""

from __future__ import annotations

from typing import Optional

import torch


def elite_threshold(costs: torch.Tensor, frac: float):
    """The cost threshold that selects the best ``frac`` of the samples: the
    ``max(1, round(frac * K))``-th smallest cost (Python's ``round``, half to
    even, as in the JAX package), NaN costs counting as +inf. A 0-d tensor on
    the device of ``costs``; nothing is read back to the host.

    The JAX package finds the same element by a radix descent over the float
    bits. Here it is an element of ``torch.sort``: at K=102400 on an H100
    80GB HBM3 at 700 W the sort took 0.063 ms and ``torch.kthvalue`` 0.369 ms
    (PERF.md). Under
    the JAX bit-key order -0.0 sorts below +0.0, while the sort holds them
    equal, so the two could differ only in the sign of a zero threshold. The
    mask ``cost <= threshold`` is the same either way, and the built-in
    costs (sums of squares under non-negative weights, plus a constant yaw
    term) are never -0.0.
    """
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"elite fraction must lie in [0, 1], got {frac}")
    target = max(1, int(round(frac * costs.shape[0])))
    costs = torch.where(torch.isnan(costs), torch.inf, costs)
    return torch.sort(costs).values[target - 1]


def softmax_weights(costs: torch.Tensor, lam, elite_frac: Optional[float] = None,
                    elite_thresh=None):
    """costs: (K,). Returns (weights (K,), stats) with stats min_cost,
    mean_cost and ess (effective sample size in [1, K]), 0-d tensors.

    elite_frac: zero the weight of every sample above the
        :func:`elite_threshold` of this fraction before normalizing (the
        CEM-MPPI interpolation; 1.0 is vanilla MPPI). The threshold is
        reported in stats["elite_thresh"].
    elite_thresh: a threshold given from outside (a 0-d tensor): the
        single-pass stale-threshold mode masks at this value (+inf masks
        nothing) while stats["elite_thresh"] still reports the current
        costs' threshold for the next cycle. A stale threshold can mask every
        sample: the weights then stay all zero, not NaN, and
        stats["elite_stale_empty"] is true.
    """
    baseline = torch.amin(costs)
    unnorm = torch.exp(-(costs - baseline) / lam)
    thresh = None
    if elite_frac is not None:
        thresh = elite_threshold(costs, elite_frac)
    mask_at = elite_thresh if elite_thresh is not None else thresh
    if mask_at is not None:
        unnorm = torch.where(costs <= mask_at, unnorm, 0.0)
    denom = torch.sum(unnorm)
    if elite_thresh is not None:
        empty = denom <= 0.0
        weights = unnorm / torch.where(empty, 1.0, denom)
    else:
        weights = unnorm / denom
    stats = {
        "min_cost": baseline,
        "mean_cost": torch.sum(costs) / costs.shape[0],
        "ess": 1.0 / torch.sum(weights * weights),
    }
    if thresh is not None:
        stats["elite_thresh"] = thresh
    if elite_thresh is not None:
        stats["elite_stale_empty"] = empty
    return weights, stats


def weighted_update(weights: torch.Tensor, samples: torch.Tensor):
    """Importance-weighted average of the samples (determine_OptimalSolution,
    src/diff_drive_mppi.cpp:225-246). weights: (K,); samples: (T-1, K, U).
    Returns (T-1, U). A multiply and a sum, not a matmul, so no float32
    matmul setting (TF32) can change its precision."""
    return torch.sum(weights[None, :, None] * samples, dim=1)
