"""Softmax importance weights and the weighted control update (port of
``ops/softmax_update.py``, without elite selection).

``w_i = exp(-(cost_i - min cost)/lambda) / sum_j (...)``: the reference
(calc_Weights, src/diff_drive_mppi.cpp:212-223) has no baseline and
underflows once costs exceed ~700*lambda; subtracting the minimum is
identical wherever the reference is finite.
"""

from __future__ import annotations

import torch


def softmax_weights(costs: torch.Tensor, lam):
    """costs: (K,). Returns (weights (K,), stats) with stats min_cost,
    mean_cost and ess (effective sample size in [1, K]), 0-d tensors."""
    baseline = torch.amin(costs)
    unnorm = torch.exp(-(costs - baseline) / lam)
    weights = unnorm / torch.sum(unnorm)
    stats = {
        "min_cost": baseline,
        "mean_cost": torch.sum(costs) / costs.shape[0],
        "ess": 1.0 / torch.sum(weights * weights),
    }
    return weights, stats


def weighted_update(weights: torch.Tensor, samples: torch.Tensor):
    """Importance-weighted average of the samples (determine_OptimalSolution,
    src/diff_drive_mppi.cpp:225-246). weights: (K,); samples: (T-1, K, U).
    Returns (T-1, U). A multiply and a sum, not a matmul, so no float32
    matmul setting (TF32) can change its precision."""
    return torch.sum(weights[None, :, None] * samples, dim=1)
