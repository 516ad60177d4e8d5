"""The benchmark's count of the work of one control update over PETS's
probabilistic ensemble, and the update's share of the card's float32 peak.

Counted from the algorithm (``benchmark/reference_pe.py``), not from any
implementation, so the share reads the same work whether a chain of tensor
ops or one fused kernel computes it. In the units of ``benchmark/work.py``
(a multiply-add 2 operations; each sigmoid, softplus, exp, sin, cos, min,
compare and select 1), per particle, with T the horizon and R = T window
points:

- ``network``: the T-1 evaluations of a member, each the five matrix
  products counted dense, 2 (6·200 + 3·200·200 + 200·8) = 245600, the
  biases 4·200 + 8, the 800 swish (a sigmoid and a product, 2 each), the
  input standardiser (a subtraction and a division a input, 12) and the
  log-variance bounds (a subtraction, a softplus and a subtraction, twice,
  for each of 4: 24): 248044;
- ``noise``: a step's sampled change of the 4 dynamic states, each the
  halving and exp of its log-variance (2), the product with its normal and
  the two sums (3): 20;
- ``kinematics``: a step's pose derivative (cos and sin of the yaw 2, each
  of x' and y' a product and a multiply-add 3, yaw' a negation 1) 9, and the
  Euler step of the 3 pose states, a multiply-add each, 6;
- ``scan``: the distance scan of ``work.py`` for each of the T states
  (8 + 5R + 1);
- ``speed``: the speed error of states 1 ... T-1 and its square summed, 3
  each, and the weighted sum of the two terms, 3;
- ``particle``: the non-finite test and its select, and its share of the
  sequence's mean, 3.

The two draws, the samples and the softmax update are left out: they are the
same work over any model, and small beside the ensemble (under 0.1 % at
T=30). So the count is a minimum.
"""

from __future__ import annotations

from benchmark import work, work_nn

LAYERS = ((6, 200), (200, 200), (200, 200), (200, 200), (200, 8))
OUT = 4
NETWORK = (sum(2 * i * o + o for i, o in LAYERS)     # products and biases
           + 2 * sum(o for _, o in LAYERS[:-1])      # swish
           + 2 * LAYERS[0][0]                        # the input standardiser
           + 6 * OUT)                                # the log-variance bounds
NOISE = 5 * OUT
KINEMATICS = 9 + 2 * 3


def per_particle(horizon: int, num_ref: int = None) -> dict:
    """Operations of one particle's rollout and cost, by part."""
    num_ref = horizon if num_ref is None else num_ref
    tm1 = horizon - 1
    return {"network": tm1 * NETWORK, "noise": tm1 * NOISE, "kinematics": tm1 * KINEMATICS,
            "scan": horizon * (8 + 5 * num_ref + 1), "speed": 3 * tm1 + 3, "particle": 3}


def update_flops(num_samples: int, horizon: int, particles: int) -> int:
    """Operations of one update of ``num_samples`` sequences of ``particles``."""
    return num_samples * particles * sum(per_particle(horizon).values())


def update_mfu(units, num_samples: int, horizon: int, particles: int) -> float:
    """The update's share of the float32 peak (``work.FP32_PEAK``), in %:
    :func:`update_flops` over ``work_nn.device_span_us``."""
    us = work_nn.device_span_us(units)
    if not us:
        return None
    return (100.0 * update_flops(num_samples, horizon, particles)
            / (us * 1e-6 * work.FP32_PEAK))
