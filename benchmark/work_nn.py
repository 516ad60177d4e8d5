"""The benchmark's count of the work of one control update over the AutoRally
network model, and the update's share of the card's float32 peak.

Counted from the algorithm (``benchmark/reference_nn.py``), not from any
implementation, so the share reads the same work whether a chain of tensor
ops or one fused kernel computes it. In the units of ``benchmark/work.py``
(a multiply-add 2 operations; each tanh, sin, cos, min, compare and select
1), per sample, with T the horizon and R = T window points:

- ``network``: the T-1 evaluations of the 6-32-32-4 network, each the three
  matrix products counted dense, 2 (6·32 + 32·32 + 32·4) = 2688, the biases
  32 + 32 + 4 and the 64 tanh: 2820;
- ``kinematics``: a step's pose derivative (cos and sin of the yaw 2, each
  of x' and y' a product and a multiply-add 3, yaw' a negation 1) 9, and the
  Euler step of the 7 states, a multiply-add each, 14;
- ``scan``: the distance scan of ``work.py`` for each of the T states
  (8 + 5R + 1);
- ``speed``: the speed error of states 1 ... T-1 and its square summed, 3
  each, and the weighted sum of the two terms, 3.

The draw, the samples and the softmax update are left out: they are the
same work over any model, and small beside the network (under 1 % at
T=30). So the count is a minimum.
"""

from __future__ import annotations

from benchmark import work

LAYERS = ((6, 32), (32, 32), (32, 4))
NETWORK = (sum(2 * i * o + o for i, o in LAYERS)
           + sum(o for _, o in LAYERS[:-1]))   # products, biases, tanh of the hidden layers
KINEMATICS = 9 + 2 * 7


def per_sample(horizon: int, num_ref: int = None) -> dict:
    """Operations of one sample's rollout and cost, by part."""
    num_ref = horizon if num_ref is None else num_ref
    tm1 = horizon - 1
    return {"network": tm1 * NETWORK, "kinematics": tm1 * KINEMATICS,
            "scan": horizon * (8 + 5 * num_ref + 1), "speed": 3 * tm1 + 3}


def update_flops(num_samples: int, horizon: int) -> int:
    """Operations of one update of ``num_samples`` samples."""
    return num_samples * sum(per_sample(horizon).values())


def device_span_us(units) -> float:
    """The mean over the traced units of each unit's device span, from its
    first operation's start to its last one's end, in microseconds (None
    where no unit ran an operation)."""
    if units is None:
        return None
    spans = []
    for i in range(len(units["unit_us"])):
        mine = units["unit"] == i
        if mine.any():
            end = units["start_us"][mine] + units["dur_us"][mine]
            spans.append(float(end.max() - units["start_us"][mine].min()))
    return sum(spans) / len(spans) if spans else None


def update_mfu(units, num_samples: int, horizon: int) -> float:
    """The update's share of the float32 peak (``work.FP32_PEAK``), in %:
    :func:`update_flops` over :func:`device_span_us`."""
    us = device_span_us(units)
    if not us:
        return None
    return 100.0 * update_flops(num_samples, horizon) / (us * 1e-6 * work.FP32_PEAK)
