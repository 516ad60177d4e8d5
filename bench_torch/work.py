"""The benchmark's own count of the fused kernel's work, and its bound.

Twin of the JAX package's ``scripts/roofline.py`` and
``scripts/kernel_floor.py``. The count is reckoned from the algorithm (the
model equations, the cost terms, the Philox4x32-10 stream and Box-Muller),
not from the package's kernel source or its ``rollout_cost_work``, so that
the share of the bound reads the same work whatever implements it. Per
sample, with T the horizon, R = T reference points, U controls, P =
ceil(U/2) normal pairs a step; a fused multiply-add counts 2 operations,
each sin, cos, exp, log1p, sqrt, min, max, compare and select 1, and an
integer operation 1 a machine instruction, the unit of the integer peak:

- ``philox`` (integer, RNG mode): one Philox4x32-10 call a pair of normals,
  (T-1)*P calls; each call 10 rounds of two 32x32-bit products whose high
  and low halves are both used (4) and two three-input XORs (2: one
  three-input logic instruction each), then the two shifts that keep 23
  bits (2): 62. The key schedule depends on the seed and step alone, once
  a launch.
- ``box_muller`` (RNG mode): a pair 11: two integer-to-float conversions,
  each followed by one scaling that holds its branch's constants (-2^-23
  for the radius, whose negation is folded in; 2*pi*2^-23 for the angle),
  log1p, the scale by -2, sqrt, cos, sin and the two products.
- ``sample``: a control of step 0 is mean + sigma*eta and its clamp (4), of
  a later step the coloured eps = b*eps + s*eta first (7).
- ``rollout``: the Euler steps the cost reads (T-1 for the tracking
  models, whose path term reads all T states; T-3 for full_body, whose
  terms read states 0 ... T-3), ``STEP[model]`` each.
- ``cost``: a distance scan per state the path term reads (the centring
  2, |p|^2 3, per reference point two multiply-adds against the centred
  rows and the min 5, the add back 1, the clamp 2, its sum 1), the
  velocity term a control (3), full_body's per-step terms ``BODY`` (the
  lateral ZMP 24, the roll-rate smoothness 2, the backward term 4) and
  once the yaw term (3) and the weighted sum of the terms.
- ``update`` (with the weighted update): a sample's share of the minimum
  (1), the shifted and scaled exponent (3), the elite mask (compare and
  select 2), the sum of weights (1); a control w*u and its sum (2), with
  the second moment also w*u*u and its sum (2 more).

Bytes: each input read once and each output written once: the warm start,
sigma and the box, the reference window, the start state, the scalar
parameters, the injected noise (noise mode), the costs (written, or read
by a costs-in pass) and the update's sums.
"""

from __future__ import annotations

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet); int32 at
# half the float32 rate, as PERF.md §6 uses it, in instructions.
FP32_PEAK = 67e12
INT32_PEAK = 33.5e12
HBM_BYTES_PER_S = 3.35e12

# model -> (states S, controls U)
DIMS = {"unicycle": (3, 2), "steering_unicycle": (3, 3),
        "rate_limited_steering": (4, 3), "full_body": (5, 5)}

# One Euler step of the model equations: the heading (yaw, plus the steer
# control or state) 0-1, cos and sin 2, v*dt 1, x, y and yaw multiply-adds
# 6; rate_limited_steering also clips the rate (2), slews the steer (2) and
# clips it (2); full_body also integrates roll and pitch (4).
STEP = {"unicycle": 9, "steering_unicycle": 10, "rate_limited_steering": 16,
        "full_body": 14}

PHILOX_CALL = 10 * (4 + 2) + 2
BOX_MULLER_PAIR = 11
# full_body's terms a step beyond path and velocity: the lateral ZMP (the
# drive acceleration 2, v*w 1, cos and sin of the steer 2, the lateral
# acceleration 3, the lateral force 1, the roll rate's change scaled by the
# inertia 2, the CoM's lateral and vertical offsets 6, the moment 4, over
# the vertical force 1, its square summed 2) 24, the roll-rate smoothness
# 2 (the change is the ZMP's), the backward term 4
BODY = 24 + 2 + 4
# the scalar parameters: dt, v_ref, the path and velocity weights, lambda,
# the colouring beta and the elite threshold; full_body also the ZMP,
# roll-rate, backward and yaw weights, the reference's first yaw, the mass,
# the CoM height, three inertias and gravity
SCALARS = {"tracking": 7, "full_body": 18}


def per_sample(model: str, horizon: int, num_ref: int, second_moment: bool = False,
               rng: bool = True, accumulate: bool = True,
               costs_in: bool = False) -> dict:
    """Operations of one sample, by category (the module docstring)."""
    s_dim, u_dim = DIMS[model]
    tm1 = horizon - 1
    nu = tm1 * u_dim
    pairs = (u_dim + 1) // 2
    work = {"philox": 0, "box_muller": 0, "sample": u_dim * (7 * tm1 - 3),
            "rollout": 0, "cost": 0, "update": 0}
    if rng:
        work["philox"] = PHILOX_CALL * pairs * tm1
        work["box_muller"] = BOX_MULLER_PAIR * pairs * tm1
    if not costs_in:
        scan = 8 + 5 * num_ref + 1
        if model == "full_body":
            terms = horizon - 2
            work["rollout"] = (horizon - 3) * STEP[model]
            work["cost"] = terms * (scan + 3 + BODY) + 3 + 10
        else:
            work["rollout"] = tm1 * STEP[model]
            work["cost"] = horizon * scan + 3 * tm1 + 3
    if accumulate:
        work["update"] = 7 + (4 if second_moment else 2) * nu
    return work


def kernel_work(model: str, num_samples: int, horizon: int, num_ref: int = None,
                second_moment: bool = False, rng: bool = True, num_robots: int = 1,
                accumulate: bool = True, costs_in: bool = False) -> dict:
    """{"flops", "int_ops", "bytes"} of one launch over ``num_robots``
    robots of ``num_samples`` samples (``num_ref`` defaults to the
    horizon, the resampled window's length)."""
    num_ref = horizon if num_ref is None else num_ref
    s_dim, u_dim = DIMS[model]
    nu = (horizon - 1) * u_dim
    work = per_sample(model, horizon, num_ref, second_moment, rng, accumulate, costs_in)
    samples = num_samples * num_robots
    scalars = SCALARS["full_body" if model == "full_body" else "tracking"]
    floats = num_robots * (nu + 2 * num_ref + s_dim + scalars) + 3 * u_dim + samples
    if not rng:
        floats += samples * nu
    if accumulate:
        floats += num_robots * ((2 if second_moment else 1) * nu + 1)
    return {"flops": samples * (sum(work.values()) - work["philox"]),
            "int_ops": samples * work["philox"], "bytes": 4 * floats}


def bound_ms(work: dict):
    """(ms, by): the least time an H100 SXM at 700 W takes for ``work``,
    the larger of its operations over their peak rate and its bytes over
    the memory rate; ``by`` is "operations" or "bytes"."""
    ops = max(work["flops"] / FP32_PEAK, work["int_ops"] / INT32_PEAK)
    mem = work["bytes"] / HBM_BYTES_PER_S
    return (max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes")


def update_work(model: str, num_samples: int, horizon: int, elite: bool = False,
                num_robots: int = 1) -> dict:
    """The kernels' work in one RNG-mode control update: one launch, or
    with two-pass elite the costs-only pass plus the costs-in pass."""
    if not elite:
        return kernel_work(model, num_samples, horizon, num_robots=num_robots)
    one = kernel_work(model, num_samples, horizon, accumulate=False)
    two = kernel_work(model, num_samples, horizon, costs_in=True)
    return {k: one[k] + two[k] for k in one}
