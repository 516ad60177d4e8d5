"""AutoRally's learned dynamics: a 6-32-32-4 tanh network under a kinematic
pose update (Williams et al., "Information Theoretic MPC for Model-Based
Reinforcement Learning", ICRA 2017; the AutoRally code's
``autorally_control/include/autorally_control/path_integral/neural_net_model.cuh``,
``NeuralNetModel<7,2,3,6,32,32,4>``).

State (x, y, yaw, roll, v_x, v_y, yaw_mder): the pose, the roll, the
body-frame velocities and AutoRally's yaw-rate state, the negated yaw
derivative (its ``computeKinematics``). Controls (steering, throttle), the
chassis commands normalised to [-1, 1]. The derivative:

    x'         = v_x cos(yaw) - v_y sin(yaw)
    y'         = v_x sin(yaw) + v_y cos(yaw)
    yaw'       = -yaw_mder
    (roll', v_x', v_y', yaw_mder')
               = W3 tanh(W2 tanh(W1 [roll, v_x, v_y, yaw_mder, steering, throttle]
                                  + b1) + b2) + b3

with W1 (32, 6), W2 (32, 32), W3 (4, 32), and the Euler step
s' = s + dt * s'. The network's weights are the model's parameters
(:class:`NNParams`), which reach :func:`step` on the eager path
(``Model.rollout``); the fused sampling kernel does not take this model.
Where nothing needs the sampled states, the eager update takes the rollout
and the cost together (``Model.rollout_cost``, :func:`rollout_cost`): on the
card one launch of kernels/network_rollout.py.

AutoRally's trained weights are not in this repository, so
:func:`default_params` draws seeded ones (:data:`WEIGHTS`): PyTorch
``Linear``'s init, uniform in +-1/sqrt(fan_in), drawn in float32 on the CPU
by one ``torch.Generator`` in the order W1, b1, W2, b2, W3, b3, the output
layer times ``output_scale``. The scale is 1: a zero-control rollout from
rest then stays within |v_x| 0.14 m/s, |v_y| 0.61 m/s and |yaw_mder| 0.60
rad/s over T=30 steps of dt 0.1, and under any controls each derivative of
the network is at most sum_j |W3_ij| + |b3_i| (this draw: 2.75, 2.86, 2.76
and 2.18), so no rollout of that horizon leaves |v_x|, |v_y| < 8.3 m/s or
|yaw_mder| < 6.4 rad/s.

The cost (:func:`cost`) is the CCV tracking cost with the speed read from the
state: path_weight * sum_{t<T} min_j |p_t - ref_j|^2 (ops/mindist.py) +
v_weight * sum_{0<t<T} (v_x,t - v_ref)^2.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.kernels import network_rollout
from ccv_mppi_path_tracker_tpu_torch.models.base import Model
from ccv_mppi_path_tracker_tpu_torch.models.registry import register_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import sums_over_time
from ccv_mppi_path_tracker_tpu_torch.ops.mindist import min_sq_distance
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

# (in, out) of the three layers, as NeuralNetModel<7,2,3,6,32,32,4> has them
LAYERS = ((6, 32), (32, 32), (32, 4))
# How default_params draws the weights; benchmark/configs/autorally_nn-*.json
# states the same numbers.
WEIGHTS = {"seed": 20170529, "order": ["w1", "b1", "w2", "b2", "w3", "b3"],
           "output_scale": 1.0}
# the network's evaluations, counted once a rollout (utils/profiling.py);
# kernels/network_rollout.py adds to it too, and to its own FUSED
COUNTERS = network_rollout.COUNTERS


@dataclasses.dataclass
class NNParams:
    """The network's weights: w (out, in) and b (out,) of each layer."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor


def draw_weights() -> NNParams:
    """The seeded weights of :data:`WEIGHTS`, float32 on the CPU."""
    g = torch.Generator().manual_seed(WEIGHTS["seed"])
    drawn = []
    for n, (fan_in, fan_out) in enumerate(LAYERS):
        bound = 1.0 / fan_in ** 0.5
        scale = WEIGHTS["output_scale"] if n == len(LAYERS) - 1 else 1.0
        for shape in ((fan_out, fan_in), (fan_out,)):
            u = torch.rand(shape, generator=g, dtype=torch.float32)
            drawn.append((u * 2.0 - 1.0) * bound * scale)
    return NNParams(*drawn)


# (device, dtype) -> NNParams, made once, so that a CUDA graph captured
# around the network reads the same tensors at every replay
_CACHE: dict = {}


def default_params(device=None, dtype=torch.float32) -> NNParams:
    """The seeded weights on ``device`` (None: the card) in ``dtype``, made
    once a device and dtype. On the card they go up through pinned memory
    without a wait, so that the first run of a compiled step (under torch's
    sync debug mode "error", utils/cuda_graph.py) may make them."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    params = _CACHE.get((device, dtype))
    if params is None:
        host = draw_weights()
        fields = {}
        for f in dataclasses.fields(host):
            t = getattr(host, f.name).to(dtype)
            fields[f.name] = (t.pin_memory().to(device, non_blocking=True)
                              if device.type == "cuda" else t.to(device))
        params = _CACHE[(device, dtype)] = NNParams(**fields)
    return params


def network(state, u, params: NNParams):
    """The derivatives (roll', v_x', v_y', yaw_mder') (..., 4) of states
    (..., 7) under controls (..., 2)."""
    x = torch.cat([state[..., 3:], u], dim=-1)
    h = torch.tanh(F.linear(x, params.w1, params.b1))
    h = torch.tanh(F.linear(h, params.w2, params.b2))
    return F.linear(h, params.w3, params.b3)


def kinematics(state):
    """The pose derivatives (x', y', yaw') (..., 3) of states (..., 7)."""
    yaw, vx, vy, r = state[..., 2], state[..., 4], state[..., 5], state[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([vx * c - vy * s, vx * s + vy * c, -r], dim=-1)


def step(state, u, dt, params: NNParams = None):
    """One Euler step; ``params`` None: :func:`default_params`."""
    if params is None:
        params = default_params(state.device, state.dtype)
    return state + torch.cat([kinematics(state), network(state, u, params)], dim=-1) * dt


def euler_states(state0, controls, dt, params: NNParams):
    """The sequential Euler rollout of controls (T-1, ..., 2) from state0
    (..., 7) under ``params``: states (T, ..., 7), op by op."""
    states = [state0]
    for u in controls:
        states.append(step(states[-1], u, dt, params))
    return torch.stack(states)


def rollout(state0, controls, dt, params: NNParams = None):
    """The sequential Euler rollout of controls (T-1, ..., 2) from state0
    (..., 7) under ``params`` (None: :func:`default_params`): states (T, ...,
    7). The device counter ``model.nn_evals`` adds the network's
    evaluations, one a sample and step, in one launch (a graph's replay adds
    them again)."""
    if params is None:
        params = default_params(state0.device, state0.dtype)
    states = euler_states(state0, controls, dt, params)
    if profiling.device_counting(states):
        evals = profiling.device_constant(controls[..., 0].numel(), torch.int64,
                                          states.device)
        if evals is not None:
            profiling.count_on_device(COUNTERS, evals)
    return states


def states_cost(states, ref_xy, cp):
    """(K,) costs of states (T, K, 7) against the window ref_xy (R, 2): the
    path term over all T states and the speed term over states 1 ... T-1,
    whose v_x the controls set."""
    d2 = min_sq_distance(states[..., :2], ref_xy)
    dv = states[1:, ..., 4] - cp.v_ref
    return (cp.path_weight * sums_over_time(d2)[0]
            + cp.v_weight * sums_over_time(dv * dv)[0])


def cost(states, controls, aux, ref, cp):
    """The model's ``cost_fn``: :func:`states_cost` against ``ref.xy``."""
    return states_cost(states, ref.xy, cp)


def _on_card(t) -> bool:
    return t.is_cuda


def _fused_operands(state0, controls, dt, params, ref, cp):
    """The operands of kernels/network_rollout.py network_rollout_cost for
    this call, each contiguous (a number dt made a tensor), or None where the
    rollout and cost run op by op: off the card, a start state that is not
    one state expanded over the samples, another dtype or shape, an input
    that requires grad, or a ``torch.func`` transform (a fleet's vmap)."""
    if not (_on_card(controls) and profiling.device_counting(state0, controls)
            and state0.dim() == 2 and controls.dim() == 3
            and state0.shape[0] == controls.shape[1]
            and (state0.stride(0) == 0 or state0.shape[0] == 1)):
        return None
    if not isinstance(dt, torch.Tensor):
        dt = torch.full((), dt, dtype=controls.dtype, device=controls.device)
    args = (state0[0], controls, dt, params, ref.xy, cp)
    if not network_rollout.takes(*args):
        return None
    weights = [getattr(params, n) for n in network_rollout.WEIGHT_NAMES]
    if not profiling.device_counting(dt, ref.xy, *weights,
                                     *(getattr(cp, n) for n in network_rollout.COST_NAMES)):
        return None
    return (*[t.contiguous() for t in args[:3]],
            NNParams(*[w.contiguous() for w in weights]), ref.xy.contiguous(),
            dataclasses.replace(cp, **{n: getattr(cp, n).contiguous()
                                       for n in network_rollout.COST_NAMES}))


def rollout_cost(state0, controls, dt, params, ref, cp):
    """The model's ``rollout_cost`` hook: the (K,) costs of the samples'
    rollouts, ``cost(rollout(state0, controls, dt, params), ...)``, without
    the states. Where the kernel takes the call (:func:`_fused_operands`:
    float32 CUDA tensors, the start state one state expanded over the K
    samples, controls (T-1, K, 2), the weights of :data:`LAYERS`' shapes,
    nothing that requires grad, no transform) it is one launch of
    kernels/network_rollout.py, which adds K·(T-1) to the device counters
    ``model.nn_evals`` and ``model.nn_fused``; elsewhere, the CPU, float64,
    grad, a vmapped fleet and other shapes, it is that composition op by op,
    which adds to ``model.nn_evals`` only."""
    if params is None:
        params = default_params(state0.device, state0.dtype)
    operands = _fused_operands(state0, controls, dt, params, ref, cp)
    if operands is None:
        return cost(rollout(state0, controls, dt, params), controls, {}, ref, cp)
    device = controls.device
    return network_rollout.network_rollout_cost(
        *operands, evals=profiling.device_group(COUNTERS, device),
        fused=profiling.device_group(network_rollout.FUSED, device))


MODEL = register_model(
    Model(
        name="autorally_nn",
        state_names=("x", "y", "yaw", "roll", "v_x", "v_y", "yaw_mder"),
        control_names=("steering", "throttle"),
        step=step,
        default_params=default_params,
        cost_fn=cost,
        rollout=rollout,
        rollout_cost=rollout_cost,
    )
)
