"""Dynamics-parameter system identification by backprop through rollouts
(port of ``diff/system_id.py``).

Given observed transitions of a plant, fit differentiable dynamics
parameters by Adam on the state prediction error:

- :class:`ControlGains`: per-channel actuator gains on the commanded
  controls (droop or scaling miscalibration of the kinematic models);
- ``FullBodyParams`` (mass and CoM height) against an observed ZMP trace.

The fits are scans of one Adam step (diff/optim.py: ``optax.adam``'s
arithmetic, the parameters and the optimizer state carried as plain
tensors), the JAX package's ``lax.scan`` of its steps: on the card one CUDA
graph replayed a step, on the CPU the same step eagerly. Each step's loss is
recorded before its update, as the JAX package's scans record it.

Every function is data-parallel over ``group`` (a ``torch.distributed``
process group; each rank holds an equal share of the batch), the JAX
package's ``axis_name``: the losses are the mean over every rank's data, and
the fits average each step's gradient across the ranks, so every rank takes
the same Adam step and the fit equals the one-process fit on the whole
batch. The all-reduce carries values, not gradients: a loss called with a
group is the global value; its gradient is taken of the local loss and
all-reduced, as the fits and :func:`rollout_prediction_value_and_grad` do.
With a group whose collectives run over NCCL the fits and the chunked
gradient replay one graph on the card, the all-reduces inside it; over gloo,
whose collectives copy through the host, they run op by op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ccv_mppi_path_tracker_tpu_torch.diff.optim import Program, adam_init, adam_update
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams, zmp_chain
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import Graphed, collectives_capturable


@dataclasses.dataclass
class ControlGains:
    gains: torch.Tensor  # (U,)


def gained_step(model_name: str):
    """Model step with learnable control gains: u_eff = gains * u."""
    step = get_model(model_name).step

    def f(params: ControlGains, state, u, dt):
        return step(state, u * params.gains, dt)

    return f


def _mean_over(group, *values):
    """The mean over the ranks of ``group`` of each tensor in ``values``, in
    one all-reduce; the values themselves with ``group`` None."""
    if group is None:
        return values
    flat = torch.cat([v.detach().reshape(-1) for v in values])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat / dist.get_world_size(group)
    out, i = [], 0
    for v in values:
        out.append(flat[i:i + v.numel()].reshape(v.shape))
        i += v.numel()
    return tuple(out)


def _graphable(group) -> bool:
    """Whether a program with ``group`` replays its graph on the card: no
    group, or one whose collectives a graph can hold (NCCL)."""
    return group is None or collectives_capturable(group)


def prediction_loss(model_name, params, states_t, controls_t, states_t1, dt, group=None):
    """Mean one-step prediction error over a batch of observed transitions
    (with ``group``: over every rank's batch)."""
    err = gained_step(model_name)(params, states_t, controls_t, dt) - states_t1
    loss = torch.mean(torch.sum(err * err, dim=-1))
    return _mean_over(group, loss)[0]


def _adam_step(loss_fn, carry, learning_rate, group):
    """One Adam step of ``loss_fn(*params)`` from ``carry`` (params, Adam
    state), the local loss and gradient averaged over ``group``: (the next
    carry, the loss before the update)."""
    params, state = carry
    grads, loss = torch.func.grad_and_value(lambda ps: loss_fn(*ps))(params)
    loss, *grads = _mean_over(group, loss, *grads)
    return adam_update(params, grads, state, learning_rate), loss


def _gains_step(carry, model_name, states_t, controls_t, states_t1, dt, learning_rate,
                group):
    """:func:`fit_control_gains`' step, carry ((gains,), Adam state)."""
    return _adam_step(
        lambda g: prediction_loss(model_name, ControlGains(g), states_t, controls_t,
                                  states_t1, dt),
        carry, learning_rate, group)


def _zmp_step(carry, init, states, controls, observed_zmp_y, dt, learning_rate, group):
    """:func:`fit_full_body_params`' step, carry ((mass, base2com), Adam
    state); the other fields of ``init`` are held."""
    return _adam_step(
        lambda m, c: zmp_loss(dataclasses.replace(init, mass=m, base2com=c), states,
                              controls, observed_zmp_y, dt),
        carry, learning_rate, group)


# The compiled programs: on the card one CUDA graph per shape set and
# constants a process runs (least recently used dropped first).
GAINS_FIT = Graphed(_gains_step, max_graphs=8)
ZMP_FIT = Graphed(_zmp_step, max_graphs=8)


def _fit_program(graphed, leaves, num_steps, *fixed) -> Program:
    """The scan of ``graphed``'s step over ``num_steps`` from the tensors
    ``leaves`` (copied: the inputs are not changed) and a fresh Adam state."""
    leaves = tuple(t.detach().clone() for t in leaves)
    return Program(graphed, ((leaves, adam_init(leaves)),) + fixed, num_steps)


def fit_control_gains(
    model_name: str,
    states_t,
    controls_t,
    states_t1,
    dt,
    num_steps: int = 300,
    learning_rate: float = 0.1,
    init: Optional[ControlGains] = None,
    group=None,
):
    """Recover per-channel control gains from observed transitions (this
    rank's share of them with ``group``). Returns (ControlGains, losses
    (num_steps,)). On the card without a group or over NCCL: one CUDA graph
    of the Adam step, replayed ``num_steps`` times."""
    ((gains,), _), losses = _fit_control_gains_program(
        model_name, states_t, controls_t, states_t1, dt, num_steps, learning_rate, init,
        group)(graph=_graphable(group))
    return ControlGains(gains=gains), losses


def _fit_control_gains_program(model_name, states_t, controls_t, states_t1, dt,
                               num_steps=300, learning_rate=0.1, init=None,
                               group=None) -> Program:
    """:func:`fit_control_gains`' scan, not yet run."""
    if init is None:
        init = ControlGains(gains=torch.ones(controls_t.shape[-1], dtype=states_t.dtype,
                                             device=states_t.device))
    return _fit_program(GAINS_FIT, [init.gains], num_steps, model_name, states_t,
                        controls_t, states_t1, dt, learning_rate, group)


def rollout_prediction_loss(model_name, params, state0, controls, observed, dt,
                            group=None):
    """Multi-step prediction error: roll the gained model from ``state0``
    (B, S) under ``controls`` (T-1, B, U) and take the MSE against the
    observed trajectory ``observed`` (T-1, B, S), over every rank's batch
    with ``group``. Backprop runs through the whole rollout."""
    step = gained_step(model_name)
    s, pred = state0, []
    for u in controls:
        s = step(params, s, u, dt)
        pred.append(s)
    err = torch.stack(pred) - observed
    loss = torch.mean(torch.sum(err * err, dim=-1))
    return _mean_over(group, loss)[0]


def rollout_prediction_value_and_grad(model_name, params: ControlGains, state0, controls,
                                      observed, dt, num_chunks: int = 1, group=None):
    """Loss and gradient of :func:`rollout_prediction_loss` with respect to
    ``params.gains``, the batch split into ``num_chunks`` equal buckets.

    Each bucket's sum of squared errors and its gradient are taken on their
    own and added up, then scaled by 1/(T-1)/B. With ``group`` (this rank's
    B of N equal shares), each bucket's loss and gradient are all-reduced
    asynchronously as soon as its backward is done, so the collective
    overlaps the next bucket's backward; all are waited on at the end, and
    the scale is 1/(T-1)/(N*B); the wait is a stream dependency, so over
    NCCL the all-reduces are held in the graph. Without a group or over NCCL,
    on the card every bucket's rollout and backward are one CUDA graph's
    replay; over gloo they run op by op. Up to the order of the float
    additions the result does not depend on ``num_chunks`` or N. Returns
    (loss, ControlGains of the gradient).
    """
    loss, grad = _rollout_gradient_program(model_name, params, state0, controls, observed,
                                           dt, num_chunks, group)(graph=_graphable(group))
    return loss, ControlGains(gains=grad)


def _rollout_gradient_program(model_name, params: ControlGains, state0, controls,
                              observed, dt, num_chunks=1, group=None) -> Program:
    """:func:`rollout_prediction_value_and_grad`'s call, not yet run."""
    if state0.shape[0] % num_chunks:
        raise ValueError(f"batch {state0.shape[0]} does not split into {num_chunks} equal "
                         "chunks")
    return Program(ROLLOUT_GRADIENT, (model_name, params.gains, state0, controls, observed,
                                      dt, num_chunks, group))


def _chunked_value_and_grad(model_name, gains, state0, controls, observed, dt, num_chunks,
                            group):
    """(loss, gradient) of :func:`rollout_prediction_value_and_grad`."""
    b = state0.shape[0]
    csz = b // num_chunks
    step = gained_step(model_name)

    def chunk_loss(gains, sl):
        s, pred = state0[sl], []
        for u in controls[:, sl]:
            s = step(ControlGains(gains), s, u, dt)
            pred.append(s)
        err = torch.stack(pred) - observed[:, sl]
        return torch.sum(err * err)

    buckets, pending = [], []
    for i in range(num_chunks):
        sl = slice(i * csz, (i + 1) * csz)
        g_i, l_i = torch.func.grad_and_value(chunk_loss)(gains, sl)
        bucket = torch.cat([l_i.reshape(1), g_i])
        if group is not None:
            pending.append(dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group,
                                           async_op=True))
        buckets.append(bucket)
    for work in pending:
        work.wait()
    total = buckets[0]
    for bucket in buckets[1:]:
        total = total + bucket
    shards = 1 if group is None else dist.get_world_size(group)
    scale = 1.0 / (controls.shape[0] * b * shards)
    return total[0] * scale, total[1:] * scale


ROLLOUT_GRADIENT = Graphed(_chunked_value_and_grad, max_graphs=8)


def zmp_loss(params: FullBodyParams, states, controls, observed_zmp_y, dt, group=None):
    """MSE of the predicted vs the observed lateral ZMP over rollouts:
    states (T, B, 5), controls (T-1, B, 5), observed_zmp_y (T-2, B); over
    every rank's rollouts with ``group``."""
    err = zmp_chain(states, controls, dt, params)[..., 1] - observed_zmp_y
    loss = torch.mean(err * err)
    return _mean_over(group, loss)[0]


def fit_full_body_params(
    states,
    controls,
    observed_zmp_y,
    dt,
    init: FullBodyParams,
    num_steps: int = 300,
    learning_rate: float = 0.02,
    group=None,
):
    """Fit (mass, base2com) of the ZMP model; inertia and gravity are held.
    With ``group``, each rank holds its share of the rollouts (axis 1).

    The JAX package runs Adam over every field with the other gradients
    zeroed; Adam moves nothing on a zero gradient, so optimizing the two
    trained fields alone is the same fit. Returns (FullBodyParams, losses).
    On the card without a group or over NCCL: one CUDA graph of the Adam
    step, replayed ``num_steps`` times.
    """
    ((mass, base2com), _), losses = _fit_full_body_params_program(
        states, controls, observed_zmp_y, dt, init, num_steps, learning_rate,
        group)(graph=_graphable(group))
    return dataclasses.replace(init, mass=mass, base2com=base2com), losses


def _fit_full_body_params_program(states, controls, observed_zmp_y, dt,
                                  init: FullBodyParams, num_steps=300, learning_rate=0.02,
                                  group=None) -> Program:
    """:func:`fit_full_body_params`' scan, not yet run."""
    return _fit_program(ZMP_FIT, [init.mass, init.base2com], num_steps, init, states,
                        controls, observed_zmp_y, dt, learning_rate, group)
