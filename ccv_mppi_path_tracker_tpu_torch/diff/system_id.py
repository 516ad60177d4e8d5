"""Dynamics-parameter system identification by backprop through rollouts
(port of ``diff/system_id.py``).

Given observed transitions of a plant, fit differentiable dynamics
parameters by Adam on the state prediction error:

- :class:`ControlGains`: per-channel actuator gains on the commanded
  controls (droop or scaling miscalibration of the kinematic models);
- ``FullBodyParams`` (mass and CoM height) against an observed ZMP trace.

The fits are Python loops over ``torch.optim.Adam`` steps, which is optax's
``adam`` formula with its defaults. Each step's loss is recorded before its
update, as the JAX package's scans record it. The JAX functions' data-parallel
``axis_name`` (a gradient all-reduce across shards) has no counterpart yet:
it waits for the port's ``parallel/``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams, zmp_chain
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model


@dataclasses.dataclass
class ControlGains:
    gains: torch.Tensor  # (U,)


def gained_step(model_name: str):
    """Model step with learnable control gains: u_eff = gains * u."""
    step = get_model(model_name).step

    def f(params: ControlGains, state, u, dt):
        return step(state, u * params.gains, dt)

    return f


def prediction_loss(model_name, params, states_t, controls_t, states_t1, dt):
    """Mean one-step prediction error over a batch of observed transitions."""
    err = gained_step(model_name)(params, states_t, controls_t, dt) - states_t1
    return torch.mean(torch.sum(err * err, dim=-1))


def _adam_fit(loss_fn, leaves, num_steps, learning_rate):
    """Adam on the tensors ``leaves`` (copied; the inputs are not changed).
    Returns (fitted leaves, the (num_steps,) losses before each update)."""
    leaves = [t.detach().clone() for t in leaves]
    opt = torch.optim.Adam(leaves, lr=learning_rate)
    value_and_grad = torch.func.grad_and_value(lambda ls: loss_fn(*ls))
    losses = []
    for _ in range(num_steps):
        grads, loss = value_and_grad(leaves)
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()
        losses.append(loss)
    return leaves, torch.stack(losses)


def fit_control_gains(
    model_name: str,
    states_t,
    controls_t,
    states_t1,
    dt,
    num_steps: int = 300,
    learning_rate: float = 0.1,
    init: Optional[ControlGains] = None,
):
    """Recover per-channel control gains from observed transitions.
    Returns (ControlGains, losses (num_steps,))."""
    if init is None:
        init = ControlGains(gains=torch.ones(controls_t.shape[-1], dtype=states_t.dtype,
                                             device=states_t.device))
    (gains,), losses = _adam_fit(
        lambda g: prediction_loss(model_name, ControlGains(g), states_t, controls_t,
                                  states_t1, dt),
        [init.gains], num_steps, learning_rate)
    return ControlGains(gains=gains), losses


def rollout_prediction_loss(model_name, params, state0, controls, observed, dt):
    """Multi-step prediction error: roll the gained model from ``state0``
    (B, S) under ``controls`` (T-1, B, U) and take the MSE against the
    observed trajectory ``observed`` (T-1, B, S). Backprop runs through the
    whole rollout."""
    step = gained_step(model_name)
    s, pred = state0, []
    for u in controls:
        s = step(params, s, u, dt)
        pred.append(s)
    err = torch.stack(pred) - observed
    return torch.mean(torch.sum(err * err, dim=-1))


def rollout_prediction_value_and_grad(model_name, params: ControlGains, state0, controls,
                                      observed, dt, num_chunks: int = 1):
    """Loss and gradient of :func:`rollout_prediction_loss` with respect to
    ``params.gains``, the batch split into ``num_chunks`` equal buckets.

    Each bucket's sum of squared errors and its gradient are taken on their
    own and added up, then scaled by 1/(T-1)/B: the bucketed gradient of the
    JAX package, whose per-bucket all-reduce overlaps the next bucket's
    backward across shards. Up to the order of the float additions the result
    does not depend on ``num_chunks``. Returns (loss, ControlGains of the
    gradient).
    """
    b = state0.shape[0]
    if b % num_chunks:
        raise ValueError(f"batch {b} does not split into {num_chunks} equal chunks")
    csz = b // num_chunks
    step = gained_step(model_name)

    def chunk_loss(gains, sl):
        s, pred = state0[sl], []
        for u in controls[:, sl]:
            s = step(ControlGains(gains), s, u, dt)
            pred.append(s)
        err = torch.stack(pred) - observed[:, sl]
        return torch.sum(err * err)

    loss = torch.zeros((), dtype=state0.dtype, device=state0.device)
    grad = torch.zeros_like(params.gains)
    for i in range(num_chunks):
        sl = slice(i * csz, (i + 1) * csz)
        g_i, l_i = torch.func.grad_and_value(chunk_loss)(params.gains, sl)
        loss = loss + l_i
        grad = grad + g_i
    scale = 1.0 / (controls.shape[0] * b)
    return loss * scale, ControlGains(gains=grad * scale)


def zmp_loss(params: FullBodyParams, states, controls, observed_zmp_y, dt):
    """MSE of the predicted vs the observed lateral ZMP over rollouts:
    states (T, B, 5), controls (T-1, B, 5), observed_zmp_y (T-2, B)."""
    err = zmp_chain(states, controls, dt, params)[..., 1] - observed_zmp_y
    return torch.mean(err * err)


def fit_full_body_params(
    states,
    controls,
    observed_zmp_y,
    dt,
    init: FullBodyParams,
    num_steps: int = 300,
    learning_rate: float = 0.02,
):
    """Fit (mass, base2com) of the ZMP model; inertia and gravity are held.

    The JAX package runs Adam over every field with the other gradients
    zeroed; Adam moves nothing on a zero gradient, so optimizing the two
    trained fields alone is the same fit. Returns (FullBodyParams, losses).
    """
    (mass, base2com), losses = _adam_fit(
        lambda m, c: zmp_loss(dataclasses.replace(init, mass=m, base2com=c), states,
                              controls, observed_zmp_y, dt),
        [init.mass, init.base2com], num_steps, learning_rate)
    return dataclasses.replace(init, mass=mass, base2com=base2com), losses
