"""Differentiable MPPI: gradients through the rollout (port of
``diff/gradients.py``).

The Euler rollout, the ZMP chain and the min-distance cost are torch ops, so

- d(cost)/d(controls) flows through the rollout for gradient-refined updates
  (the sampled MPPI update followed by a few projected-gradient or
  Gauss-Newton steps, ``mppi_step(refine_steps=...)``);
- d(cost)/d(dynamics params) drives system identification
  (diff/system_id.py).

The refinements take the gradient by reverse mode (``torch.autograd.grad``
under ``enable_grad``) and the Gauss-Newton Jacobian by forward mode
(``torch.autograd.forward_ad``, all basis directions in one batched pass),
so a refined ``mppi_step`` runs from any grad mode; the functions built here
are plain tensor functions that ``torch.func`` transforms as well. The
refinement reads nothing back to the host: the
Levenberg-Marquardt accept and the damping stay 0-d tensors under
``torch.where``, and the normal equations are solved by ``cholesky_ex`` and
``cholesky_solve``, which check no error on the host. The steps taken and
accepted are device counters of utils/profiling.py (``refine.lm_steps``,
``refine.lm_accepted``), added to at the stage's end in three launches,
which a CUDA graph of the stage replays.

On the card, the Gauss-Newton steps of a full_body sequence in float32, where
nothing requires grad and no ``torch.func`` transform is active, run as one
launch of the hand-written kernel kernels/gauss_newton.py, which adds to the
same counters and to ``refine.fused_steps`` itself; everywhere else (the CPU,
the other models, grad, transforms, a horizon past the kernel's shared memory)
they run op by op (:func:`gauss_newton_refine_plain`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.kernels import gauss_newton as gn_kernel
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.mindist import min_sq_distance
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import (
    CLOSED_FORM_MODELS,
    model_rollout,
    rollout_closed_form,
)
from ccv_mppi_path_tracker_tpu_torch.utils import profiling


# the device counters of the Gauss-Newton stage (utils/profiling.py)
COUNTERS = ("refine.lm_steps", "refine.lm_accepted")


def _params(model, model_params, like):
    if model_params is None and model.default_params is not None:
        return model.default_params(device=like.device, dtype=like.dtype)
    return model_params


def _rollout(cfg, model, state, u, dt, model_params=None):
    """The rollout of a batch u (T-1, B, U) from one state (S,): the closed
    form where the model has one, as the sampled solver's eager path rolls
    out, else the sequential Euler recurrence (ops/rollout.py model_rollout,
    under ``model_params``). The JAX package's refinement
    rolls out sequentially; the two agree to round-off, and the closed form
    is tens of tensor calls where the recurrence is hundreds, which on the
    card is what a refinement's time is made of."""
    state0 = state.expand(u.shape[1], -1)
    if cfg.model in CLOSED_FORM_MODELS:
        return rollout_closed_form(cfg.model, state0, u, dt)
    return model_rollout(model, state0, u, dt, model_params)


def make_trajectory_cost(cfg: SolverConfig):
    """A differentiable scalar cost of ONE control sequence:
    ``cost(u_seq (T-1, U), state (S,), ref, dt, cp, model_params=None)``.

    It runs the sampled solver's cost with K=1 and ``trajectory_costs``, so a
    registered model's ``cost_fn`` is what refinement differentiates.
    """
    model = get_model(cfg.model)

    def cost_fn(u_seq, state, ref: RefWindow, dt, cp: CostParams, model_params=None):
        model_params = _params(model, model_params, u_seq)
        u = u_seq[:, None, :]  # (T-1, 1, U)
        states = _rollout(cfg, model, state, u, dt, model_params)
        aux = {}
        if model.aux_from_rollout is not None:
            aux = model.aux_from_rollout(states, u, dt, model_params)
        return trajectory_costs(cfg.model, states, u, aux, ref, cp)[0]

    return cost_fn


def _batched_residuals(cfg: SolverConfig):
    """Residuals of a batch of control sequences: ``res(u (T-1, B, U),
    state (S,), ref, dt, cp, model_params) -> (B, m)``, each row the
    :func:`make_trajectory_residuals` vector of one sequence."""
    model = get_model(cfg.model)
    eps = 1e-12  # smooths sqrt(d^2) at d = 0

    def res(u, state, ref: RefWindow, dt, cp: CostParams, model_params=None):
        model_params = _params(model, model_params, u)
        states = _rollout(cfg, model, state, u, dt, model_params)
        if cfg.model == "full_body":
            zmp_y = model.aux_from_rollout(states, u, dt, model_params)["zmp"][..., 1]
            tm2 = states.shape[0] - 2
            d = torch.sqrt(min_sq_distance(states[:tm2, :, :2], ref.xy) + eps)
            v = u[:tm2, :, 0]
            roll_v = u[..., 3]
            droll_v = roll_v[1:tm2 + 1] - roll_v[:tm2]
            back = torch.minimum(v, torch.zeros_like(v))
            dyaw0 = states[0, :, 2] - ref.yaw[0]
            rows = [
                torch.sqrt(cp.path_weight) * d,
                torch.sqrt(cp.v_weight) * (v - cp.v_ref),
                torch.sqrt(cp.zmp_weight) * zmp_y,
                torch.sqrt(cp.roll_v_weight) * droll_v,
                torch.sqrt(cp.back_weight) * back,
                torch.sqrt(cp.yaw_weight) * dyaw0[None],
            ]
        else:
            d = torch.sqrt(min_sq_distance(states[..., :2], ref.xy) + eps)
            rows = [torch.sqrt(cp.path_weight) * d,
                    torch.sqrt(cp.v_weight) * (u[..., 0] - cp.v_ref)]
        return torch.cat(rows).T

    return res


def make_trajectory_residuals(cfg: SolverConfig):
    """The least-squares residuals of ONE control sequence of a built-in
    model: ``cost(u) == sum(residuals(u)**2)``. Path distance and velocity
    error, and for full_body ZMP-y, the roll-rate change, the backward term
    min(v, 0) and the initial-yaw error, each times the square root of its
    weight: the structure Gauss-Newton uses.

    ``min(v, 0)`` is ``torch.minimum``, whose derivative at v = 0 is 1/2 as
    ``jnp.minimum``'s is: a zero warm start sits on that tie.

    Returns ``residuals(u_seq (T-1, U), state, ref, dt, cp, model_params=None)
    -> (m,)``.
    """
    res = _batched_residuals(cfg)

    def res_fn(u_seq, state, ref: RefWindow, dt, cp: CostParams, model_params=None):
        return res(u_seq[:, None, :], state, ref, dt, cp, model_params)[0]

    return res_fn


def _residuals_and_jacobian(res, u, *args):
    """(r (m,), J (m, n)) of the batched residuals ``res`` at u (T-1, U), n =
    (T-1)*U, by forward mode: one pass over n copies of u whose tangents are
    the standard basis, the directional derivatives of ``jacfwd`` computed
    as one batch (no per-op transform layers, which cost more host time a
    call on the card than the launch itself)."""
    tm1, u_dim = u.shape
    n = tm1 * u_dim
    basis = torch.eye(n, dtype=u.dtype, device=u.device).reshape(n, tm1, u_dim)
    with fwAD.dual_level():
        dual = fwAD.make_dual(u[:, None, :].expand(tm1, n, u_dim).contiguous(),
                              basis.transpose(0, 1).contiguous())
        out = fwAD.unpack_dual(res(dual, *args))
    return out.primal[0], out.tangent.T


def gauss_newton_refine(
    cfg: SolverConfig,
    u_opt,
    state,
    ref: RefWindow,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    num_steps: int = 3,
    damping: float = 1e-3,
):
    """Polish the sampled update with damped Gauss-Newton steps: solve
    ``(J^T J + damping*I) delta = J^T r`` with J = d(residuals)/d(u) by
    forward mode through the rollout, then project to the control box.

    Levenberg-Marquardt guarded: a step that does not lower the cost is
    rejected and the damping multiplied by 10; an accepted one halves it.
    So refinement never raises the cost of the sampled update. A quadratic
    cost lands in one step where first-order refinement needs many
    (PAPERS.md: "Gauss-Newton accelerated MPPI Control").

    The device counters ``refine.lm_steps`` and ``refine.lm_accepted``
    count the steps and the accepts, except under a ``torch.func``
    transform and where an input requires grad (profiling.device_counting).

    Where the kernel takes the call (:func:`_fused_inputs`: full_body,
    float32 CUDA tensors of a shape that fits its shared memory, nothing that
    requires grad, no transform) the steps are one launch of
    kernels/gauss_newton.py, which also counts them in
    ``refine.fused_steps``; elsewhere they run op by op
    (:func:`gauss_newton_refine_plain`).
    """
    fused = _fused_inputs(cfg, u_opt, state, ref, dt, sp, cp, model_params, num_steps)
    if fused is None:
        return gauss_newton_refine_plain(cfg, u_opt, state, ref, dt, sp, cp, model_params,
                                         num_steps, damping)
    return gn_kernel.gauss_newton_steps(
        *fused, num_steps, damping,
        counts=profiling.device_group(gn_kernel.COUNTERS, u_opt.device),
        fused=profiling.device_group(gn_kernel.FUSED, u_opt.device))


def _contiguous(params):
    return dataclasses.replace(params, **{f.name: getattr(params, f.name).contiguous()
                                          for f in dataclasses.fields(params)})


def _on_card(t) -> bool:
    return t.is_cuda


def _fused_inputs(cfg, u_opt, state, ref, dt, sp, cp, model_params, num_steps):
    """The operands of kernels/gauss_newton.py gauss_newton_steps for this
    call, each contiguous (a number dt made a tensor), or None where the
    steps run op by op: off the card, another model or dtype, a shape the
    kernel has no plan for, an input that requires grad, or a transform."""
    if not (_on_card(u_opt) and cfg.model == "full_body" and u_opt.dtype == torch.float32):
        return None
    if not isinstance(dt, torch.Tensor):
        dt = torch.full((), dt, dtype=u_opt.dtype, device=u_opt.device)
    mp = _params(get_model(cfg.model), model_params, u_opt)
    args = (u_opt, state, ref.xy, ref.yaw, dt, sp.u_min, sp.u_max)
    if not gn_kernel.takes(*args, cp, mp, num_steps):
        return None
    params = [getattr(p, f.name) for p in (cp, mp) for f in dataclasses.fields(p)]
    if not profiling.device_counting(*args, *params):
        return None
    return (*[t.contiguous() for t in args], _contiguous(cp), _contiguous(mp))


def gauss_newton_steps_plain(cfg, u_opt, state, ref, dt, u_min, u_max, cp, model_params,
                             num_steps, damping):
    """The guarded steps op by op: (u, [each step's accept, a 0-d bool
    tensor], r0 the residuals at u_opt)."""
    res = _batched_residuals(cfg)
    args = (state, ref, dt, cp, model_params)

    def f(u):
        return res(u[:, None, :], *args)[0]

    eye = torch.eye(u_opt.numel(), dtype=u_opt.dtype, device=u_opt.device)
    r0 = f(u_opt)
    u, cost = u_opt, torch.sum(r0 * r0)
    lam = torch.full((), damping, dtype=u_opt.dtype, device=u_opt.device)
    accepts = []
    for _ in range(num_steps):
        r, jac = _residuals_and_jacobian(res, u, *args)
        # J^T J + lam*I is symmetric positive definite: Cholesky, with no
        # error check read back to the host (a factorization that fails on
        # round-off gives a NaN step, which the guard below rejects)
        chol, _ = torch.linalg.cholesky_ex(jac.T @ jac + lam * eye)
        delta = torch.cholesky_solve((jac.T @ r)[:, None], chol)[:, 0]
        u_new = torch.clamp(u - delta.reshape(u.shape), u_min, u_max)
        r_new = f(u_new)
        cost_new = torch.sum(r_new * r_new)
        accept = cost_new < cost
        u = torch.where(accept, u_new, u)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * 0.5, lam * 10.0)
        accepts.append(accept)
    return u, accepts, r0


def gauss_newton_refine_plain(cfg, u_opt, state, ref, dt, sp, cp, model_params=None,
                              num_steps=3, damping=1e-3):
    """:func:`gauss_newton_refine` op by op (forward-mode AD, matmuls,
    ``cholesky_ex``/``cholesky_solve``, ``torch.where``), the steps and the
    accepts counted at the end."""
    u, accepts, r0 = gauss_newton_steps_plain(cfg, u_opt, state, ref, dt, sp.u_min, sp.u_max,
                                              cp, model_params, num_steps, damping)
    counting = accepts and profiling.device_counting(u_opt, r0)
    true = profiling.device_constant(True, torch.bool, u_opt.device) if counting else None
    if true is not None:
        # [steps, accepted] in three launches: the stack; a sum that stays in
        # uint8, since an int64 sum of bools first casts them; the add
        taken = torch.stack([x for a in accepts for x in (true, a)])
        small = torch.uint8 if num_steps < 256 else torch.int64
        increments = taken.view(torch.uint8).view(-1, 2).sum(0, dtype=small)
        profiling.count_on_device(COUNTERS, increments)
    return u


def gradient_refine(
    cfg: SolverConfig,
    u_opt,
    state,
    ref: RefWindow,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    step_size: float = 0.05,
    num_steps: int = 5,
):
    """Polish the sampled update with projected gradient descent:
    u <- clip(u - step_size * dJ/du, bounds), the box of sampling. The
    gradient is reverse mode (``torch.autograd.grad``, under
    ``enable_grad``); the refined sequence carries no graph."""
    cost_fn = make_trajectory_cost(cfg)
    u = u_opt.detach()
    for _ in range(num_steps):
        with torch.enable_grad():
            v = u.requires_grad_(True)
            (g,) = torch.autograd.grad(cost_fn(v, state, ref, dt, cp, model_params), v)
        u = torch.clamp(v.detach() - step_size * g, sp.u_min, sp.u_max)
    return u
