"""Learned sampling distribution: a neural warm start for MPPI (port of
``diff/learned_sampler.py``).

PAPERS.md "Learning Sampling Distributions for Model Predictive Control":
a state-conditioned proposal mean, so sampling centers on a good sequence
without a warm start (cold start, reset, path switch) instead of the zero or
previous-solution center of the reference (src/diff_drive_mppi.cpp:86-91).

The proposal is a small MLP from the reference window in the robot frame
(invariant to world translation and yaw) to a control sequence, trained by
imitation: solve MPPI from randomized poses, regress the converged update.
At control time its output is the sampling center
(``ControllerState.u_prev``) of the first cycle.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ccv_mppi_path_tracker_tpu_torch.core.config import SolverConfig
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.diff.optim import Program, adam_init, adam_update
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import Graphed


class SamplerNet(nn.Module):
    """MLP: features (..., F) -> flattened (T-1)*U proposal mean, with the
    JAX package's parameter names and layout (w1 (F, H), b1, w2 (H, O), b2)."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)

    @classmethod
    def init(cls, in_dim: int, hidden: int, out_dim: int, generator: torch.Generator,
             dtype=torch.float32):
        """He-initialized weights drawn from ``generator`` on its device,
        zero biases."""
        kw = dict(dtype=dtype, device=generator.device)
        return cls(
            w1=torch.randn((in_dim, hidden), generator=generator, **kw)
            * math.sqrt(2.0 / in_dim),
            b1=torch.zeros(hidden, **kw),
            w2=torch.randn((hidden, out_dim), generator=generator, **kw)
            * math.sqrt(2.0 / hidden),
            b2=torch.zeros(out_dim, **kw),
        )

    def forward(self, feats):
        return _mlp(feats, self.w1, self.b1, self.w2, self.b2)


def _mlp(feats, w1, b1, w2, b2):
    """:class:`SamplerNet`'s function of its weights."""
    return torch.tanh(feats @ w1 + b1) @ w2 + b2


def proposal_features(state, ref: RefWindow):
    """Robot-frame reference window: state (S,) with (x, y, yaw) leading,
    ref xy (T, 2) and yaw (T,). Returns (3T,): the relative points rotated
    into the robot frame, then the wrapped heading errors."""
    c, s = torch.cos(state[2]), torch.sin(state[2])
    rot = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
    rel = (ref.xy - state[:2]) @ rot.T
    dyaw = ref.yaw - state[2]
    dyaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))
    return torch.cat([rel.reshape(-1), dyaw])


def proposal_mean(net: SamplerNet, cfg: SolverConfig, state, ref: RefWindow):
    """State-conditioned sampling center (T-1, U), clipped later by the
    solver."""
    u_dim = get_model(cfg.model).num_controls
    return net(proposal_features(state, ref)).reshape(cfg.horizon - 1, u_dim)


def random_poses(cfg: SolverConfig, course, generator: torch.Generator, num: int,
                 lateral_spread: float = 0.5, yaw_spread: float = 0.5, dtype=torch.float32):
    """(num, S) start states near the course, on the generator's device: a
    random course point, shifted sideways by lateral_spread * N(0, 1), its
    segment heading perturbed by yaw_spread * N(0, 1), the other states 0."""
    device = generator.device
    pts = torch.as_tensor(np.asarray(course), dtype=dtype, device=device)
    i = torch.randint(0, len(course) - 2, (num,), generator=generator, device=device)
    base, nxt = pts[i], pts[i + 1]
    yaw0 = torch.atan2(nxt[:, 1] - base[:, 1], nxt[:, 0] - base[:, 0])
    dy = torch.randn(num, generator=generator, dtype=dtype, device=device)
    dyaw = torch.randn(num, generator=generator, dtype=dtype, device=device)
    state = torch.zeros((num, get_model(cfg.model).num_states), dtype=dtype, device=device)
    state[:, 0] = base[:, 0]
    state[:, 1] = base[:, 1] + lateral_spread * dy
    state[:, 2] = yaw0 + yaw_spread * dyaw
    return state


def collect_imitation_data(cfg, sp, cp, course, generator: torch.Generator,
                           num_states: int = 128, solve_cycles: int = 8, dt: float = 0.1,
                           lateral_spread: float = 0.5, yaw_spread: float = 0.5):
    """Solve MPPI from randomized poses near the course; return (feats
    (N, 3T), targets (N, T-1, U)).

    Each datum is the update after ``solve_cycles`` warm-started solves at a
    frozen pose, the imitation target. The solves are the fleet's eager arm
    (``solver/batch.py build_fleet_step``): all poses in one vmapped step a
    cycle (on the card a CUDA graph's replay), robot b drawing the Philox
    stream of robot word b under the fleet's key, made from a seed drawn
    from ``generator``, which also draws the poses: the data is a function
    of ``generator``'s state.
    """
    from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer, resample_references
    from ccv_mppi_path_tracker_tpu_torch.solver.batch import build_fleet_step, init_fleet

    device, dtype = sp.lam.device, sp.lam.dtype
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device=device)
    dtt = torch.full((), dt, dtype=dtype, device=device)
    states = random_poses(cfg, course, generator, num_states, lateral_spread, yaw_spread,
                          dtype).to(device)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                             device=generator.device))
    step = build_fleet_step(cfg, use_kernel=False)
    ctrls = init_fleet(cfg, num_states, seed=seed, dtype=dtype, device=device)
    for _ in range(solve_cycles):
        ctrls, _ = step(ctrls, states, path, dtt, sp, cp)
    ref = resample_references(path, states[:, :2], cp.v_ref, dtt, cfg.horizon)
    feats = torch.func.vmap(lambda s, xy, yaw: proposal_features(s, RefWindow(xy, yaw)))(
        states, ref.xy, ref.yaw)
    return feats, ctrls.u_prev


def fit_sampler(feats, targets, generator: torch.Generator, hidden: int = 64,
                num_steps: int = 500, learning_rate: float = 1e-3):
    """Regress proposal means from features (MSE, Adam), the weights drawn
    from ``generator`` before the first step. Returns (net, losses: a NumPy
    array, each step's loss before its update). The steps are one scan of
    :func:`_sampler_step` (diff/optim.py): on the card one CUDA graph
    replayed ``num_steps`` times, as the JAX package jits its step."""
    (params, _), losses = _fit_sampler_program(feats, targets, generator, hidden,
                                               num_steps, learning_rate)()
    return SamplerNet(*params), losses.cpu().numpy()


def _sampler_step(carry, feats, y, learning_rate):
    """:func:`fit_sampler`'s Adam step, carry ((w1, b1, w2, b2), Adam state)."""
    params, state = carry
    grads, loss = torch.func.grad_and_value(
        lambda ps: torch.mean((_mlp(feats, *ps) - y) ** 2))(params)
    return adam_update(params, grads, state, learning_rate), loss


# The compiled program: on the card one CUDA graph per shape set a process
# runs (least recently used dropped first).
SAMPLER_FIT = Graphed(_sampler_step, max_graphs=8)


def _fit_sampler_program(feats, targets, generator, hidden=64, num_steps=500,
                         learning_rate=1e-3) -> Program:
    """:func:`fit_sampler`'s scan, not yet run (the weights drawn)."""
    n, in_dim = feats.shape
    y = targets.reshape(n, -1)
    net = SamplerNet.init(in_dim, hidden, y.shape[1], generator, feats.dtype).to(feats.device)
    params = tuple(p.detach() for p in net.parameters())
    return Program(SAMPLER_FIT, ((params, adam_init(params)), feats, y, learning_rate),
                   num_steps)
