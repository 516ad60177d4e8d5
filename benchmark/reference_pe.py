"""The plain reference of MPPI over PETS's probabilistic ensemble: one control
update with the ensemble of five 6-200-200-200-200-8 swish networks and
their Gaussian heads, propagated by 20 TS-infinity particles a sequence, in
plain PyTorch.

It imports nothing of the program, of JAX, of the JAX package or of
``bench_torch``: the course, the Philox normals, the reference window and the
distance come from ``benchmark/reference.py``; the weights, the particles,
the rollout and the cost are written here from the configuration file
(``benchmark/configs/pets_pe-K5120-P20-T30.json``).

The model is PETS's (Chua, Calandra, McAllister and Levine, NeurIPS 2018;
github.com/kchua/handful-of-trials ``dmbrl/modeling/models/BNN.py`` and
``dmbrl/controllers/MPC.py``) over AutoRally's state (x, y, yaw, roll, v_x,
v_y, yaw_mder) and controls (steering, throttle). Member e of the E members:

    z      = ([roll, v_x, v_y, yaw_mder, steering, throttle] - mu_in) / sigma_in
    h_1    = swish(z W_1^T + b_1),  h_{i+1} = swish(h_i W_{i+1}^T + b_{i+1})
    [m, l] = h_4 W_5^T + b_5
    l     <- l_max - softplus(l_max - l);  l <- l_min + softplus(l - l_min)

with swish(x) = x sigmoid(x). Particle p of sequence k follows member p mod E
at every step:

    (roll, v_x, v_y, yaw_mder)' = (roll, v_x, v_y, yaw_mder) + m + exp(l / 2) eps
    (x, y, yaw)'                = (x, y, yaw) + dt (v_x cos yaw - v_y sin yaw,
                                                    v_x sin yaw + v_y cos yaw, -yaw_mder)

eps the normals of ``reference.normals`` at "robot" 2^31 + b and sample
index k P + p, the pose's step from the state before it. A particle's cost
is path_weight * sum_{t<T} min_j |p_t - r_j|^2 + v_weight * sum_{0<t<T} (v_x,t
- v_ref)^2, 1e6 where it is not finite; a sequence's the mean over its P
particles; then the softmax under the baseline min(costs) with temperature
lambda and the weighted mean of the sequences' controls.

Departures from the source:

- the cost is the CCV tracking cost in place of PETS's task cost (each of
  its environments has its own reward);
- the weights are random, redrawn from the configuration's ``weights``
  block, since PETS's trained weights are not in this repository; the input
  standardiser is (0, 1);
- particle p follows member p mod E, where MPC.py draws a random
  permutation of the particles once a plan; both are fixed over the horizon;
- MPC.py replaces a NaN cost with 1e6; here a non-finite one (an
  overflowing state gives inf too).

``dtype`` is the precision of the arithmetic (float32 as configured; the
readings' control computes in bfloat16); the draws are always made in float32
and cast. The sequences run in blocks of ``block``, so that the reference
fits on the card beside the program. The module sets TF32 off: the
ensemble's products are matrix products, which CUDA may otherwise round to
TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NUM_STATES = 7
PROPAGATION_ROBOT = 2**31
NONFINITE_COST = 1e6


def weights(config: dict, dtype=torch.float32, device="cpu") -> list:
    """The ensemble of the configuration's ``weights`` block: a list over the
    members of [W_1, b_1, ..., W_5, b_5], drawn member by member, each
    layer's (out, in) matrix then its bias, by one CPU generator seeded with
    ``seed`` as float32 uniforms u in [0, 1) mapped to (2u - 1) /
    sqrt(fan_in); the hidden matrices' bound times ``hidden_gain``; the last
    layer's first ``out`` rows and biases (the mean head) times
    ``output_scale``, its other biases (the log-variance head) plus
    ``logvar_offset``."""
    spec = config["weights"]
    if spec["order"] != "member by member: w1, b1, w2, b2, w3, b3, w4, b4, w5, b5":
        raise ValueError(f"the reference draws member by member, not {spec['order']!r}")
    layers = config["layers"]
    out = layers[-1][1] // 2
    g = torch.Generator().manual_seed(spec["seed"])
    members = []
    for _ in range(config["members"]):
        ws = []
        for n, (fan_in, fan_out) in enumerate(layers):
            last = n == len(layers) - 1
            bound = 1.0 / fan_in ** 0.5
            w = ((torch.rand((fan_out, fan_in), generator=g, dtype=torch.float32) * 2.0 - 1.0)
                 * (bound * (1.0 if last else spec["hidden_gain"])))
            b = (torch.rand((fan_out,), generator=g, dtype=torch.float32) * 2.0 - 1.0) * bound
            if last:
                w[:out] = w[:out] * spec["output_scale"]
                b[:out] = b[:out] * spec["output_scale"]
                b[out:] = b[out:] + spec["logvar_offset"]
            ws += [w, b]
        members.append([t.to(dtype=dtype, device=device) for t in ws])
    return members


class Ensemble:
    """The ensemble's weights, standardiser and bounds in ``dtype`` on
    ``device``."""

    def __init__(self, config: dict, dtype, device):
        f = dict(dtype=dtype, device=device)
        self.members = weights(config, dtype, device)
        self.mu = torch.tensor(config["scaler"]["mu_in"], **f)
        self.sigma = torch.tensor(config["scaler"]["sigma_in"], **f)
        self.lv_max, self.lv_min = (torch.tensor(v, **f) for v in config["logvar_bounds"])
        self.out = config["layers"][-1][1] // 2

    def heads(self, e: int, dyn, u):
        """Member e's mean and bounded log-variance of dyn (..., 4) under u (..., 2)."""
        h = (torch.cat([dyn, u], dim=-1) - self.mu) / self.sigma
        ws = self.members[e]
        for n in range(0, len(ws), 2):
            h = h @ ws[n].T + ws[n + 1]
            if n < len(ws) - 2:
                h = h * torch.sigmoid(h)
        mean, lv = h[..., :self.out], h[..., self.out:]
        lv = self.lv_max - torch.nn.functional.softplus(self.lv_max - lv)
        lv = self.lv_min + torch.nn.functional.softplus(lv - self.lv_min)
        return mean, lv


def kinematics(s):
    yaw, vx, vy, r = s[..., 2], s[..., 4], s[..., 5], s[..., 6]
    return torch.stack([vx * torch.cos(yaw) - vy * torch.sin(yaw),
                        vx * torch.sin(yaw) + vy * torch.cos(yaw), -r], dim=-1)


def rollouts(x: reference.Inputs, ens: Ensemble, seed: int, step: int, robots, k0: int,
             k1: int):
    """Sequences k0 ... k1-1 of every robot: their controls (B, T-1, k, U)
    and costs (B, k), each the mean over its particles."""
    conf = x.config
    parts, members, out = conf["particles"], conf["members"], ens.out
    eta = reference.normals(seed, step, robots, x.tm1, k0, k1, x.u_dim,
                            x.pose.device).to(x.dtype)
    eps = [eta[:, 0]]
    scale = torch.sqrt(1.0 - x.beta * x.beta)
    for t in range(1, x.tm1):
        eps.append(x.beta * eps[-1] + scale * eta[:, t])
    u = torch.clamp(x.u_prev[:, :, None] + torch.stack(eps, dim=1) * x.sigma, x.lo, x.hi)
    # the propagation normals, (B, T-1, k, P, 4) at sample index k P + p
    xi = reference.normals(seed, step, [PROPAGATION_ROBOT + b for b in robots], x.tm1,
                           k0 * parts, k1 * parts, out, x.pose.device).to(x.dtype)
    n_rob, n = x.pose.shape[0], k1 - k0
    xi = xi.reshape(n_rob, x.tm1, n, parts, out)
    s = x.pose[:, None, None].expand(n_rob, n, parts, NUM_STATES)
    states = [s]
    for t in range(x.tm1):
        mean = torch.empty(n_rob, n, parts, out, dtype=x.dtype, device=x.pose.device)
        lv = torch.empty_like(mean)
        for e in range(members):
            mean[:, :, e::members], lv[:, :, e::members] = ens.heads(
                e, s[:, :, e::members, 3:], u[:, t, :, None].expand(n_rob, n, parts // members,
                                                                    x.u_dim))
        dyn = s[..., 3:] + mean + torch.exp(0.5 * lv) * xi[:, t]
        s = torch.cat([s[..., :3] + kinematics(s) * x.dt, dyn], dim=-1)
        states.append(s)
    states = torch.stack(states, dim=1)                  # (B, T, k, P, 7)
    d2 = reference.min_sq_distance(states[..., :2].reshape(n_rob, x.tm1 + 1, n * parts, 2),
                                   x.ref_xy).reshape(n_rob, x.tm1 + 1, n, parts)
    dv = states[:, 1:, ..., 4] - x.cost["v_ref"]
    c = x.cost["path_weight"] * d2.sum(dim=1) + x.cost["v_weight"] * (dv * dv).sum(dim=1)
    c = torch.where(torch.isfinite(c), c, NONFINITE_COST)
    return u, c.mean(dim=-1)


def update(config: dict, path_xy, pose, u_prev, seed: int, step: int, robots=None,
           dtype=torch.float32, block: int = 1024):
    """u_opt (B, T-1, U) of one control update of B robots (as
    :func:`benchmark.reference.update`)."""
    if config["model"] != "pets_pe":
        raise ValueError(f"this reference computes pets_pe, not {config['model']}")
    x = reference.Inputs(config, path_xy, pose, u_prev, dtype)
    ens = Ensemble(config, dtype, x.pose.device)
    robots = list(range(x.pose.shape[0])) if robots is None else list(robots)
    k_all = config["num_samples"]
    parts = [rollouts(x, ens, seed, step, robots, k0, min(k_all, k0 + block))
             for k0 in range(0, k_all, block)]
    u = torch.cat([p[0] for p in parts], dim=2)
    c = torch.cat([p[1] for p in parts], dim=1)
    wts = torch.exp((c - torch.amin(c, dim=1, keepdim=True)) * (-1.0 / x.lam))
    num = torch.sum(wts[:, None, :, None] * u, dim=2)
    return num / torch.sum(wts, dim=1)[:, None, None]


def num_states(config: dict) -> int:
    return NUM_STATES


def plant(config: dict, poses: np.ndarray, u0: np.ndarray, dt: float) -> np.ndarray:
    """The world: one step of the ensemble's mean (the members' mean of m,
    no noise) in NumPy (float64), (B, 7) poses under (B, 2) commands, as a
    new float32 array."""
    s = np.asarray(poses, dtype=np.float64)
    z = (np.concatenate([s[:, 3:], np.asarray(u0, dtype=np.float64)], axis=1)
         - np.asarray(config["scaler"]["mu_in"])) / np.asarray(config["scaler"]["sigma_in"])
    means = []
    for ws in weights(config):
        h = z
        ws = [t.double().numpy() for t in ws]
        for n in range(0, len(ws), 2):
            h = h @ ws[n].T + ws[n + 1]
            if n < len(ws) - 2:
                h = h * 0.5 * (1.0 + np.tanh(0.5 * h))      # swish, for any h
        means.append(h[:, :config["layers"][-1][1] // 2])
    yaw, vx, vy, r = s[:, 2], s[:, 4], s[:, 5], s[:, 6]
    kin = np.stack([vx * np.cos(yaw) - vy * np.sin(yaw), vx * np.sin(yaw) + vy * np.cos(yaw),
                    -r], axis=1)
    return np.concatenate([s[:, :3] + kin * dt, s[:, 3:] + np.mean(means, axis=0)],
                          axis=1).astype(np.float32)
