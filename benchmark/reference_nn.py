"""The plain reference of MPPI over AutoRally's learned dynamics: one control
update with the 6-32-32-4 tanh network model, in plain PyTorch.

It imports nothing of the program, of JAX, of the JAX package or of
``bench_torch``: the course, the Philox normals, the reference window and the
distance come from ``benchmark/reference.py``; the weights, the rollout and
the cost are written here from the configuration file
(``benchmark/configs/autorally_nn-K102400-T30.json``).

The model is ``NeuralNetModel<7,2,3,6,32,32,4>`` of the AutoRally code
(``autorally_control/include/autorally_control/path_integral/neural_net_model.cuh``;
Williams et al., ICRA 2017). State (x, y, yaw, roll, v_x, v_y, yaw_mder),
controls (steering, throttle):

    x'   = v_x cos(yaw) - v_y sin(yaw)
    y'   = v_x sin(yaw) + v_y cos(yaw)
    yaw' = -yaw_mder                  (AutoRally's computeKinematics)
    (roll', v_x', v_y', yaw_mder') = W3 tanh(W2 tanh(W1 z + b1) + b2) + b3,
    z = (roll, v_x, v_y, yaw_mder, steering, throttle),

and s_{t+1} = s_t + dt s_t'. One update: the window, the draw and the
samples of ``benchmark/reference.py``; the rollout of every sample; the cost
path_weight * sum_{t<T} min_j |p_t - r_j|^2 + v_weight * sum_{0<t<T}
(v_x,t - v_ref)^2; the softmax under the baseline min(costs) with
temperature lambda and the weighted mean of the samples.

Departures from the source:

- the cost is the CCV tracking cost (the distance to the reference window and
  the speed error) in place of AutoRally's costmap cost: the costmap is an
  image of the track that this repository does not hold;
- the weights are random, redrawn from the configuration's ``weights``
  block (its seed, layers, init, order and output scale), since AutoRally's
  trained weights are not in this repository;
- the rollout is Euler at the configuration's dt, 0.1 s, the CCV
  controllers' step, where AutoRally's controller integrates at its own
  control period.

``dtype`` is the precision of the arithmetic (float32 as configured; the
readings' control computes in bfloat16); the draw is always made in float32
and cast. The samples run in blocks of ``block``, so that the reference fits
on the card beside the program. The module sets TF32 off: the network's
products are matrix products, which CUDA may otherwise round to TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NUM_STATES = 7


def weights(config: dict, dtype=torch.float32, device="cpu") -> list:
    """[W1, b1, W2, b2, W3, b3] of the configuration's ``weights`` block:
    each layer's (out, in) matrix then its bias, drawn in that order by one
    CPU generator seeded with ``seed`` as float32 uniforms u in [0, 1) and
    mapped to (2u - 1) / sqrt(fan_in); the last layer's times
    ``output_scale``."""
    spec = config["weights"]
    if spec["order"] != ["w1", "b1", "w2", "b2", "w3", "b3"]:
        raise ValueError(f"the reference draws w1, b1, w2, b2, w3, b3, not {spec['order']}")
    g = torch.Generator().manual_seed(spec["seed"])
    out = []
    layers = spec["layers"]
    for n, (fan_in, fan_out) in enumerate(layers):
        scale = spec["output_scale"] if n == len(layers) - 1 else 1.0
        for shape in ((fan_out, fan_in), (fan_out,)):
            u = torch.rand(shape, generator=g, dtype=torch.float32)
            out.append(((u * 2.0 - 1.0) * (1.0 / fan_in ** 0.5) * scale))
    return [w.to(dtype=dtype, device=device) for w in out]


def derivative(s, u, w):
    """s' of states s (..., 7) under controls u (..., 2) and weights ``w``."""
    w1, b1, w2, b2, w3, b3 = w
    yaw, vx, vy, r = s[..., 2], s[..., 4], s[..., 5], s[..., 6]
    z = torch.cat([s[..., 3:], u], dim=-1)
    h = torch.tanh(z @ w1.T + b1)
    h = torch.tanh(h @ w2.T + b2)
    net = h @ w3.T + b3
    kin = [vx * torch.cos(yaw) - vy * torch.sin(yaw), vx * torch.sin(yaw) + vy * torch.cos(yaw),
           -r]
    return torch.cat([torch.stack(kin, dim=-1), net], dim=-1)


def rollouts(x: reference.Inputs, w, seed: int, step: int, robots, k0: int, k1: int):
    """Samples k0 ... k1-1 of every robot: their controls (B, T-1, k, U) and
    costs (B, k)."""
    eta = reference.normals(seed, step, robots, x.tm1, k0, k1, x.u_dim,
                            x.pose.device).to(x.dtype)
    eps = [eta[:, 0]]
    scale = torch.sqrt(1.0 - x.beta * x.beta)
    for t in range(1, x.tm1):
        eps.append(x.beta * eps[-1] + scale * eta[:, t])
    u = torch.clamp(x.u_prev[:, :, None] + torch.stack(eps, dim=1) * x.sigma, x.lo, x.hi)
    n_rob = x.pose.shape[0]
    s = [x.pose[:, None].expand(n_rob, k1 - k0, NUM_STATES)]
    for t in range(x.tm1):
        s.append(s[-1] + derivative(s[-1], u[:, t], w) * x.dt)
    states = torch.stack(s, dim=1)                       # (B, T, k, 7)
    d2 = reference.min_sq_distance(states[..., :2], x.ref_xy)
    dv = states[:, 1:, :, 4] - x.cost["v_ref"]
    return u, x.cost["path_weight"] * d2.sum(dim=1) + x.cost["v_weight"] * (dv * dv).sum(dim=1)


def update(config: dict, path_xy, pose, u_prev, seed: int, step: int, robots=None,
           dtype=torch.float32, block: int = 16384):
    """u_opt (B, T-1, U) of one control update of B robots (as
    :func:`benchmark.reference.update`)."""
    if config["model"] != "autorally_nn":
        raise ValueError(f"this reference computes autorally_nn, not {config['model']}")
    x = reference.Inputs(config, path_xy, pose, u_prev, dtype)
    w = weights(config, dtype, x.pose.device)
    robots = list(range(x.pose.shape[0])) if robots is None else list(robots)
    k_all = config["num_samples"]
    parts = [rollouts(x, w, seed, step, robots, k0, min(k_all, k0 + block))
             for k0 in range(0, k_all, block)]
    u = torch.cat([p[0] for p in parts], dim=2)
    c = torch.cat([p[1] for p in parts], dim=1)
    wts = torch.exp((c - torch.amin(c, dim=1, keepdim=True)) * (-1.0 / x.lam))
    num = torch.sum(wts[:, None, :, None] * u, dim=2)
    return num / torch.sum(wts, dim=1)[:, None, None]


def num_states(config: dict) -> int:
    return NUM_STATES


def plant(config: dict, poses: np.ndarray, u0: np.ndarray, dt: float) -> np.ndarray:
    """The world: one Euler step of the network model in NumPy (float64),
    (B, 7) poses under (B, 2) commands, as a new float32 array."""
    w1, b1, w2, b2, w3, b3 = (t.double().numpy() for t in weights(config))
    s = np.asarray(poses, dtype=np.float64)
    yaw, vx, vy, r = s[:, 2], s[:, 4], s[:, 5], s[:, 6]
    z = np.concatenate([s[:, 3:], np.asarray(u0, dtype=np.float64)], axis=1)
    net = np.tanh(np.tanh(z @ w1.T + b1) @ w2.T + b2) @ w3.T + b3
    kin = np.stack([vx * np.cos(yaw) - vy * np.sin(yaw), vx * np.sin(yaw) + vy * np.cos(yaw),
                    -r], axis=1)
    return (s + np.concatenate([kin, net], axis=1) * dt).astype(np.float32)
