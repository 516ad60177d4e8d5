"""The benchmark's plain reference: one MPPI control update of the CCV
controller, and the serving path's command geometry, in plain PyTorch.

It imports nothing of the program: it is a frozen copy of the plain math, as
the reference C++ nodes define it and the port's plain versions write it out
(``core/random.py``, ``paths/resample.py``, ``ops/sampling.py``,
``models/full_body.py``, ``models/unicycle.py``, ``ops/costs.py``,
``solver/command.py`` of ``ccv_mppi_path_tracker_tpu_torch``). It takes its
numbers from the configuration file (``benchmark/configs/<name>.json``) and
its inputs from the harness, never from the program's objects.

One update, for B robots at once (a single robot is B = 1):

1. the local reference window (``calc_RefPath``, src/diff_drive_mppi.cpp:126-181):
   the nearest course point, then point ``cur + floor(i * v_ref*dt/resolution)``
   for i < T, clamped to the last point, and each segment's heading;
2. the draw: Philox4x32-10 keyed by (seed, step) at counter (k, t, pair, robot),
   and Box-Muller over the top 23 bits of words 0 and 1 (cosine half for even
   control channels, sine half for odd);
3. the samples ``clamp(u_prev + sigma * eps)``, eps the normals coloured by
   ``noise_beta``;
4. the sequential Euler rollout of the model;
5. the costs: for the unicycle the path term over all T states and the
   velocity term over the T-1 controls (src/diff_drive_mppi.cpp:194-210); for
   the full body path, velocity, lateral ZMP, roll-rate smoothness, backward
   motion over t < T-2 and the start's yaw term (src/full_body_mppi.cpp:404-424).
   The distance to the window is the plain min over its points of |p - r|^2,
   clamped at 100 m squared;
6. the softmax under the baseline min(costs) with temperature lambda, and the
   weighted mean of the samples.

``dtype`` sets the precision of the arithmetic (float32 as configured; the
control computes in bfloat16). The draw's uniforms and normals are always
made in float32, as the generator defines them, and then cast.

This module is also the default *reference module* of a configuration. A
configuration file's ``reference`` key may name another, a file under
``benchmark/`` given from the checkout's root; the harness then takes from it
everything that is model-specific, and it may import the shared pieces (the
draw, the window, the course) from here. A reference module imports nothing
of the program, of JAX, of the JAX package or of ``bench_torch``, and
supplies:

- ``update(config, path_xy, pose, u_prev, seed, step, robots=None,
  dtype=torch.float32)``: u_opt (B, T-1, U) of one update, as :func:`update`;
- ``num_states(config)``: the length S of a pose;
- ``plant(config, poses, u0, dt)``: the world's step of (B, S) NumPy poses
  under (B, U) commands, as :func:`plant`;

and may supply

- ``update_marked(config, path_xy, pose, u_prev, seed, step)``: (u_opt,
  undecided), undecided a (B,) bool tensor that marks the robots whose
  answer a discrete choice of the algorithm decides within rounding of its
  threshold. The check counts them (``undecided``, held to the cell's
  limits file, which must have that limit) and leaves them out of ``u_gap``;
- ``command`` and ``steering_mode``: the serving path's command geometry
  (this module's where absent).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
TWO_PI_F32 = float(np.float32(2.0 * math.pi))
DIST_CAP = 100.0
STEER = 2  # the full body's direction channel
NUM_STATES = {"unicycle": 3, "full_body": 5}


# --- course and inputs ---------------------------------------------------------

def course(spec: dict, offset=(0.0, 0.0)) -> np.ndarray:
    """The sum-of-cosines course of src/reference_path_creator.cpp:37-56
    (one cosine), (N, 2) float32, moved by ``offset`` metres."""
    s = np.arange(0.0, spec["length"], spec["resolution"])
    a, f, d = spec["amplitude"], spec["frequency"], spec["delta"]
    y = a * np.cos(2.0 * math.pi * f * s + d) - a
    return np.stack([s + offset[0], y + offset[1]], axis=-1).astype(np.float32)


# --- the draw ------------------------------------------------------------------

def philox4x32(c, key):
    """Philox4x32-10 of four uint32 counter words (int64 tensors) under the
    key (k0, k1) (ints). Returns the four output words."""
    c0, c1, c2, c3 = (x & MASK for x in c)
    k0, k1 = key[0] & MASK, key[1] & MASK
    for _ in range(10):
        p0 = PHILOX_M0 * c0          # < 2**64: int64 holds the bits, wrapped
        p1 = PHILOX_M1 * c2
        c0, c1, c2, c3 = (((p1 >> 32) & MASK) ^ c1 ^ k0, p1 & MASK,
                          ((p0 >> 32) & MASK) ^ c3 ^ k1, p0 & MASK)
        k0 = (k0 + PHILOX_W0) & MASK
        k1 = (k1 + PHILOX_W1) & MASK
    return c0, c1, c2, c3


def normals(seed: int, step: int, robots, tm1: int, k0: int, k1: int, u_dim: int,
            device) -> torch.Tensor:
    """Standard normals (B, T-1, k1-k0, U) in float32: samples k0 ... k1-1 of
    robots ``robots`` (a list of robot indices)."""
    i64 = dict(dtype=torch.int64, device=device)
    pairs = (u_dim + 1) // 2
    b = torch.as_tensor(list(robots), **i64).view(-1, 1, 1, 1)
    t = torch.arange(tm1, **i64).view(1, -1, 1, 1)
    k = torch.arange(k0, k1, **i64).view(1, 1, -1, 1)
    p = torch.arange(pairs, **i64).view(1, 1, 1, -1)
    shape = (b.shape[0], tm1, k1 - k0, pairs)
    x0, x1, _, _ = philox4x32([k.expand(shape), t.expand(shape), p.expand(shape),
                               b.expand(shape)], (int(seed), int(step)))
    scale = 1.0 / (1 << 23)
    u1 = (x0 >> 9).to(torch.float32) * scale
    u2 = (x1 >> 9).to(torch.float32) * scale
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    theta = TWO_PI_F32 * u2
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return z.reshape(shape[:-1] + (2 * pairs,))[..., :u_dim]


# --- one update -------------------------------------------------------------------

def window(path, pose_xy, v_ref, dt, resolution, horizon: int):
    """The reference windows (B, T, 2) and their headings (B, T) for the B
    positions ``pose_xy`` (B, 2) on the course ``path`` (N, 2)."""
    diff = path[None] - pose_xy[:, None]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    d2_min, best = torch.min(d2, dim=-1)
    cur = torch.where(d2_min < DIST_CAP * DIST_CAP, best, 0)
    step = v_ref * dt / resolution
    offs = torch.floor(torch.arange(horizon, dtype=path.dtype, device=path.device)
                       * step).to(torch.int64)
    idx = torch.clamp(cur[:, None] + offs[None], max=path.shape[0] - 1)
    xy = path[idx]
    seg = xy[:, 1:] - xy[:, :-1]
    yaw = torch.atan2(seg[..., 1], seg[..., 0])
    return xy, torch.cat([yaw, yaw[:, -1:]], dim=1)


def euler(model: str, s, u, dt):
    """One Euler step of ``model`` for states s (..., S) under controls u (..., U)."""
    x, y, yaw = s[..., 0], s[..., 1], s[..., 2]
    v, w = u[..., 0], u[..., 1]
    heading = yaw if model == "unicycle" else yaw + u[..., STEER]
    out = [x + v * torch.cos(heading) * dt, y + v * torch.sin(heading) * dt, yaw + w * dt]
    if model == "full_body":
        out += [s[..., 3] + u[..., 3] * dt, s[..., 4] + u[..., 4] * dt]
    return torch.stack(out, dim=-1)


def min_sq_distance(xy, ref_xy):
    """min over the window's points of |p - r|^2, clamped to [0, 100^2]:
    xy (B, T', K, 2), ref_xy (B, R, 2) -> (B, T', K)."""
    d = xy[..., None, :] - ref_xy[:, None, None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return torch.clamp(torch.amin(d2, dim=-1), 0.0, DIST_CAP * DIST_CAP)


def zmp_y(states, u, dt, body: dict):
    """The lateral ZMP (T-2 steps) of src/full_body_mppi.cpp:468-486 and
    :597-603: the upper body a box of ``body``'s mass and size whose CoM sits
    at half its height. states (B, T, K, 5), u (B, T-1, K, 5)."""
    m, h, dep, wid = body["mass"], body["height"], body["depth"], body["width"]
    c = h / 2.0
    inertia = (m * (wid * wid + h * h) / 12.0 + m * c * c,
               m * (h * h + dep * dep) / 12.0 + m * c * c,
               m * (dep * dep + wid * wid) / 12.0)
    v, w, direction = u[..., 0], u[..., 1], u[..., STEER]
    drive = (v[:, 1:] - v[:, :-1]) / dt
    ac = v[:, :-1] * w[:, :-1]
    cd, sd = torch.cos(direction[:, :-1]), torch.sin(direction[:, :-1])
    ay = drive * sd + ac * cd
    hg_x = (u[:, 1:, ..., 3] - u[:, :-1, ..., 3]) * (inertia[0] / dt)
    roll, pitch = states[:, :-2, ..., 3], states[:, :-2, ..., 4]
    com_y = -c * torch.sin(roll)
    com_z = c * torch.cos(pitch) * torch.cos(roll)
    by = -m * ay
    bz = m * body["gravity_z"]          # the base's vertical acceleration is 0
    mo_x = com_y * bz - com_z * by - hg_x
    return mo_x / bz


def costs(model: str, states, u, ref_xy, ref_yaw0, dt, cost: dict, body):
    """(B, K) costs of the rollouts states (B, T, K, S) under u (B, T-1, K, U)."""
    if model == "unicycle":
        d2 = min_sq_distance(states[..., :2], ref_xy)
        dv = u[..., 0] - cost["v_ref"]
        return cost["path_weight"] * d2.sum(dim=1) + cost["v_weight"] * (dv * dv).sum(dim=1)
    tm2 = states.shape[1] - 2
    d2 = min_sq_distance(states[:, :tm2, ..., :2], ref_xy)
    v = u[:, :tm2, ..., 0]
    dv = v - cost["v_ref"]
    zy = zmp_y(states, u, dt, body)
    roll_v = u[..., 3]
    droll = roll_v[:, 1:tm2 + 1] - roll_v[:, :tm2]
    back = torch.where(v < 0.0, v * v, 0.0)
    dyaw0 = states[:, 0, :, 2] - ref_yaw0[:, None]
    return (cost["path_weight"] * d2.sum(dim=1) + cost["v_weight"] * (dv * dv).sum(dim=1)
            + cost["zmp_weight"] * (zy * zy).sum(dim=1)
            + cost["roll_v_weight"] * (droll * droll).sum(dim=1)
            + cost["back_weight"] * back.sum(dim=1) + cost["yaw_weight"] * dyaw0 * dyaw0)


class Inputs:
    """One update's inputs in ``dtype`` on pose's device, from the
    configuration file's dict: the course ``path_xy`` (N, 2), the measured
    states ``pose`` (B, S), the warm starts ``u_prev`` (B, T-1, U) or None
    (zeros), and the reference windows they give."""

    def __init__(self, config: dict, path_xy, pose, u_prev, dtype=torch.float32):
        dev = pose.device
        f = dict(dtype=dtype, device=dev)
        self.config, self.dtype = config, dtype
        sol, cost = config["solver"], config["cost"]
        self.tm1, self.u_dim = config["horizon"] - 1, len(sol["u_min"])
        self.pose = pose.to(**f)
        n_rob = self.pose.shape[0]
        self.u_prev = (torch.zeros((n_rob, self.tm1, self.u_dim), **f) if u_prev is None
                       else u_prev.to(**f))
        self.dt = torch.tensor(config["dt"], **f)
        self.cost = {k: torch.tensor(v, **f) for k, v in cost.items()
                     if not isinstance(v, bool)}
        self.sigma = torch.tensor(sol["control_noise"], **f)
        self.lo, self.hi = torch.tensor(sol["u_min"], **f), torch.tensor(sol["u_max"], **f)
        self.beta = torch.tensor(sol["noise_beta"], **f)
        self.lam = torch.tensor(sol["lam"], **f)
        path = torch.as_tensor(path_xy).to(**f)
        self.ref_xy, self.ref_yaw = window(path, self.pose[:, :2], self.cost["v_ref"], self.dt,
                                           torch.tensor(config["course"]["resolution"], **f),
                                           config["horizon"])


def rollouts(x: Inputs, seed: int, step: int, robots, k0: int, k1: int):
    """Samples k0 ... k1-1 of every robot: their controls (B, T-1, k, U) and
    costs (B, k)."""
    conf = x.config
    eta = normals(seed, step, robots, x.tm1, k0, k1, x.u_dim, x.pose.device).to(x.dtype)
    eps = [eta[:, 0]]
    scale = torch.sqrt(1.0 - x.beta * x.beta)
    for t in range(1, x.tm1):
        eps.append(x.beta * eps[-1] + scale * eta[:, t])
    u = torch.clamp(x.u_prev[:, :, None] + torch.stack(eps, dim=1) * x.sigma, x.lo, x.hi)
    if conf["solver"]["steer_off"] and x.u_dim > STEER:
        u[..., STEER] = 0.0
    n_rob = x.pose.shape[0]
    s = [x.pose[:, None].expand(n_rob, k1 - k0, x.pose.shape[1])]
    for t in range(x.tm1):
        s.append(euler(conf["model"], s[-1], u[:, t], x.dt))
    return u, costs(conf["model"], torch.stack(s, dim=1), u, x.ref_xy, x.ref_yaw[:, 0], x.dt,
                    x.cost, conf["body"])


def update(config: dict, path_xy, pose, u_prev, seed: int, step: int, robots=None,
           dtype=torch.float32, block: int = 16384):
    """u_opt (B, T-1, U) of one control update of B robots.

    config: the configuration file's dict. path_xy: (N, 2) course points;
    pose: (B, S) measured states; u_prev: (B, T-1, U) warm starts, or None for
    the zero warm start; ``robots``: the robots' Philox indices (default 0 ...
    B-1). The samples run in blocks of ``block``."""
    x = Inputs(config, path_xy, pose, u_prev, dtype)
    robots = list(range(x.pose.shape[0])) if robots is None else list(robots)
    k_all = config["num_samples"]
    parts = [rollouts(x, seed, step, robots, k0, min(k_all, k0 + block))
             for k0 in range(0, k_all, block)]
    u = torch.cat([p[0] for p in parts], dim=2)
    c = torch.cat([p[1] for p in parts], dim=1)
    w = torch.exp((c - torch.amin(c, dim=1, keepdim=True)) * (-1.0 / x.lam))
    num = torch.sum(w[:, None, :, None] * u, dim=2)
    return num / torch.sum(w, dim=1)[:, None, None]


def num_states(config: dict) -> int:
    return NUM_STATES[config["model"]]


def plant(config: dict, poses: np.ndarray, u0: np.ndarray, dt: float) -> np.ndarray:
    """The world: the model's Euler step in NumPy on the host, (B, S) poses
    under (B, U) commands, as a new float32 array."""
    model = config["model"]
    x, y, yaw = poses[:, 0], poses[:, 1], poses[:, 2]
    v, w = u0[:, 0], u0[:, 1]
    heading = yaw if model == "unicycle" else yaw + u0[:, STEER]
    out = [x + v * np.cos(heading) * dt, y + v * np.sin(heading) * dt, yaw + w * dt]
    if model == "full_body":
        out += [poses[:, 3] + u0[:, 3] * dt, poses[:, 4] + u0[:, 4] * dt]
    return np.stack(out, axis=-1).astype(np.float32)


# --- the serving path's command -----------------------------------------------------

def command(model: str, u0, dt: float, spec: dict) -> dict:
    """The actuator command of src/full_body_mppi.cpp:246-275 (and the
    diff-drive node's, src/diff_drive_mppi.cpp:255-263) from the head u0 (U,)
    of the solution, in float64 and rounded to float32: v, w, the left and
    right wheel steering angles (turning-radius geometry on the direction
    control) and the upper body's roll (integrated from 0, clamped)."""
    u0 = np.asarray(u0, dtype=np.float64)
    v, w = u0[0], u0[1]
    steer_l = steer_r = roll = 0.0
    if model != "unicycle":
        d, half = u0[STEER], spec["tread"] / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            r = abs(v / w)
            s_in = math.atan2(r * math.sin(d), r * math.cos(d) - half)
            s_out = math.atan2(r * math.sin(d), r * math.cos(d) + half)
        steer_l, steer_r = (s_in, s_out) if w > 0.0 else (s_out, s_in)
        if model == "full_body":
            lim = spec["roll_limit"]
            roll = float(np.float32(min(max(float(np.float32(np.float32(u0[3]) * np.float32(dt))),
                                            -lim), lim)))
    return {k: float(np.float32(x)) for k, x in
            (("v", v), ("w", w), ("steer_l", steer_l), ("steer_r", steer_r), ("roll", roll))}


MODE_EPS = 0.1 * math.pi / 180.0   # src/steering_diff_drive_mppi.cpp:84-95


def steering_mode(steer_r: float, steer_l: float):
    """check_State of src/steering_diff_drive_mppi.cpp:84-95: 0 opposite signs
    (invalid), 1 both near zero, 2 equal (crab), 3 distinct (turning); None
    where an angle lies within 1e-6 rad of a threshold, so that the last
    bit of rounding could decide it (signs are exact)."""
    sr, sl = steer_r, steer_l
    edges = (abs(abs(sr - sl) - MODE_EPS), abs(abs(sr) - MODE_EPS), abs(abs(sl) - MODE_EPS))
    if min(edges) < 1e-6:
        return None
    if (sr < 0.0 < sl) or (sl < 0.0 < sr):
        return 0
    if abs(sr - sl) < MODE_EPS:
        return 1 if abs(sr) < MODE_EPS and abs(sl) < MODE_EPS else 2
    return 3
