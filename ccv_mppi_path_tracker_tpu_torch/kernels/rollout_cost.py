"""Fused sample + rollout + cost + weighted update: wrapper of the CUDA
kernel ``csrc/rollout_cost.cu`` and its plain PyTorch version.

Counterpart of ``fused_sample_rollout_cost`` in the JAX package's
``kernels/rollout_cost.py`` (the Pallas TPU kernel): the four model
branches, noise-input and in-kernel RNG mode, any K, the elite passes
(costs only, costs in, cost threshold), the second moment (adaptive sigma)
and the fleet grid (a leading robot axis, B robots in one launch). Sampled
controls and rollout states never reach device memory: the kernel writes
the costs and one row of partial sums per block, which the wrapper
finishes here.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.models import full_body
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import full_body_cost, tracking_cost
from ccv_mppi_path_tracker_tpu_torch.ops.mindist import center_ref
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import rollout, steer_limits
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import sample_controls

SOURCE = "ccv_mppi_path_tracker_tpu_torch/csrc/rollout_cost.cu"

# Models the kernel implements; the index is the model id of the C entry
# point (csrc/rollout_cost.cu ModelId).
KERNEL_MODELS = ("unicycle", "steering_unicycle", "rate_limited_steering", "full_body")

# Scalar slots, the JAX package's pack_scalars layout: [dt, v_ref, path_w,
# v_w, zmp_w, roll_v_w, back_w, yaw_w, yaw_ref0, mass, base2com, Ixx, Iyy,
# Izz, gravity_z, noise_beta, lam, cost_thresh]
NSCAL = 18

# gridDim.y of the fleet grid
MAX_ROBOTS = 65535


def pack_scalars(dt, cp: CostParams, yaw_ref0, model_params=None, noise_beta=0.0,
                 lam=1.0, cost_thresh=None):
    """The (NSCAL,) float32 scalar vector, stacked on ``yaw_ref0``'s device;
    (B, NSCAL) for a fleet's (B,) ``yaw_ref0`` (the other values are shared
    or, like ``cost_thresh``, may be (B,) too). ``model_params=None`` (the
    models without physical parameters) fills the mass and inertia slots
    with zeros; ``cost_thresh=None`` is +inf (no elite mask). Python numbers
    become device fills, so no value is copied from the host."""
    mp = model_params
    phys = [0.0] * 6 if mp is None else [
        mp.mass, mp.base2com, mp.inertia[0], mp.inertia[1], mp.inertia[2],
        mp.gravity_z,
    ]
    vals = [
        dt, cp.v_ref, cp.path_weight, cp.v_weight, cp.zmp_weight,
        cp.roll_v_weight, cp.back_weight, cp.yaw_weight, yaw_ref0, *phys,
        noise_beta, lam, float("inf") if cost_thresh is None else cost_thresh,
    ]
    dev, shape = yaw_ref0.device, yaw_ref0.shape
    return torch.stack([
        (v.to(torch.float32) if isinstance(v, torch.Tensor)
         else torch.full((), v, dtype=torch.float32, device=dev)).expand(shape)
        for v in vals
    ], dim=-1)


def _unpack_scalars(scal):
    dt = scal[0]
    cp = CostParams(v_ref=scal[1], path_weight=scal[2], v_weight=scal[3],
                    zmp_weight=scal[4], roll_v_weight=scal[5],
                    back_weight=scal[6], yaw_weight=scal[7])
    mp = full_body.FullBodyParams(mass=scal[9], base2com=scal[10],
                                  inertia=scal[11:14], gravity_z=scal[14])
    return dt, cp, scal[8], mp, scal[15], scal[16], scal[17]


def fused_sample_rollout_cost_reference(
    u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed: int, step: int,
    num_samples: int, model: str, steer_off: bool = False,
    noise: Optional[torch.Tensor] = None, accumulate: bool = True,
    costs_in: Optional[torch.Tensor] = None, second_moment: bool = False,
    robot: int = 0,
):
    """Plain PyTorch version of the kernel: same arguments and outputs.

    Samples with the eager ops (RNG mode draws the kernel's own Philox
    normals, ``core/random.py philox_normals``), rolls out with the model's
    sequential Euler step as the kernel does, costs with the built-in cost,
    and reduces with one global softmax under the baseline min(costs),
    weights zeroed above the threshold in ``scal``. A fleet (3-D ``u_prev``)
    runs the single-robot version under ``torch.func.vmap``, each robot
    under its own baseline.
    """
    want_m2 = second_moment and accumulate
    if u_prev.dim() == 3:
        num_robots, tm1, u_dim = u_prev.shape
        if noise is None:
            robots = robot + torch.arange(num_robots, device=u_prev.device)
            noise = philox_normals(seed, step, num_samples, tm1, u_dim, robot=robots,
                                   device=u_prev.device, dtype=u_prev.dtype)

        def one(up, ref, s0, sc, nz, cin):
            out = _reference_one(up, sigma, u_min, u_max, ref, s0, sc, num_samples,
                                 model, steer_off, nz, accumulate, cin, want_m2)
            return tuple(o for o in out if o is not None)

        in_dims = (0, 0, 0, 0, 0, None if costs_in is None else 0)
        out = torch.func.vmap(one, in_dims=in_dims)(u_prev, ref_xy, state0, scal, noise,
                                                    costs_in)
    else:
        tm1, u_dim = u_prev.shape
        if noise is None:
            noise = philox_normals(seed, step, num_samples, tm1, u_dim, robot=robot,
                                   device=u_prev.device, dtype=u_prev.dtype)
        out = _reference_one(u_prev, sigma, u_min, u_max, ref_xy, state0, scal,
                             num_samples, model, steer_off, noise, accumulate,
                             costs_in, want_m2)
    out = tuple(out)
    out += (None,) * ((4 if second_moment else 3) - len(out))
    return out


def _reference_one(u_prev, sigma, u_min, u_max, ref_xy, state0, scal, num_samples,
                   model, steer_off, noise, accumulate, costs_in, second_moment):
    """One robot of the plain version, injected noise: (costs, u_num, norm[,
    u2_num]), or (costs,) without the update."""
    dt, cp, yaw_ref0, mp, beta, lam, thresh = _unpack_scalars(scal)
    sp = SolverParams(control_noise=sigma, lam=lam, u_min=u_min, u_max=u_max,
                      noise_beta=beta)
    u = sample_controls(u_prev, sp, num_samples, steer_off=steer_off, noise=noise)
    if costs_in is not None:
        costs = costs_in
    else:
        states = rollout(get_model(model).step, state0.expand(num_samples, -1), u, dt)
        ref = RefWindow(xy=ref_xy, yaw=yaw_ref0.expand(ref_xy.shape[0]))
        if model == "full_body":
            costs = full_body_cost(states, u, full_body.zmp_chain(states, u, dt, mp),
                                   ref, cp)
        else:
            costs = tracking_cost(states, u, ref, cp)
    if not accumulate:
        return (costs,)
    w = torch.exp((costs - torch.amin(costs)) * (-1.0 / lam))
    w = torch.where(costs <= thresh, w, 0.0)
    wu = w[None, :, None] * u
    out = (costs, torch.sum(wu, dim=1), torch.sum(w))
    if second_moment:
        out += (torch.sum(wu * u, dim=1),)
    return out


def _check_inputs(u_prev, sigma, u_min, u_max, ref_xy, state0, scal,
                  num_samples, model, noise, accumulate, costs_in):
    if model not in KERNEL_MODELS:
        raise ValueError(f"the fused kernel implements {KERNEL_MODELS}, not {model!r}")
    m = get_model(model)
    u_dim, s_dim = m.num_controls, m.num_states
    if (u_prev.dim() not in (2, 3) or u_prev.shape[-1] != u_dim
            or u_prev.shape[-2] < 1):
        raise ValueError(f"u_prev must be (T-1, {u_dim}) or (B, T-1, {u_dim}), got "
                         f"{tuple(u_prev.shape)}")
    lead = tuple(u_prev.shape[:-2])  # () or (B,): the fleet's robot axis
    if lead and not 1 <= lead[0] <= MAX_ROBOTS:
        raise ValueError(f"a fleet has 1 to {MAX_ROBOTS} robots, got {lead[0]}")
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if costs_in is not None and not accumulate:
        raise ValueError("the costs-in pass exists to accumulate")
    tm1 = u_prev.shape[-2]
    shapes = {
        "sigma": (sigma, (u_dim,)), "u_min": (u_min, (u_dim,)),
        "u_max": (u_max, (u_dim,)), "state0": (state0, lead + (s_dim,)),
        "scal": (scal, lead + (NSCAL,)),
    }
    if noise is not None:
        shapes["noise"] = (noise, lead + (tm1, num_samples, u_dim))
    if costs_in is not None:
        shapes["costs_in"] = (costs_in, lead + (num_samples,))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if (ref_xy.dim() != len(lead) + 2 or tuple(ref_xy.shape[:-2]) != lead
            or ref_xy.shape[-1] != 2 or ref_xy.shape[-2] < 1):
        raise ValueError(f"ref_xy must be {lead + ('R', 2)}, got {tuple(ref_xy.shape)}")
    tensors = [u_prev, sigma, u_min, u_max, ref_xy, state0, scal]
    tensors += [t for t in (noise, costs_in) if t is not None]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32 only, got {t.dtype}")
        if t.device != u_prev.device:
            raise ValueError(f"all inputs must be on {u_prev.device}, got {t.device}")
    for name, t in (("u_prev", u_prev), ("sigma", sigma), ("u_min", u_min),
                    ("u_max", u_max), ("scal", scal), ("costs_in", costs_in)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bind(lib):
    if getattr(lib, "_rollout_cost_bound", False):
        return lib
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    fn = lib.rollout_cost
    fn.argtypes = [i] + [p] * 11 + [i, i, i, u, u, u, i, i, f, f, i, i, p]
    fn.restype = i
    for name in ("rollout_cost_block_threads", "rollout_cost_num_scalars"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.rollout_cost_model_dims.argtypes = [i]
    lib.rollout_cost_model_dims.restype = i
    lib.rollout_cost_error_string.argtypes = [i]
    lib.rollout_cost_error_string.restype = ctypes.c_char_p
    if lib.rollout_cost_num_scalars() != NSCAL:
        raise RuntimeError("csrc/rollout_cost.cu scalar layout differs from NSCAL")
    for mid, name in enumerate(KERNEL_MODELS):
        m = get_model(name)
        if lib.rollout_cost_model_dims(mid) != m.num_controls * 16 + m.num_states:
            raise RuntimeError(f"csrc/rollout_cost.cu model {mid} is not {name}")
    lib._rollout_cost_bound = True
    return lib


class KernelLaunch:
    """One kernel launch with its operands prepared on the device: the
    centered reference constants [2(r-c), |r-c|^2], the start state
    translated by -c (per robot in a fleet, in one batched pass), the noise
    transposed to a contiguous (..., T-1, U, K), and the outputs. :meth:`run`
    launches on the current stream and raises on a launch error;
    :meth:`finish` reduces the per-block partials."""

    def __init__(self, u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed,
                 step, num_samples, model, steer_off=False, noise=None,
                 accumulate=True, costs_in=None, second_moment=False, robot=0):
        from ccv_mppi_path_tracker_tpu_torch.kernels.build import load_library

        self.lib = _bind(load_library("rollout_cost"))
        dev = u_prev.device
        self.lead = tuple(u_prev.shape[:-2])
        self.tm1, self.u_dim = u_prev.shape[-2:]
        self.lam = scal[..., 16]
        self.second_moment = second_moment
        m2 = second_moment and accumulate
        c, rc2, rn = center_ref(ref_xy)
        refc = torch.cat([rc2, rn[..., None]], dim=-1).contiguous()
        s0 = torch.cat([state0[..., :2] - c, state0[..., 2:]], dim=-1).contiguous()
        noise_t = None if noise is None else noise.transpose(-1, -2).contiguous()
        blocks = -(-num_samples // self.lib.rollout_cost_block_threads())
        self.costs = costs_in
        if costs_in is None:
            self.costs = torch.empty(self.lead + (num_samples,), dtype=torch.float32,
                                     device=dev)
        self.partials = None
        if accumulate:
            row = 2 + (2 if m2 else 1) * self.tm1 * self.u_dim
            self.partials = torch.empty(self.lead + (blocks, row), dtype=torch.float32,
                                        device=dev)
        steer_max, rate_max = 0.0, 0.0
        if model == "rate_limited_steering":
            steer_max, rate_max = steer_limits(model)
        # operands stay referenced by self until the launch is dropped
        self._keep = (u_prev, sigma, u_min, u_max, refc, s0, scal, noise_t)
        self.device = dev

        def ptr(t):
            return None if t is None else t.data_ptr()

        self.args = (
            KERNEL_MODELS.index(model), u_prev.data_ptr(), sigma.data_ptr(),
            u_min.data_ptr(), u_max.data_ptr(), refc.data_ptr(), s0.data_ptr(),
            scal.data_ptr(), ptr(noise_t), ptr(costs_in),
            None if costs_in is not None else self.costs.data_ptr(),
            ptr(self.partials), num_samples, self.tm1 + 1, refc.shape[-2],
            seed & 0xFFFFFFFF, step & 0xFFFFFFFF, robot & 0xFFFFFFFF, int(steer_off),
            int(accumulate), steer_max, rate_max,
            self.lead[0] if self.lead else 1, int(m2),
        )

    def run(self):
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self.lib.rollout_cost(*self.args, stream)
        if err != 0:
            msg = self.lib.rollout_cost_error_string(err).decode()
            raise RuntimeError(f"rollout_cost kernel launch failed: {msg} ({err})")

    def finish(self):
        """(u_num, norm[, u2_num]) per robot: each block's sums rescaled from
        its own baseline m_b to the robot's minimum m by exp(-(m_b -
        m)/lambda), then summed over the robot's blocks; Nones after a
        costs-only pass."""
        if self.partials is None:
            return (None,) * (3 if self.second_moment else 2)
        p = self.partials
        m_blk = p[..., 0]
        neg_rlam = (-1.0 / self.lam)[..., None]
        scale = torch.exp((m_blk - torch.amin(m_blk, dim=-1, keepdim=True)) * neg_rlam)
        nu = self.tm1 * self.u_dim
        shape = self.lead + (self.tm1, self.u_dim)
        out = (torch.sum(scale[..., None] * p[..., 2:2 + nu], dim=-2).reshape(shape),
               torch.sum(scale * p[..., 1], dim=-1))
        if self.second_moment:
            out += (torch.sum(scale[..., None] * p[..., 2 + nu:], dim=-2).reshape(shape),)
        return out


def fused_sample_rollout_cost(
    u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed: int, step: int,
    num_samples: int, model: str, steer_off: bool = False,
    noise: Optional[torch.Tensor] = None, accumulate: bool = True,
    costs_in: Optional[torch.Tensor] = None, second_moment: bool = False,
    robot: int = 0,
):
    """Sample, roll out and cost K trajectories of ``model`` and accumulate
    the softmax-weighted update, in one kernel.

    u_prev: (T-1, U) sampling mean; sigma/u_min/u_max: (U,); ref_xy: (R, 2)
    reference window; state0: (S,); scal: (NSCAL,) from :func:`pack_scalars`,
    whose last slot is the elite threshold (+inf: no mask). seed/step: the
    cycle's Philox key (RNG mode, ``noise=None``); robot: the robot index of
    the RNG counter (0 for one robot). noise: optional standard normals
    (T-1, K, U), the layout of ``sample_controls``. All float32 on one
    device; U and S are the registered model's.

    Fleet: a 3-D u_prev (B, T-1, U) runs B robots in one launch. Then ref_xy
    is (B, R, 2), state0 (B, S), scal (B, NSCAL), noise (B, T-1, K, U) and
    costs_in (B, K); sigma, u_min and u_max are shared. Robot b draws the
    RNG stream of robot index ``robot + b``, and each robot's update is
    under its own baseline. Every output gains the leading (B,) axis.

    accumulate=False: the costs-only pass (the first pass of two-pass elite):
    returns (costs, None, None). costs_in: the costs-free pass, (K,) costs
    of an earlier pass with the same seed, step and noise: the kernel
    regenerates the same controls, skips the rollout, and returns
    (costs_in, u_num, norm). second_moment=True: a fourth output, u2_num
    (T-1, U), the weighted sums of u^2 (None without the update).

    Returns (costs (K,), u_num (T-1, U), norm ()) under the baseline
    min(costs): ``u_opt = u_num / norm``. A CPU tensor runs
    :func:`fused_sample_rollout_cost_reference`; a CUDA tensor launches the
    kernel, counted in ``fused_sample_rollout_cost.launches``.
    """
    _check_inputs(u_prev, sigma, u_min, u_max, ref_xy, state0, scal,
                  num_samples, model, noise, accumulate, costs_in)
    args = (u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed, step,
            num_samples, model, steer_off, noise, accumulate, costs_in,
            second_moment, robot)
    if u_prev.device.type == "cpu":
        return fused_sample_rollout_cost_reference(*args)
    if u_prev.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {u_prev.device}")
    launch = KernelLaunch(*args)
    launch.run()
    fused_sample_rollout_cost.launches += 1
    return (launch.costs,) + launch.finish()


fused_sample_rollout_cost.launches = 0
