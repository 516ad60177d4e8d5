"""Fused sample + rollout + cost + weighted update: wrapper of the CUDA
kernel ``csrc/rollout_cost.cu`` and its plain PyTorch version.

Counterpart of ``fused_sample_rollout_cost`` in the JAX package's
``kernels/rollout_cost.py`` (the Pallas TPU kernel): the four model
branches, noise-input and in-kernel RNG mode, any K, the elite passes
(costs only, costs in, cost threshold), the second moment (adaptive sigma)
and the fleet grid (a leading robot axis, B robots in one launch). Sampled
controls and rollout states never reach device memory: the kernel writes
the costs, one row of partial sums per block, and, from the last block of
each robot, the finished update.

The launch shape is chosen here, from the shapes alone (:func:`launch_shape`):
the store form (each control drawn once into a shared-memory tile) wherever
32 samples' tiles fit in a block's shared memory, else the regenerate form
(the update draws every control row again); and the threads per block by an
occupancy model of the H100 and how evenly the blocks spread over its
132 SMs.

The RNG mode's key, (seed, step), comes by value from host integers or from
a (2,) int64 device tensor ``key`` [seed, step] that the kernel reads (the
TPU kernel's seed operand): a CUDA graph of the update then replays with the
key the step advances on the device (utils/cuda_graph.py). Both draw the same
stream.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.models import full_body
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import full_body_cost, tracking_cost
from ccv_mppi_path_tracker_tpu_torch.ops.mindist import center_ref
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import rollout, steer_limits
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import sample_controls
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import count_launches

SOURCE = "ccv_mppi_path_tracker_tpu_torch/csrc/rollout_cost.cu"

# Models the kernel implements; the index is the model id of the C entry
# point (csrc/rollout_cost.cu ModelId).
KERNEL_MODELS = ("unicycle", "steering_unicycle", "rate_limited_steering", "full_body")

def should_use_kernel(model: str, device) -> bool:
    """The use_kernel="auto" policy: the fused kernel iff ``device`` is a
    CUDA device and ``model`` is one the kernel implements (a user-registered
    model takes the eager path). No size enters: chip_smoke.py phase 26 found
    the kernel-lean update faster than the eager-lean one at every point of
    its grid, K 16 ... 102400 x T 5 ... 30 (K*(T-1) 64 ... 2969600), for every
    model, on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md section
    5), and fails should a crossover appear there."""
    return torch.device(device).type == "cuda" and model in KERNEL_MODELS


# Scalar slots, the JAX package's pack_scalars layout: [dt, v_ref, path_w,
# v_w, zmp_w, roll_v_w, back_w, yaw_w, yaw_ref0, mass, base2com, Ixx, Iyy,
# Izz, gravity_z, noise_beta, lam, cost_thresh]
NSCAL = 18

# gridDim.y of the fleet grid
MAX_ROBOTS = 65535

# --- the H100 SXM (sm_90), for the launch-shape model ---
NUM_SMS = 132
SMEM_PER_SM = 233_472          # 228 KB of shared memory an SM hands out
SMEM_PER_BLOCK = 232_448       # 227 KB a block may use
SMEM_RESERVED = 1024           # the runtime's share of each resident block
STATIC_SMEM = 64               # the kernel's static shared memory, rounded up
MAX_DYNAMIC_SMEM = SMEM_PER_BLOCK - STATIC_SMEM  # csrc kMaxDynamicSmem
REGS_PER_SM = 65_536
MAX_WARPS_PER_SM = 64
MAX_BLOCKS_PER_SM = 32
MAX_THREADS = 256              # csrc kMaxThreads (__launch_bounds__)
GROUP = 32                     # csrc kGroup: blocks per group of the finish
# Registers per thread of each (model, form), as ptxas reports them for
# sm_90a (chip_smoke.py phase 1 prints them, and the occupancy that follows
# beside the CUDA occupancy calculator's): the __launch_bounds__ cap of 64,
# except full_body's store form (csrc: uncapped, it uses 168).
REGISTERS = {(m, f): 64 for m in KERNEL_MODELS for f in ("store", "regen")}
REGISTERS["full_body", "store"] = 168

# Published peaks of one H100 SXM at 700 W (NVIDIA's H100 datasheet);
# the INT32 rate is half the FP32 one.
FP32_PEAK = 67e12
INT32_PEAK = 33.5e12
HBM_BYTES_PER_S = 3.35e12


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
    u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed: Optional[int],
    step: Optional[int], num_samples: int, model: str, steer_off: bool = False,
    noise: Optional[torch.Tensor] = None, accumulate: bool = True,
    costs_in: Optional[torch.Tensor] = None, second_moment: bool = False,
    robot: int = 0, first_sample: int = 0, key: Optional[torch.Tensor] = None,
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
    if key is not None:
        seed, step = key[0], key[1]
    if u_prev.dim() == 3:
        num_robots, tm1, u_dim = u_prev.shape
        if noise is None:
            robots = robot + torch.arange(num_robots, device=u_prev.device)
            noise = philox_normals(seed, step, num_samples, tm1, u_dim, robot=robots,
                                   device=u_prev.device, dtype=u_prev.dtype,
                                   first_sample=first_sample)

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
                                   device=u_prev.device, dtype=u_prev.dtype,
                                   first_sample=first_sample)
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


def finish_reference(partials, lam, tm1: int, u_dim: int, second_moment: bool = False):
    """Plain version of the kernel's finish: (u_num, norm[, u2_num]) of one
    robot, or of each robot of a fleet, from its per-block partial rows.

    partials: (..., blocks, row) rows [m_b, sum w, sums w*u[t, j] ..., with
    the second moment sums w*u[t, j]^2 ...] (padding columns after them are
    ignored); lam: (...) temperatures. Each row is rescaled from its own
    baseline m_b to the robot's minimum m by exp(-(m_b - m)/lambda), then
    the rows are summed: the exact algebra of the sharded JAX path."""
    p = partials
    lead = tuple(p.shape[:-2])
    m_blk = p[..., 0]
    neg_rlam = (-1.0 / lam)[..., None]
    scale = torch.exp((m_blk - torch.amin(m_blk, dim=-1, keepdim=True)) * neg_rlam)
    nu = tm1 * u_dim
    shape = lead + (tm1, u_dim)
    out = (torch.sum(scale[..., None] * p[..., 2:2 + nu], dim=-2).reshape(shape),
           torch.sum(scale * p[..., 1], dim=-1))
    if second_moment:
        out += (torch.sum(scale[..., None] * p[..., 2 + nu:2 + 2 * nu],
                          dim=-2).reshape(shape),)
    return out


# --- launch shape -----------------------------------------------------------

def _align4(n: int) -> int:
    return (n + 3) & ~3


def finish_groups(blocks: int) -> int:
    """Groups of GROUP blocks per robot in the kernel's two-level finish
    (one group: the block rows are reduced into the outputs directly)."""
    return -(-blocks // GROUP)


def row_floats(nu: int, second_moment: bool) -> int:
    """Floats of one partial row, padded to a multiple of 4 (csrc
    row_floats)."""
    return _align4(2 + (2 if second_moment else 1) * nu)


def pad_ref_count(num_ref: int) -> int:
    """Reference rows after padding to a multiple of 4."""
    return _align4(num_ref)


def smem_bytes(model: str, form: str, second_moment: bool, accumulate: bool,
               threads: int, horizon: int, num_ref: int) -> int:
    """Dynamic shared memory of one block (csrc smem_floats, checked
    against it when the library is bound): the padded reference rows, u_prev
    and the weights row; then the control tile (store form), a slot per
    (warp, sum) (regenerate form) or nothing (costs-only pass); at least the
    finish's sums and the GROUP partial rows of a group (one row where those
    do not fit)."""
    nu = (horizon - 1) * get_model(model).num_controls
    nacc = 1 + (2 if second_moment else 1) * nu
    rs = row_floats(nu, second_moment)
    big = 0
    if accumulate:
        big = nu * threads if form == "store" else (threads // 32) * nacc
    rollout_floats = 4 * pad_ref_count(num_ref) + _align4(nu) + threads + big
    if not accumulate:
        return 4 * rollout_floats
    want = _align4(nacc) + GROUP + GROUP * rs
    least = _align4(nacc) + 4 + rs
    fin = want if 4 * want <= MAX_DYNAMIC_SMEM else least
    return 4 * max(rollout_floats, fin)


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory that one H100 SM holds at once (the occupancy calculator's rules:
    registers allocated per warp in units of 256)."""
    warps = threads // 32
    regs_per_warp = -(-registers * 32 // 256) * 256
    by_regs = REGS_PER_SM // (regs_per_warp * warps)
    by_smem = SMEM_PER_SM // (smem + STATIC_SMEM + SMEM_RESERVED)
    return min(by_regs, by_smem, MAX_WARPS_PER_SM // warps, MAX_BLOCKS_PER_SM)


class LaunchShape(NamedTuple):
    form: str            # "store" or "regen"
    threads: int         # per block, a multiple of 32
    blocks: int          # per robot
    smem: int            # dynamic shared memory bytes per block
    blocks_per_sm: int   # by the occupancy model


def _spread(shape: LaunchShape):
    """How one robot's blocks spread over the SMs, as a sort key: the waves
    of resident blocks on the busiest SM (fractional, at least 1: a part-full
    wave costs its share), then the samples that SM runs."""
    per_sm = -(-shape.blocks // NUM_SMS)
    return max(1.0, per_sm / shape.blocks_per_sm), per_sm * shape.threads


@functools.lru_cache(maxsize=None)
def launch_shape(model: str, num_samples: int, horizon: int, num_ref: int,
                 second_moment: bool = False, accumulate: bool = True,
                 costs_in: bool = False, form: Optional[str] = None,
                 threads: Optional[int] = None) -> LaunchShape:
    """The form and the threads per block of one launch, from its shapes.

    Form: the store form wherever the control tiles of 32 samples fit in a
    block's shared memory, else the regenerate form (the store form was the
    faster at every shape measured, PERF.md). The passes of two-pass elite
    take the regenerate form: the costs-only pass (``accumulate=False``) has
    no update, and the costs-in pass (``costs_in``) has no rollout, so it
    draws each control once in either form, and the regenerate form holds
    more warps (full_body: 0.0860 against 0.1131 ms, PERF.md).
    Threads: among the multiples of 32 up to MAX_THREADS whose block fits,
    the one whose blocks spread most evenly over the 132 SMs (:func:`_spread`:
    fewest waves, then fewest samples on the busiest SM), the larger block
    on a tie (fewer partial rows to finish). The fleet size does not enter
    the choice, so robot b of a fleet launch is bit-equal to a launch of
    robot b alone. ``form`` and ``threads`` override the choice (tests and
    measurements); a shape that does not fit raises. A pure function of its
    arguments, cached: every update asks it again at the same shapes.
    """
    if form is None:
        form = "regen"
        if accumulate and not costs_in and smem_bytes(
                model, "store", second_moment, True, 32, horizon,
                num_ref) <= MAX_DYNAMIC_SMEM:
            form = "store"
    if form not in ("store", "regen") or (form == "store" and not accumulate):
        raise ValueError(f"no {form!r} form for this pass")
    best = None
    for t in ([threads] if threads is not None else range(MAX_THREADS, 31, -32)):
        if t % 32 or not 32 <= t <= MAX_THREADS:
            raise ValueError(f"threads must be a multiple of 32 in [32, {MAX_THREADS}]")
        smem = smem_bytes(model, form, second_moment, accumulate, t, horizon, num_ref)
        bps = 0
        if smem <= MAX_DYNAMIC_SMEM:
            bps = blocks_per_sm(REGISTERS[model, form], t, smem)
        if bps < 1:
            continue
        shape = LaunchShape(form, t, -(-num_samples // t), smem, bps)
        if best is None or _spread(shape) < _spread(best):
            best = shape
    if best is None:
        raise ValueError(f"no launch of the {form} form fits: {model} T={horizon} "
                         f"R={num_ref} second_moment={second_moment}")
    return best


# --- work and bound -----------------------------------------------------------

# float32 operations of one model step inside the rollout, counted from the
# kernel source (csrc/rollout_cost.cu tracking_cost / full_body_cost; an
# FMA counts 2, sin, cos, exp, log and sqrt 1 each, a min, max or compare
# 1): the cost terms, the ZMP chain and the Euler step.
STEP_FLOPS = {"unicycle": 16, "steering_unicycle": 17, "rate_limited_steering": 23,
              "full_body": 54}


def _per_sample_work(model, horizon, num_ref, second_moment, rng, accumulate,
                     costs_in):
    """Operations of one sample, itemized (see :func:`rollout_cost_work`)."""
    m = get_model(model)
    u_dim, tm1 = m.num_controls, horizon - 1
    nu = tm1 * u_dim
    pairs = (u_dim + 1) // 2
    work = {"scan": 0, "step": 0, "sample": u_dim * (7 * tm1 - 3), "box_muller": 0,
            "update": 0, "philox": 0}
    if rng:
        work["box_muller"] = 10 * pairs * tm1
        work["philox"] = 62 * pairs * tm1
    if not costs_in:
        if model == "full_body":
            steps = horizon - 2
            work["scan"] = steps * (5 * num_ref + 6)
            work["step"] = steps * STEP_FLOPS[model] + 6
        else:
            work["scan"] = horizon * (5 * num_ref + 6)
            work["step"] = tm1 * STEP_FLOPS[model] + 2
    if accumulate:
        work["update"] = 6 + (4 if second_moment else 2) * nu
    return work


def rollout_cost_work(model: str, num_samples: int, horizon: int, num_ref: int,
                      second_moment: bool = False, rng: bool = True,
                      num_robots: int = 1, accumulate: bool = True,
                      costs_in: bool = False) -> dict:
    """The work one launch must do, from the shapes alone: float32
    operations, Philox integer operations, and bytes (each input read once,
    each output written once; the partial rows are scratch).

    Per sample (K*B samples), counted from the kernel source; an FMA counts
    2 operations, each sin, cos, exp, log and sqrt 1, each min, max and
    compare 1:

    - scan: each distance scan 5 per reference point (two FMAs and a min)
      plus 6 (|p|^2, the add back, the clamp); T scans for the tracking
      models (T-1 steps and the final state), T-2 for full_body;
    - step: STEP_FLOPS per step (the cost terms, the ZMP chain, the Euler
      step), T-1 steps (tracking, plus 2 for the final path term) or T-2
      (full_body, plus 6 for the yaw term and the hoisted reciprocals);
    - sample: per control 7 (colouring 3, the affine map 2, the clamp 2), the
      first row 4 (no colouring);
    - box_muller (RNG mode): per pair of normals 10 (two int-to-float
      scalings, log1p, the scale by -2, sqrt, the scale by 2*pi, cos, sin,
      and two products), ceil(U/2) pairs a row;
    - update (with accumulate): 6 per sample (the block minimum, the
      threshold compare, the baseline shift and scale, exp, the sum of
      weights) and per control 2 (w*u and its sum), 4 with the second
      moment;
    - philox (integer, RNG mode): 62 per Philox4x32-10 call (10 rounds of
      two high and two low 32-bit products and two three-input XORs, and two
      shifts), one call per pair.

    ``costs_in``: the costs-free elite pass (no scan, no step; the costs
    read instead of written). ``accumulate=False``: the costs-only pass.
    """
    m = get_model(model)
    u_dim, s_dim, tm1 = m.num_controls, m.num_states, horizon - 1
    nu = tm1 * u_dim
    work = _per_sample_work(model, horizon, num_ref, second_moment, rng, accumulate,
                            costs_in)
    samples = num_samples * num_robots
    floats = num_robots * (nu + num_ref * 2 + s_dim + NSCAL) + 3 * u_dim
    if not rng:
        floats += samples * nu
    floats += samples  # the costs, read (costs_in) or written
    if accumulate:
        floats += num_robots * ((2 if second_moment else 1) * nu + 1)
    return {"flops": samples * (sum(work.values()) - work["philox"]),
            "int_ops": samples * work["philox"], "bytes": 4 * floats}


def rollout_cost_bound_ms(model: str, num_samples: int, horizon: int, num_ref: int,
                          second_moment: bool = False, rng: bool = True,
                          num_robots: int = 1, accumulate: bool = True,
                          costs_in: bool = False):
    """(ms, which): the least time an H100 SXM at 700 W could take for the
    work of :func:`rollout_cost_work`, the larger of flops / FP32_PEAK, int
    ops / INT32_PEAK and bytes / HBM_BYTES_PER_S; ``which`` is "fp32",
    "int32" or "bytes", the one that bounds."""
    w = rollout_cost_work(model, num_samples, horizon, num_ref, second_moment, rng,
                          num_robots, accumulate, costs_in)
    times = {"fp32": w["flops"] / FP32_PEAK, "int32": w["int_ops"] / INT32_PEAK,
             "bytes": w["bytes"] / HBM_BYTES_PER_S}
    which = max(times, key=times.get)
    return times[which] * 1e3, which


# --- the launch -----------------------------------------------------------------

def pad_ref_rows(ref_xy):
    """(c, refc): the window's first point c, (2,) or (B, 2), and its
    centered rows [2(rx-cx), 2(ry-cy), |r-c|^2, 0] as (..., R_pad, 4) with R
    padded to a multiple of 4 by rows [0, 0, +inf, 0], which can never be
    the minimum (+inf - x*0 - y*0 = +inf)."""
    c, rc2, rn = center_ref(ref_xy)
    r = ref_xy.shape[-2]
    pad = pad_ref_count(r) - r
    refc = F.pad(torch.cat([rc2, rn[..., None]], dim=-1), (0, 1, 0, pad))
    if pad:
        refc[..., r:, 2] = float("inf")
    return c, refc


def instantiations(summary: dict) -> dict:
    """{(model, second_moment, form): ptxas properties} of the kernel's
    instantiations, from :func:`kernels.build.ptxas_summary`."""
    out = {}
    for name, props in summary.items():
        m = re.search(r"rollout_cost_kernelILi(\d)ELb([01])ELb([01])E", name)
        if m:
            key = (KERNEL_MODELS[int(m.group(1))], m.group(2) == "1",
                   "store" if m.group(3) == "1" else "regen")
            out[key] = props
    return out


def _check_inputs(u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed, step,
                  num_samples, model, noise, accumulate, costs_in, key):
    if key is not None:
        if seed is not None or step is not None:
            raise ValueError("give the RNG key as seed and step or as key, not both")
        if tuple(key.shape) != (2,) or key.dtype != torch.int64:
            raise ValueError(f"key must be a (2,) int64 tensor [seed, step], got "
                             f"{tuple(key.shape)} {key.dtype}")
        if key.device != u_prev.device or not key.is_contiguous():
            raise ValueError(f"key must be contiguous on {u_prev.device}")
    elif noise is None and (seed is None or step is None):
        raise ValueError("the RNG mode needs seed and step, or key")
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


# The C entry point's parameters, one letter each (i int, u unsigned int, f
# float, p pointer): model, store; u_prev ... scal, noise, costs_in, costs,
# partials, counters, key, u_num, norm, u2_num; num_samples, horizon,
# num_ref4, seed, step, robot, first_sample, steer_off, accumulate, steer_max,
# rate_max, num_robots, second_moment, threads; the stream. csrc
# rollout_cost_signature() returns the same string, checked when bound.
SIGNATURE = "ii" + "p" * 16 + "iiiuuuuiiffiiip"
_CTYPES = {"i": ctypes.c_int, "u": ctypes.c_uint, "f": ctypes.c_float, "p": ctypes.c_void_p}


def _bind(lib):
    if getattr(lib, "_rollout_cost_bound", False):
        return lib
    i = ctypes.c_int
    lib.rollout_cost_signature.argtypes = []
    lib.rollout_cost_signature.restype = ctypes.c_char_p
    if lib.rollout_cost_signature().decode() != SIGNATURE:
        raise RuntimeError("csrc/rollout_cost.cu rollout_cost's parameters differ from "
                           "SIGNATURE")
    fn = lib.rollout_cost
    fn.argtypes = [_CTYPES[c] for c in SIGNATURE]
    fn.restype = i
    for name in ("rollout_cost_max_threads", "rollout_cost_num_scalars"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    for name, n in (("rollout_cost_model_dims", 1), ("rollout_cost_smem_bytes", 7),
                    ("rollout_cost_row_floats", 3), ("rollout_cost_blocks_per_sm", 5)):
        getattr(lib, name).argtypes = [i] * n
        getattr(lib, name).restype = i
    lib.rollout_cost_error_string.argtypes = [i]
    lib.rollout_cost_error_string.restype = ctypes.c_char_p
    if lib.rollout_cost_num_scalars() != NSCAL:
        raise RuntimeError("csrc/rollout_cost.cu scalar layout differs from NSCAL")
    if lib.rollout_cost_max_threads() != MAX_THREADS:
        raise RuntimeError("csrc/rollout_cost.cu kMaxThreads differs from MAX_THREADS")
    for mid, name in enumerate(KERNEL_MODELS):
        m = get_model(name)
        if lib.rollout_cost_model_dims(mid) != m.num_controls * 16 + m.num_states:
            raise RuntimeError(f"csrc/rollout_cost.cu model {mid} is not {name}")
        # the shared-memory and row layouts the chooser assumes are the kernel's
        for horizon, num_ref, threads in ((2, 1, 32), (30, 30, 128), (400, 400, 256)):
            for form, m2, acc in (("store", True, True), ("store", False, True),
                                  ("regen", True, True), ("regen", False, False)):
                c_smem = lib.rollout_cost_smem_bytes(mid, form == "store", m2, acc,
                                                     threads, horizon,
                                                     pad_ref_count(num_ref))
                if c_smem != smem_bytes(name, form, m2, acc, threads, horizon, num_ref):
                    raise RuntimeError(f"csrc/rollout_cost.cu shared memory of {name} "
                                       f"differs from smem_bytes")
            nu = (horizon - 1) * m.num_controls
            if lib.rollout_cost_row_floats(mid, 1, horizon) != row_floats(nu, True):
                raise RuntimeError("csrc/rollout_cost.cu row layout differs")
    lib._rollout_cost_bound = True
    return lib


# (device index, stream, length) -> int32 zeros: the tickets of the
# in-kernel finish, one per group and one per robot. The kernel leaves them
# at zero, so each buffer is made once and reused by every launch of that
# length on that stream. A launch captured into a CUDA graph takes zeros of
# its own instead, from the graph's memory, zeroed again at every replay: no
# two graphs share tickets, whatever streams they replay on.
_COUNTERS = {}


def _counters(device, stream: int, length: int):
    key = (device.index, stream, length)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = torch.zeros(length, dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


class KernelLaunch:
    """One kernel launch with its operands prepared on the device: the
    padded centered reference rows (:func:`pad_ref_rows`), the start state
    translated by -c (per robot in a fleet, in one batched pass), the noise
    transposed to a contiguous (..., T-1, U, K), the launch shape
    (:func:`launch_shape`; ``form`` and ``threads`` override it), and the
    outputs. :meth:`run` launches on the current stream and raises on a
    launch error; :meth:`finish` returns the update the kernel finished."""

    def __init__(self, u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed,
                 step, num_samples, model, steer_off=False, noise=None,
                 accumulate=True, costs_in=None, second_moment=False, robot=0,
                 first_sample=0, key=None, form=None, threads=None):
        from ccv_mppi_path_tracker_tpu_torch.kernels.build import load_library

        self.lib = _bind(load_library("rollout_cost"))
        dev = u_prev.device
        self.lead = tuple(u_prev.shape[:-2])
        self.num_robots = self.lead[0] if self.lead else 1
        self.tm1, self.u_dim = u_prev.shape[-2:]
        self.lam = scal[..., 16]
        self.second_moment = second_moment
        self.accumulate = accumulate
        m2 = second_moment and accumulate
        num_ref = ref_xy.shape[-2]
        self.shape = launch_shape(model, num_samples, self.tm1 + 1, num_ref, m2,
                                  accumulate, costs_in is not None, form=form,
                                  threads=threads)
        c, refc = pad_ref_rows(ref_xy)
        s0 = torch.cat([state0[..., :2] - c, state0[..., 2:]], dim=-1).contiguous()
        noise_t = None if noise is None else noise.transpose(-1, -2).contiguous()
        out_shape = self.lead + (self.tm1, self.u_dim)

        def empty(shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        self.costs = costs_in if costs_in is not None else empty(self.lead + (num_samples,))
        self.partials = self.u_num = self.norm = self.u2_num = None
        groups = finish_groups(self.shape.blocks)
        self.num_counters = self.num_robots * (groups + 1)
        rows = None
        if accumulate:
            # the block rows, then the group rows of the two-level finish
            rows = empty(self.lead + (self.shape.blocks + groups,
                                      row_floats(self.tm1 * self.u_dim, m2)))
            self.partials = rows[..., :self.shape.blocks, :]
            self.u_num, self.norm = empty(out_shape), empty(self.lead)
            if m2:
                self.u2_num = empty(out_shape)
        steer_max, rate_max = 0.0, 0.0
        if model == "rate_limited_steering":
            steer_max, rate_max = steer_limits(model)
        # operands stay referenced by self until the launch is dropped
        self._keep = (u_prev, sigma, u_min, u_max, refc, s0, scal, noise_t, rows, key)
        self.key = key
        self.device = dev

        def ptr(t):
            return None if t is None else t.data_ptr()

        self._head = (
            KERNEL_MODELS.index(model), int(self.shape.form == "store"),
            u_prev.data_ptr(), sigma.data_ptr(), u_min.data_ptr(), u_max.data_ptr(),
            refc.data_ptr(), s0.data_ptr(), scal.data_ptr(), ptr(noise_t),
            ptr(costs_in), None if costs_in is not None else self.costs.data_ptr(),
            ptr(rows),
        )
        self._tail = (
            ptr(self.u_num), ptr(self.norm), ptr(self.u2_num), num_samples,
            self.tm1 + 1, refc.shape[-2], (seed or 0) & 0xFFFFFFFF,
            (step or 0) & 0xFFFFFFFF,
            robot & 0xFFFFFFFF, first_sample & 0xFFFFFFFF, int(steer_off),
            int(accumulate), steer_max, rate_max,
            self.num_robots, int(m2), self.shape.threads,
        )

    def run(self):
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            counters = None
            if self.accumulate:
                if torch.cuda.is_current_stream_capturing():
                    tickets = torch.zeros(self.num_counters, dtype=torch.int32,
                                          device=self.device)
                else:
                    tickets = _counters(self.device, stream, self.num_counters)
                counters = tickets.data_ptr()
            err = self.lib.rollout_cost(*self._head, counters,
                                        None if self.key is None else self.key.data_ptr(),
                                        *self._tail, stream)
        if err != 0:
            msg = self.lib.rollout_cost_error_string(err).decode()
            raise RuntimeError(f"rollout_cost kernel launch failed: {msg} ({err})")

    def finish(self):
        """(u_num, norm[, u2_num]) per robot, as the kernel's last block of
        each robot finished them (:func:`finish_reference` is the plain
        version); Nones after a costs-only pass. Launches nothing."""
        if not self.accumulate:
            return (None,) * (3 if self.second_moment else 2)
        out = (self.u_num, self.norm)
        if self.second_moment:
            out += (self.u2_num,)
        return out


def fused_sample_rollout_cost(
    u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed: Optional[int],
    step: Optional[int], num_samples: int, model: str, steer_off: bool = False,
    noise: Optional[torch.Tensor] = None, accumulate: bool = True,
    costs_in: Optional[torch.Tensor] = None, second_moment: bool = False,
    robot: int = 0, first_sample: int = 0, key: Optional[torch.Tensor] = None,
):
    """Sample, roll out and cost K trajectories of ``model`` and accumulate
    the softmax-weighted update, in one kernel.

    u_prev: (T-1, U) sampling mean; sigma/u_min/u_max: (U,); ref_xy: (R, 2)
    reference window; state0: (S,); scal: (NSCAL,) from :func:`pack_scalars`,
    whose last slot is the elite threshold (+inf: no mask). seed/step: the
    cycle's Philox key (RNG mode, ``noise=None``) as host integers, passed
    by value; or None, and ``key`` a (2,) int64 tensor [seed, step] on the
    device of the other inputs, which the kernel reads (the same draw, and a
    CUDA graph's replay reads the key's current value); robot: the robot index of
    the RNG counter (0 for one robot); first_sample: the sample index of the
    RNG counter's first sample (a shard of a sample-sharded update draws
    samples first_sample ... first_sample+K-1 of the unsharded stream).
    noise: optional standard normals
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
    draws the same controls, skips the rollout, and returns
    (costs_in, u_num, norm). second_moment=True: a fourth output, u2_num
    (T-1, U), the weighted sums of u^2 (None without the update).

    Returns (costs (K,), u_num (T-1, U), norm ()) under the baseline
    min(costs): ``u_opt = u_num / norm``. A CPU tensor runs
    :func:`fused_sample_rollout_cost_reference`; a CUDA tensor launches the
    kernel, counted in ``fused_sample_rollout_cost.launches`` (a launch
    captured into a CUDA graph counts once a replay, utils/cuda_graph.py).
    """
    _check_inputs(u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed, step,
                  num_samples, model, noise, accumulate, costs_in, key)
    args = (u_prev, sigma, u_min, u_max, ref_xy, state0, scal, seed, step,
            num_samples, model, steer_off, noise, accumulate, costs_in,
            second_moment, robot, first_sample, key)
    if u_prev.device.type == "cpu":
        return fused_sample_rollout_cost_reference(*args)
    if u_prev.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {u_prev.device}")
    launch = KernelLaunch(*args)
    launch.run()
    fused_sample_rollout_cost.launches += 1
    return (launch.costs,) + launch.finish()


fused_sample_rollout_cost.launches = 0
count_launches(fused_sample_rollout_cost)
