"""The control step's prologue: what the fused kernel's launch needs that the
step prepares before it, for one robot or a fleet, in one launch of
``csrc/rollout_cost.cu step_prologue``, or op by op (its plain version).

Replaces no Pallas kernel: in the JAX package these are XLA ops of the jitted
step, which its compiler fuses (paths/resample.py, the kernel wrapper's
packing). Op by op on the card they were about 45 launches of a few floats
each: the default body parameters, the reference window (nearest point,
indices, gather, yaw), the scalar vector, the centred reference rows, the
centred start state, the finish's tickets and the next key. The kernel does
all of it in one block a robot, rounding each expression as those ops do, so
its outputs equal theirs bit for bit (chip_smoke.py phase 37).

:func:`step_prologue` takes the kernel where the call shows float32 CUDA
tensors that nothing requires grad of, under no ``torch.func`` transform, with
a window that fits one block; everywhere else (the CPU, float64, grad, vmap)
it runs :func:`step_prologue_plain`, the ops the step ran before. Either way
it adds 1 to the device counter ``step.kernel_updates`` on the card, and the
kernel 1 to ``step.prologue_fused`` too (utils/profiling.py).
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import NamedTuple, Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow, advance_key
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    NSCAL,
    _bind,
    finish_groups,
    pack_scalars,
    pad_ref_count,
    pad_ref_rows,
)
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.utils import profiling
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import count_launches

THREADS = 256           # csrc kPrologueThreads: one block of them a robot
MAX_WINDOW = 4096       # csrc kPrologueMaxWindow: the most points T of a window
MAX_STATE = 16          # csrc kPrologueMaxState
YAW_SLOT = 8            # the scalar slot of the window's first yaw (csrc kYawRef0)
SMALLEST_BLOCK = 32     # the fused kernel's smallest block: the most tickets a robot needs

# The device counters (utils/profiling.py device_group): the kernel-path
# updates, and those whose prologue was the kernel.
UPDATES = ("step.kernel_updates",)
FUSED = ("step.prologue_fused",)


class PrologueScalars(ctypes.Structure):
    """csrc PrologueScalars: where each slot of the scalar vector comes from,
    a device float (one a robot where ``per_robot``) or, with a null
    pointer, ``value``."""

    _fields_ = [("ptr", ctypes.c_void_p * NSCAL), ("value", ctypes.c_float * NSCAL),
                ("per_robot", ctypes.c_int * NSCAL)]


class Prologue(NamedTuple):
    """The prologue's outputs. ``ref``: the window, xy (..., T, 2) and yaw
    (..., T); ``scal`` (..., NSCAL); ``model_params``: those given, the
    model's defaults (views of ``scal`` where the kernel wrote them) or None;
    ``refc`` (..., R_pad, 4) and ``s0`` (..., S), the fused kernel's centred
    operands, and ``tickets``, zeros for its finish (all three None from the
    plain version: the launch makes its own); ``next_key``
    [seed, step + 1] (None without a key)."""

    ref: RefWindow
    scal: torch.Tensor
    model_params: object
    refc: Optional[torch.Tensor]
    s0: Optional[torch.Tensor]
    tickets: Optional[torch.Tensor]
    next_key: Optional[torch.Tensor]

    @property
    def launch(self):
        """The ``prepared`` operands of kernels/rollout_cost.py
        fused_sample_rollout_cost, or None."""
        return None if self.refc is None else (self.refc, self.s0, self.tickets)


def ticket_count(num_samples: int) -> int:
    """A robot's tickets, enough for any launch shape of the fused kernel at
    K = ``num_samples``: its blocks at the smallest block size, a ticket a
    group of them and one more."""
    return finish_groups(-(-num_samples // SMALLEST_BLOCK)) + 1


def step_prologue_plain(cfg, path, state, dt, sp, cp, model_params=None, cost_thresh=None,
                        key=None) -> Prologue:
    """The prologue op by op: ``model.default_params`` where no parameters
    are given, ``resample_reference`` (``resample_references`` for a fleet's
    (B, S) ``state``), ``pack_scalars``, ``advance_key``. ``refc``, ``s0``
    and ``tickets`` are None: the fused launch makes its own."""
    from ccv_mppi_path_tracker_tpu_torch.paths.resample import (
        resample_reference,
        resample_references,
    )

    model = get_model(cfg.model)
    if model_params is None and model.default_params is not None:
        model_params = model.default_params(device=state.device, dtype=state.dtype)
    if state.dim() == 1:
        ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
        yaw0 = ref.yaw[0]
    else:
        ref = resample_references(path, state[:, :2], cp.v_ref, dt, cfg.horizon)
        yaw0 = ref.yaw[:, 0]
    scal = pack_scalars(dt, cp, yaw0, model_params, sp.noise_beta, sp.lam,
                        cost_thresh=cost_thresh)
    next_key = None if key is None else advance_key(key)
    return Prologue(ref, scal, model_params, None, None, None, next_key)


@functools.lru_cache(maxsize=None)
def _default_values(model_name: str) -> tuple:
    """The six physical slots of the scalar vector with the model's default
    parameters, as the float32 values ``default_params`` holds (zeros for a
    model without parameters)."""
    model = get_model(model_name)
    if model.default_params is None:
        return (0.0,) * 6
    mp = model.default_params(device="cpu", dtype=torch.float32)
    return tuple(float(v) for v in (mp.mass, mp.base2com, *mp.inertia, mp.gravity_z))


def _slot_sources(dt, cp, sp, model_params, cost_thresh, model_name):
    """The NSCAL slots' sources in pack_scalars's order: a tensor or a number
    each, None for the window's first yaw."""
    mp = model_params
    phys = list(_default_values(model_name)) if mp is None else [
        mp.mass, mp.base2com, mp.inertia[0], mp.inertia[1], mp.inertia[2], mp.gravity_z]
    return [dt, cp.v_ref, cp.path_weight, cp.v_weight, cp.zmp_weight, cp.roll_v_weight,
            cp.back_weight, cp.yaw_weight, None, *phys, sp.noise_beta, sp.lam,
            float("inf") if cost_thresh is None else cost_thresh]


def _on_card(t) -> bool:
    return t.is_cuda


def _kernel_operands(cfg, path, state, dt, sp, cp, model_params, cost_thresh, key):
    """The kernel's operands for this call, or None where the prologue runs
    op by op: off the card, in another dtype than float32 (of the state, the
    path, its resolution, dt or v_ref), with an input that requires grad,
    under a ``torch.func`` transform, or with a window of more than
    MAX_WINDOW points. Every other operand is read as the op-by-op prologue
    reads it: a number slot (dt or v_ref too) as a constant of the launch, a
    slot tensor cast to float32 (a fleet's (1,) one read as a scalar), a
    count of another integer type widened. Raises ValueError for an operand
    the op-by-op prologue could not take either (a shape, a device, a key
    that is not (2,) int64), and TypeError for dt and v_ref both numbers,
    whose product op by op rounds in double."""
    if not (isinstance(state, torch.Tensor) and _on_card(state)):
        return None
    xy, res, nv = path.xy, path.resolution, path.num_valid
    sources = _slot_sources(dt, cp, sp, model_params, cost_thresh, cfg.model)
    floats = [t for t in (state, xy, res, dt, cp.v_ref) if isinstance(t, torch.Tensor)]
    given = floats + [t for t in (nv, key, *sources) if isinstance(t, torch.Tensor)]
    if (any(t.dtype != torch.float32 for t in floats) or cfg.horizon > MAX_WINDOW
            or not profiling.device_counting(*given)):
        return None

    dev = state.device

    def refuse(what):
        raise ValueError(f"step prologue on {dev}: {what}")

    model = get_model(cfg.model)
    if state.dim() not in (1, 2) or state.shape[-1] != model.num_states or not (
            2 <= model.num_states <= MAX_STATE) or state.shape[0] < 1:
        refuse(f"state of shape {tuple(state.shape)}, not ({model.num_states},) or "
               f"(B, {model.num_states})")
    if cfg.horizon < 2:
        refuse(f"a window of {cfg.horizon} points")
    fleet = state.dim() == 2
    num_robots = state.shape[0] if fleet else 1
    xy_per_robot = xy.dim() == 3
    if xy.dim() not in (2, 3) or xy.shape[-1] != 2 or xy.shape[-2] < 1 or (
            xy_per_robot and (not fleet or xy.shape[0] != num_robots)):
        refuse(f"path.xy of shape {tuple(xy.shape)} for state {tuple(state.shape)}")
    per_robot_shape = (num_robots,) if xy_per_robot else ()
    if not isinstance(res, torch.Tensor) or tuple(res.shape) != per_robot_shape:
        refuse(f"path.resolution must be a float32 tensor of shape {per_robot_shape}")
    if isinstance(nv, torch.Tensor):
        if nv.dtype.is_floating_point or nv.dtype == torch.bool or (
                tuple(nv.shape) != per_robot_shape):
            refuse(f"path.num_valid {nv.dtype} {tuple(nv.shape)}, not an integer tensor of "
                   f"shape {per_robot_shape}")
        nv = nv.to(torch.int64)
    elif xy_per_robot:
        refuse("per-robot paths with a number path.num_valid")
    else:
        nv = operator.index(nv)
    if key is not None and (key.dtype != torch.int64 or tuple(key.shape) != (2,)):
        refuse(f"key must be a (2,) int64 tensor [seed, step], got {tuple(key.shape)} "
               f"{key.dtype}")
    if not any(isinstance(t, torch.Tensor) for t in (dt, cp.v_ref)):
        raise TypeError("step prologue: dt and cp.v_ref are both numbers, whose product "
                        "rounds in double op by op; give either as a float32 tensor")
    for i, v in enumerate(sources):
        if isinstance(v, torch.Tensor):
            if fleet and tuple(v.shape) == (1,):
                v = v.reshape(())
            elif v.dim() and (not fleet or tuple(v.shape) != (num_robots,) or i in (0, 1)):
                refuse(f"scalar slot {i} of shape {tuple(v.shape)} for state "
                       f"{tuple(state.shape)}")
            sources[i] = v.to(torch.float32).contiguous()
        elif v is not None and not isinstance(v, (int, float)):
            raise TypeError(f"step prologue: scalar slot {i} is a {type(v).__name__}")
    far = [tuple(t.shape) for t in given if t.device != dev]
    if far:
        refuse(f"operands of shapes {far} on another device")
    return dict(model=model, lead=tuple(state.shape[:-1]), num_robots=num_robots,
                xy=xy.contiguous(), xy_per_robot=xy_per_robot, nv=nv, res=res,
                state=state.contiguous(), key=None if key is None else key.contiguous(),
                sources=sources, horizon=cfg.horizon, model_params=model_params)


def step_prologue_cuda(model, lead, num_robots, xy, xy_per_robot, nv, res, state, key,
                       sources, horizon, model_params, tickets_per_robot: int = 0) -> Prologue:
    """One launch of the kernel on the current stream, on the operands of
    :func:`_kernel_operands` (raises on a launch error), counted in
    ``step_prologue_cuda.launches`` (a launch captured into a CUDA graph
    counts once a replay, utils/cuda_graph.py)."""
    from ccv_mppi_path_tracker_tpu_torch.kernels.build import load_library

    lib = _bind(load_library("rollout_cost"))
    dev = state.device

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    num_ref4 = pad_ref_count(horizon)
    ref_xy, ref_yaw = empty(lead + (horizon, 2)), empty(lead + (horizon,))
    refc, s0 = empty(lead + (num_ref4, 4)), empty(lead + (state.shape[-1],))
    scal = empty(lead + (NSCAL,))
    tickets = empty(num_robots * tickets_per_robot, torch.int32) if tickets_per_robot else None
    next_key = None if key is None else empty((2,), torch.int64)
    sc = PrologueScalars()
    for i, v in enumerate(sources):
        if isinstance(v, torch.Tensor):
            sc.ptr[i] = v.data_ptr()
            sc.per_robot[i] = int(v.dim() == 1)
        elif v is not None:
            sc.value[i] = float(v)
    updates = profiling.device_group(UPDATES, dev)
    fused = profiling.device_group(FUSED, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    nv_tensor = nv if isinstance(nv, torch.Tensor) else None
    with torch.cuda.device(dev):
        err = lib.step_prologue(
            xy.data_ptr(), ptr(nv_tensor), res.data_ptr(), state.data_ptr(), ptr(key),
            ctypes.addressof(sc), ref_xy.data_ptr(), ref_yaw.data_ptr(), refc.data_ptr(),
            s0.data_ptr(), scal.data_ptr(), ptr(tickets), ptr(next_key), ptr(updates),
            ptr(fused), num_robots, xy.shape[-2], horizon, num_ref4, state.shape[-1],
            int(xy_per_robot), int(nv_tensor is not None and nv_tensor.dim() == 1),
            int(res.dim() == 1), tickets_per_robot, 0 if nv_tensor is not None else int(nv),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.rollout_cost_error_string(err).decode()
        raise RuntimeError(f"step_prologue kernel launch failed: {msg} ({err})")
    step_prologue_cuda.launches += 1
    mp = model_params
    if mp is None and model.default_params is not None:
        mp = FullBodyParams(mass=scal[..., 9], base2com=scal[..., 10],
                            inertia=scal[..., 11:14], gravity_z=scal[..., 14])
    return Prologue(RefWindow(ref_xy, ref_yaw), scal, mp, refc, s0, tickets, next_key)


step_prologue_cuda.launches = 0
count_launches(step_prologue_cuda)


def step_prologue(cfg, path, state, dt, sp, cp, model_params=None, cost_thresh=None,
                  key=None, num_samples: Optional[int] = None) -> Prologue:
    """The prologue of a kernel-path update of ``cfg`` at ``state`` (S,), or
    a fleet's (B, S): the kernel where :func:`_kernel_operands` takes the
    call (with tickets for a launch of ``num_samples`` samples, default
    cfg.num_samples), else :func:`step_prologue_plain`. On the card, outside
    a ``torch.func`` transform, the update is counted in
    ``step.kernel_updates``: by the kernel, or by one add after the plain
    version."""
    ops = _kernel_operands(cfg, path, state, dt, sp, cp, model_params, cost_thresh, key)
    if ops is not None:
        k = cfg.num_samples if num_samples is None else num_samples
        return step_prologue_cuda(**ops, tickets_per_robot=ticket_count(k))
    out = step_prologue_plain(cfg, path, state, dt, sp, cp, model_params, cost_thresh, key)
    if _on_card(state) and profiling.device_counting():
        one = profiling.device_constant(1, torch.int64, state.device)
        if one is not None:
            profiling.count_on_device(UPDATES, one)
    return out
