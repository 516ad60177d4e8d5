"""The refine stage's guarded Gauss-Newton steps of one full-body robot in one
launch: wrapper of the CUDA kernel ``csrc/gauss_newton.cu`` and its plain
PyTorch version.

Replaces no Pallas kernel: the JAX package's refinement
(``diff/gradients.py gauss_newton_refine``) is plain JAX, and so is the
port's op-by-op version (diff/gradients.py ``gauss_newton_refine_plain``). It
was added for that version's launch chain on the card: about 1650 small
launches a refined update (forward-mode AD over the 145 tangents, matmuls,
``cholesky_ex``/``cholesky_solve``, ``torch.where``), 2.5 ms of device time for
23.6 MFLOP (benchmark/work_refine.py), bound by launch latency. What bounds
the kernel, and what its design does about it, is in the source's note: one
block a robot holds J, J^T J + lambda I and the Cholesky factor in shared
memory, so a step is a few tens of barriers on one SM instead of hundreds of
launches.

The kernel takes the shapes that fit one block's shared memory
(:func:`fits`: full_body's 5 controls, T up to 33 with a window of T points);
diff/gradients.py ``gauss_newton_refine`` calls it where the inputs are float32
CUDA tensors of such a shape that no autograd or ``torch.func`` transform
watches, and runs the op-by-op version everywhere else. A CPU tensor here
runs the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import count_launches

NUM_CONTROLS = 5        # full_body's (csrc kU)
NUM_STATES = 5
THREADS = 256           # csrc kThreads: one block of them a robot
TILE = 16               # csrc kTile: the blocks of J^T J, the Cholesky panels, the solves
MAX_SMEM = 232_448      # csrc kMaxSmem: the shared memory a block may use on sm_90
PER_TIME = 24           # csrc TV_COUNT: the per-time arrays of the primal
SCALARS = 40            # csrc kScalars

# The entry point's parameters, one letter each (i int, f float, p pointer);
# csrc gauss_newton_signature() returns the same, checked when bound.
SIGNATURE = "gauss_newton:" + "p" * 21 + "iiifp"
_CTYPES = {"i": ctypes.c_int, "f": ctypes.c_float, "p": ctypes.c_void_p}

# The device counters the kernel adds to (utils/profiling.py device_group):
# the op-by-op version's, and the steps the kernel took.
COUNTERS = ("refine.lm_steps", "refine.lm_accepted")
FUSED = ("refine.fused_steps",)


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def smem_bytes(horizon: int, num_controls: int, num_ref: int) -> int:
    """The dynamic shared memory of one launch (csrc make_plan): A (np x
    np + 4, np = n rounded up to TILE) and a row for the right-hand side,
    J (m x np), the inverses of the diagonal blocks, six np vectors, two
    residual vectors, two sets of the per-time arrays, the centred window and
    the scalars, in float32. -1 for a shape the kernel has no plan for."""
    if num_controls != NUM_CONTROLS or horizon < 3 or num_ref < 1:
        return -1
    n = (horizon - 1) * num_controls
    np_ = _round_up(n, TILE)
    m = 5 * (horizon - 2) + 1
    floats = ((np_ + 1) * (np_ + 4) + m * np_ + (np_ // TILE) * TILE * TILE + 6 * np_
              + 2 * _round_up(m, 4) + 2 * PER_TIME * _round_up(horizon, 4)
              + 3 * _round_up(num_ref, 4) + SCALARS)
    return 4 * floats


def fits(horizon: int, num_controls: int, num_ref: int) -> bool:
    """Whether the kernel has a plan for the shape within one block: at U=5
    and a window of T points, T from 3 to 33 (T=30: 217,776 bytes). The block
    also needs a thread a row of A and a thread a Jacobian work item (8 a
    time step)."""
    b = smem_bytes(horizon, num_controls, num_ref)
    n = (horizon - 1) * num_controls
    return (0 < b <= MAX_SMEM and _round_up(n, TILE) <= THREADS
            and 8 * (horizon - 1) <= THREADS)


def _bind(lib):
    if getattr(lib, "_gauss_newton_bound", False):
        return lib
    lib.gauss_newton_signature.argtypes = []
    lib.gauss_newton_signature.restype = ctypes.c_char_p
    if lib.gauss_newton_signature().decode() != SIGNATURE:
        raise RuntimeError("csrc/gauss_newton.cu's entry point's parameters differ from "
                           "SIGNATURE")
    lib.gauss_newton.argtypes = [_CTYPES[c] for c in SIGNATURE.split(":")[1]]
    lib.gauss_newton.restype = ctypes.c_int
    for name in ("gauss_newton_threads", "gauss_newton_max_smem"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.gauss_newton_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.gauss_newton_smem_bytes.restype = ctypes.c_int
    lib.gauss_newton_error_string.argtypes = [ctypes.c_int]
    lib.gauss_newton_error_string.restype = ctypes.c_char_p
    if lib.gauss_newton_threads() != THREADS or lib.gauss_newton_max_smem() != MAX_SMEM:
        raise RuntimeError("csrc/gauss_newton.cu's block differs from THREADS/MAX_SMEM")
    for horizon, u_dim, num_ref in ((3, 5, 3), (30, 5, 30), (33, 5, 33), (34, 5, 34),
                                    (100, 5, 100), (30, 3, 30)):
        if lib.gauss_newton_smem_bytes(horizon, u_dim, num_ref) != smem_bytes(horizon, u_dim,
                                                                              num_ref):
            raise RuntimeError("csrc/gauss_newton.cu's shared-memory plan differs from "
                               "smem_bytes")
    lib._gauss_newton_bound = True
    return lib


def _operands(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp: CostParams,
              mp: FullBodyParams):
    """[(name, tensor, required shape)] in the entry point's order; None:
    one element (u and the window are checked apart)."""
    return [
        ("u", u, None), ("state", state, (NUM_STATES,)), ("ref_xy", ref_xy, None),
        ("ref_yaw", ref_yaw, None), ("dt", dt, None), ("u_min", u_min, (NUM_CONTROLS,)),
        ("u_max", u_max, (NUM_CONTROLS,)),
        *[(f"cp.{f.name}", getattr(cp, f.name), None) for f in dataclasses.fields(CostParams)],
        ("mp.mass", mp.mass, None), ("mp.base2com", mp.base2com, None),
        ("mp.inertia", mp.inertia, (3,)), ("mp.gravity_z", mp.gravity_z, None),
    ]


def _problem(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp, mp, num_steps,
             contiguous=True):
    """The first input the kernel does not take, as the exception to raise;
    None where it takes them all."""
    if not isinstance(u, torch.Tensor) or u.dim() != 2 or u.shape[1] != NUM_CONTROLS:
        return ValueError(f"u must be a (T-1, {NUM_CONTROLS}) tensor")
    if not isinstance(ref_xy, torch.Tensor) or ref_xy.dim() != 2 or ref_xy.shape[1] != 2:
        return ValueError("ref_xy must be an (R, 2) tensor")
    if not isinstance(ref_yaw, torch.Tensor) or ref_yaw.dim() != 1 or ref_yaw.shape[0] < 1:
        return ValueError("ref_yaw must be an (R,) tensor")
    if not fits(u.shape[0] + 1, NUM_CONTROLS, ref_xy.shape[0]):
        return ValueError(f"no shared-memory plan fits T={u.shape[0] + 1}, "
                          f"R={ref_xy.shape[0]} in one block ({MAX_SMEM} bytes)")
    if num_steps < 1:
        return ValueError(f"num_steps must be >= 1, got {num_steps}")
    for name, t, shape in _operands(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp, mp):
        if not isinstance(t, torch.Tensor):
            return TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            return TypeError(f"the Gauss-Newton kernel takes float32 only, got {t.dtype} "
                             f"for {name}")
        if t.device != u.device:
            return ValueError(f"all inputs must be on {u.device}, got {t.device} for {name}")
        if shape is None and t.numel() != 1 and name not in ("u", "ref_xy", "ref_yaw"):
            return ValueError(f"{name} must hold one element, got {tuple(t.shape)}")
        if shape is not None and tuple(t.shape) != shape:
            return ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if contiguous and not t.is_contiguous():
            return ValueError(f"{name} must be contiguous")
    return None


def takes(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp, mp, num_steps) -> bool:
    """Whether :func:`gauss_newton_steps` takes these inputs once each is
    made contiguous."""
    return _problem(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp, mp, num_steps,
                    contiguous=False) is None


def _check_inputs(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp, mp, num_steps, counts,
                  fused):
    problem = _problem(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp, mp, num_steps)
    if problem is not None:
        raise problem
    for name, t, n in (("counts", counts, len(COUNTERS)), ("fused", fused, len(FUSED))):
        if t is not None and (t.dtype != torch.int64 or tuple(t.shape) != (n,)
                              or t.device != u.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({n},) int64 tensor on {u.device}")


def gauss_newton_steps_reference(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp, mp,
                                 num_steps, damping, counts=None, fused=None):
    """The plain version: diff/gradients.py's op-by-op steps on the same
    inputs, adding to ``counts`` and ``fused`` as the kernel does."""
    from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
    from ccv_mppi_path_tracker_tpu_torch.diff.gradients import gauss_newton_steps_plain

    out, accepts, _ = gauss_newton_steps_plain(
        SolverConfig(model="full_body"), u, state, RefWindow(ref_xy, ref_yaw), dt,
        u_min, u_max, cp, mp, num_steps, damping)
    accepted = torch.stack(accepts).sum()
    if counts is not None:
        counts.add_(torch.stack([torch.full_like(accepted, num_steps), accepted]))
    if fused is not None:
        fused.add_(num_steps)
    return out


def gauss_newton_steps(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp: CostParams,
                       mp: FullBodyParams, num_steps: int, damping: float, counts=None,
                       fused=None):
    """``num_steps`` Levenberg-Marquardt-guarded Gauss-Newton steps of one
    full_body control sequence, from ``damping``: diff/gradients.py
    ``gauss_newton_refine``'s steps.

    u: (T-1, 5) the sampled update; state (5,); ref_xy (R, 2) and ref_yaw
    (R,) the reference window; dt, each of ``cp``'s weights and v_ref, and
    mp.mass, mp.base2com, mp.gravity_z one element each; mp.inertia (3,);
    u_min, u_max (5,). All contiguous float32 on one device, of a shape that
    :func:`fits`. counts: the (2,) int64 device counters [steps, accepted]
    and fused the (1,) [fused steps] (utils/profiling.py device_group), each
    added to where given. Returns the refined (T-1, 5) sequence.

    A CPU tensor runs :func:`gauss_newton_steps_reference`; a CUDA tensor
    launches the kernel, counted in ``gauss_newton_steps.launches`` (a launch
    captured into a CUDA graph counts once a replay, utils/cuda_graph.py).
    """
    _check_inputs(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp, mp, num_steps, counts,
                  fused)
    if u.device.type == "cpu":
        return gauss_newton_steps_reference(u, state, ref_xy, ref_yaw, dt, u_min, u_max, cp,
                                            mp, num_steps, damping, counts, fused)
    if u.device.type != "cuda":
        raise ValueError(f"no Gauss-Newton kernel for device {u.device}")
    from ccv_mppi_path_tracker_tpu_torch.kernels.build import load_library

    lib = _bind(load_library("gauss_newton"))
    out = torch.empty_like(u)
    ptrs = [t.data_ptr() for _, t, _ in _operands(u, state, ref_xy, ref_yaw, dt, u_min,
                                                  u_max, cp, mp)]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.gauss_newton(*ptrs, out.data_ptr(),
                               None if counts is None else counts.data_ptr(),
                               None if fused is None else fused.data_ptr(),
                               u.shape[0] + 1, ref_xy.shape[0], num_steps, damping, stream)
    if err != 0:
        msg = lib.gauss_newton_error_string(err).decode()
        raise RuntimeError(f"gauss_newton kernel launch failed: {msg} ({err})")
    gauss_newton_steps.launches += 1
    return out


gauss_newton_steps.launches = 0
count_launches(gauss_newton_steps)
