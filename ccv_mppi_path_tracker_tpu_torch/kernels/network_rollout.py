"""The eager update's rollout and tracking cost over AutoRally's learned
network model in one launch: wrapper of the CUDA kernel
``csrc/network_rollout.cu`` and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package has no network model, and the
port's op-by-op version (models/autorally_nn.py ``rollout`` then ``cost``)
is plain PyTorch. It was added for that version's launch chain: ~25
launches an Euler step, each streaming a (K, 7) state, a (K, 6) input or a
(K, 32) activation through HBM, ~780 launches and ~4.6 ms of device time an
update at K=102400, T=30. The kernel keeps every state and activation in
registers, two samples a thread, the weights and the centred window in
shared memory; what bounds it and what its design does about that is in the
source's note.

models/autorally_nn.py ``rollout_cost`` calls it where the inputs are
float32 CUDA tensors of the shapes it takes (:func:`takes`) that no autograd
or ``torch.func`` transform watches, and runs ``cost(rollout(...))``
everywhere else. A CPU tensor here runs :func:`network_rollout_cost_reference`;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import count_launches

NUM_STATES = 7
NUM_CONTROLS = 2
LAYERS = ((6, 32), (32, 32), (32, 4))   # csrc kIn, kH, kOut; models/autorally_nn.py LAYERS
THREADS = 32               # csrc kThreads: a block
SAMPLES_PER_THREAD = 2     # csrc kPer
MAX_REF = 1024             # csrc kMaxRef: window points

# The entry point's parameters, one letter each (i int, p pointer); csrc
# network_rollout_signature() returns the same, checked when bound.
SIGNATURE = "network_rollout_cost:" + "p" * 16 + "iiip"
_CTYPES = {"i": ctypes.c_int, "p": ctypes.c_void_p}

# The device counters the kernel adds to (utils/profiling.py device_group):
# the op-by-op rollout's count of the network's evaluations, and the
# evaluations the kernel ran.
COUNTERS = ("model.nn_evals",)
FUSED = ("model.nn_fused",)

WEIGHT_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")
COST_NAMES = ("v_ref", "path_weight", "v_weight")


def weight_shapes() -> tuple:
    """The shapes of w1, b1, w2, b2, w3, b3: (out, in) and (out,) a layer."""
    return tuple(shape for fan_in, fan_out in LAYERS
                 for shape in ((fan_out, fan_in), (fan_out,)))


def _bind(lib):
    if getattr(lib, "_network_rollout_bound", False):
        return lib
    lib.network_rollout_signature.argtypes = []
    lib.network_rollout_signature.restype = ctypes.c_char_p
    if lib.network_rollout_signature().decode() != SIGNATURE:
        raise RuntimeError("csrc/network_rollout.cu's entry point's parameters differ from "
                           "SIGNATURE")
    lib.network_rollout_cost.argtypes = [_CTYPES[c] for c in SIGNATURE.split(":")[1]]
    lib.network_rollout_cost.restype = ctypes.c_int
    for name in ("network_rollout_threads", "network_rollout_samples_per_thread",
                 "network_rollout_max_ref"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.network_rollout_error_string.argtypes = [ctypes.c_int]
    lib.network_rollout_error_string.restype = ctypes.c_char_p
    if (lib.network_rollout_threads(), lib.network_rollout_samples_per_thread(),
            lib.network_rollout_max_ref()) != (THREADS, SAMPLES_PER_THREAD, MAX_REF):
        raise RuntimeError("csrc/network_rollout.cu's launch differs from THREADS/"
                           "SAMPLES_PER_THREAD/MAX_REF")
    lib._network_rollout_bound = True
    return lib


def _operands(state, controls, dt, params, ref_xy, cp):
    """[(name, tensor, required shape)] in the entry point's order; None:
    one element (controls and the window are checked apart)."""
    return [
        ("state", state, (NUM_STATES,)), ("controls", controls, None),
        *[(f"params.{n}", getattr(params, n), s) for n, s in zip(WEIGHT_NAMES, weight_shapes())],
        ("ref_xy", ref_xy, None), ("dt", dt, None),
        *[(f"cp.{n}", getattr(cp, n), None) for n in COST_NAMES],
    ]


def _problem(state, controls, dt, params, ref_xy, cp, contiguous=True):
    """The first input the kernel does not take, as the exception to raise;
    None where it takes them all."""
    for obj, names, what in ((params, WEIGHT_NAMES, "params"), (cp, COST_NAMES, "cp")):
        missing = [n for n in names if not hasattr(obj, n)]
        if missing:
            return TypeError(f"{what} lacks {', '.join(missing)}")
    if (not isinstance(controls, torch.Tensor) or controls.dim() != 3
            or controls.shape[2] != NUM_CONTROLS or controls.shape[1] < 1):
        return ValueError(f"controls must be a (T-1, K, {NUM_CONTROLS}) tensor, K >= 1")
    if (not isinstance(ref_xy, torch.Tensor) or ref_xy.dim() != 2 or ref_xy.shape[1] != 2
            or not 1 <= ref_xy.shape[0] <= MAX_REF):
        return ValueError(f"ref_xy must be an (R, 2) tensor, 1 <= R <= {MAX_REF}")
    for name, t, shape in _operands(state, controls, dt, params, ref_xy, cp):
        if not isinstance(t, torch.Tensor):
            return TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            return TypeError(f"the network rollout kernel takes float32 only, got {t.dtype} "
                             f"for {name}")
        if t.device != controls.device:
            return ValueError(f"all inputs must be on {controls.device}, got {t.device} for "
                              f"{name}")
        if shape is None and t.numel() != 1 and name not in ("controls", "ref_xy"):
            return ValueError(f"{name} must hold one element, got {tuple(t.shape)}")
        if shape is not None and tuple(t.shape) != shape:
            return ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if contiguous and not t.is_contiguous():
            return ValueError(f"{name} must be contiguous")
    return None


def takes(state, controls, dt, params, ref_xy, cp) -> bool:
    """Whether :func:`network_rollout_cost` takes these inputs once each is
    made contiguous."""
    return _problem(state, controls, dt, params, ref_xy, cp, contiguous=False) is None


def _check_inputs(state, controls, dt, params, ref_xy, cp, evals, fused):
    problem = _problem(state, controls, dt, params, ref_xy, cp)
    if problem is not None:
        raise problem
    for name, t in (("evals", evals), ("fused", fused)):
        if t is not None and (t.dtype != torch.int64 or tuple(t.shape) != (1,)
                              or t.device != controls.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (1,) int64 tensor on "
                             f"{controls.device}")


def network_rollout_cost_reference(state, controls, dt, params, ref_xy, cp, evals=None,
                                   fused=None):
    """The plain version: models/autorally_nn.py's Euler states of every
    sample from ``state`` and their cost, op by op, adding K·(T-1) to
    ``evals`` and ``fused`` as the kernel does."""
    from ccv_mppi_path_tracker_tpu_torch.models import autorally_nn

    k = controls.shape[1]
    states = autorally_nn.euler_states(state.expand(k, -1), controls, dt, params)
    costs = autorally_nn.states_cost(states, ref_xy, cp)
    for group in (evals, fused):
        if group is not None:
            group.add_(controls[..., 0].numel())
    return costs


def network_rollout_cost(state, controls, dt, params, ref_xy, cp, evals=None, fused=None):
    """The (K,) costs of K samples of the network model: each the Euler
    rollout from ``state`` under its controls and its tracking cost,
    models/autorally_nn.py ``cost(rollout(...))``.

    state: (7,) the start state of every sample; controls (T-1, K, 2); dt
    and cp.v_ref, cp.path_weight, cp.v_weight one element each; ``params``
    (models/autorally_nn.py NNParams) the weights of :func:`weight_shapes`;
    ref_xy (R, 2) the reference window, 1 <= R <= :data:`MAX_REF`. All
    contiguous float32 on one device. evals and fused: the (1,) int64
    device counters ``model.nn_evals`` and ``model.nn_fused``
    (utils/profiling.py device_group), each added K·(T-1) where given.

    A CPU tensor runs :func:`network_rollout_cost_reference`; a CUDA tensor
    launches the kernel, counted in ``network_rollout_cost.launches`` (a
    launch captured into a CUDA graph counts once a replay,
    utils/cuda_graph.py).
    """
    _check_inputs(state, controls, dt, params, ref_xy, cp, evals, fused)
    if controls.device.type == "cpu":
        return network_rollout_cost_reference(state, controls, dt, params, ref_xy, cp, evals,
                                              fused)
    if controls.device.type != "cuda":
        raise ValueError(f"no network rollout kernel for device {controls.device}")
    from ccv_mppi_path_tracker_tpu_torch.kernels.build import load_library

    lib = _bind(load_library("network_rollout"))
    tm1, k = controls.shape[0], controls.shape[1]
    costs = torch.empty(k, dtype=torch.float32, device=controls.device)
    ptrs = [t.data_ptr() for _, t, _ in _operands(state, controls, dt, params, ref_xy, cp)]
    with torch.cuda.device(controls.device):
        stream = torch.cuda.current_stream(controls.device).cuda_stream
        err = lib.network_rollout_cost(*ptrs, costs.data_ptr(),
                                       None if evals is None else evals.data_ptr(),
                                       None if fused is None else fused.data_ptr(),
                                       k, tm1, ref_xy.shape[0], stream)
    if err != 0:
        msg = lib.network_rollout_error_string(err).decode()
        raise RuntimeError(f"network rollout kernel launch failed: {msg} ({err})")
    network_rollout_cost.launches += 1
    return costs


network_rollout_cost.launches = 0
count_launches(network_rollout_cost)
