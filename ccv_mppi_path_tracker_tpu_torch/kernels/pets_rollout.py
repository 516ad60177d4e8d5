"""The eager update's particle rollouts and costs over PETS's probabilistic
ensemble in one launch: wrapper of the CUDA kernel ``csrc/pets_rollout.cu``
and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package has no network model, and the
port's op-by-op version (models/pets_pe.py ``particle_states`` then
``states_cost``) is plain PyTorch. It was added for that version's launch
chain: five member-batched SGEMMs a step with swish, the broadcast bias
each writes first and the head's ops, ~1400 launches an update at K=5120,
P=20, T=30, each (5, 20480, 200) activation (82 MB) streamed through HBM
about five times a layer. The kernel keeps every activation in shared
memory and every particle's states and running cost in registers, and
streams the member's weights from L2 through shared memory in chunks; what
bounds it and what its design does about that is in the source's note.

models/pets_pe.py ``rollout_cost`` calls it where the inputs are float32
CUDA tensors of the shapes it takes (:func:`takes`) that no autograd or
``torch.func`` transform watches, and runs ``states_cost(particle_states(...))``
everywhere else. A CPU tensor here runs :func:`pets_rollout_cost_reference`;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import count_launches

NUM_STATES = 7
NUM_CONTROLS = 2
# csrc kIn, kH, kHead; models/pets_pe.py LAYERS
LAYERS = ((6, 200), (200, 200), (200, 200), (200, 200), (200, 8))
OUT = 4                    # csrc kOut: the dynamic states a member predicts
MEMBERS = 5                # csrc kMembers; models/pets_pe.py MEMBERS
PARTICLES = 20             # csrc kParticles; models/pets_pe.py PARTICLES
THREADS = 256              # csrc kThreads: a block
ROWS = 160                 # csrc kRows: particles a block, of one member
CHUNK = 20                 # csrc kChunk: input features a streamed weight chunk
MAX_REF = 1024             # csrc kMaxRef: window points

# The entry point's parameters, one letter each (i int, p pointer); csrc
# pets_rollout_signature() returns the same, checked when bound.
SIGNATURE = "pets_rollout_cost:" + "p" * 25 + "iiip"
_CTYPES = {"i": ctypes.c_int, "p": ctypes.c_void_p}

# The device counters the kernel adds to (utils/profiling.py device_group):
# the member evaluations, which the op-by-op rollout counts too, and the
# evaluations the kernel ran.
COUNTERS = ("model.pe_evals",)
FUSED = ("model.pe_fused",)

# the operands the kernel reads 16 bytes at a time
ALIGNED = ("normals", "params.w2", "params.w3", "params.w4")
PARAM_NAMES = ("mu_in", "sigma_in", "max_logvar", "min_logvar")
COST_NAMES = ("v_ref", "path_weight", "v_weight")


def weight_shapes() -> tuple:
    """The shapes of w1, b1, ..., w5, b5: (E, out, in) and (E, out) a layer."""
    return tuple(shape for fan_in, fan_out in LAYERS
                 for shape in ((MEMBERS, fan_out, fan_in), (MEMBERS, fan_out)))


def _bind(lib):
    if getattr(lib, "_pets_rollout_bound", False):
        return lib
    lib.pets_rollout_signature.argtypes = []
    lib.pets_rollout_signature.restype = ctypes.c_char_p
    if lib.pets_rollout_signature().decode() != SIGNATURE:
        raise RuntimeError("csrc/pets_rollout.cu's entry point's parameters differ from "
                           "SIGNATURE")
    lib.pets_rollout_cost.argtypes = [_CTYPES[c] for c in SIGNATURE.split(":")[1]]
    lib.pets_rollout_cost.restype = ctypes.c_int
    for name in ("pets_rollout_threads", "pets_rollout_rows", "pets_rollout_chunk",
                 "pets_rollout_max_ref"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.pets_rollout_error_string.argtypes = [ctypes.c_int]
    lib.pets_rollout_error_string.restype = ctypes.c_char_p
    if (lib.pets_rollout_threads(), lib.pets_rollout_rows(), lib.pets_rollout_chunk(),
            lib.pets_rollout_max_ref()) != (THREADS, ROWS, CHUNK, MAX_REF):
        raise RuntimeError("csrc/pets_rollout.cu's launch differs from THREADS/ROWS/CHUNK/"
                           "MAX_REF")
    lib._pets_rollout_bound = True
    return lib


def _weights(params):
    return [t for pair in zip(params.w, params.b) for t in pair]


def _operands(state, controls, normals, dt, params, ref_xy, cp):
    """[(name, tensor, required shape)] in the entry point's order; None:
    one element (the state, controls, normals and window are checked
    apart)."""
    names = [f"params.{wb}{n + 1}" for n in range(len(LAYERS)) for wb in "wb"]
    return [
        ("state", state, None), ("controls", controls, None), ("normals", normals, None),
        *[(name, t, s) for name, t, s in zip(names, _weights(params), weight_shapes())],
        *[(f"params.{n}", getattr(params, n), (s,))
          for n, s in zip(PARAM_NAMES, (LAYERS[0][0], LAYERS[0][0], OUT, OUT))],
        ("ref_xy", ref_xy, None), ("dt", dt, None),
        *[(f"cp.{n}", getattr(cp, n), None) for n in COST_NAMES],
    ]


def _problem(state, controls, normals, dt, params, ref_xy, cp, contiguous=True):
    """The first input the kernel does not take, as the exception to raise;
    None where it takes them all."""
    missing = [n for n in ("w", "b", *PARAM_NAMES) if not hasattr(params, n)]
    if missing:
        return TypeError(f"params lacks {', '.join(missing)}")
    missing = [n for n in COST_NAMES if not hasattr(cp, n)]
    if missing:
        return TypeError(f"cp lacks {', '.join(missing)}")
    if len(params.w) != len(LAYERS) or len(params.b) != len(LAYERS):
        return ValueError(f"params must hold {len(LAYERS)} layers")
    if (not isinstance(controls, torch.Tensor) or controls.dim() != 3
            or controls.shape[2] != NUM_CONTROLS or controls.shape[1] < 1):
        return ValueError(f"controls must be a (T-1, K, {NUM_CONTROLS}) tensor, K >= 1")
    tm1, k = controls.shape[0], controls.shape[1]
    if not isinstance(normals, torch.Tensor) or tuple(normals.shape) != (tm1, k * PARTICLES,
                                                                         OUT):
        return ValueError(f"normals must be a (T-1, K·{PARTICLES}, {OUT}) = "
                          f"{(tm1, k * PARTICLES, OUT)} tensor")
    if not isinstance(state, torch.Tensor) or tuple(state.shape) != (NUM_STATES,):
        return ValueError(f"state must be ({NUM_STATES},): the start state of every sequence")
    if (not isinstance(ref_xy, torch.Tensor) or ref_xy.dim() != 2 or ref_xy.shape[1] != 2
            or not 1 <= ref_xy.shape[0] <= MAX_REF):
        return ValueError(f"ref_xy must be an (R, 2) tensor, 1 <= R <= {MAX_REF}")
    for name, t, shape in _operands(state, controls, normals, dt, params, ref_xy, cp):
        if not isinstance(t, torch.Tensor):
            return TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            return TypeError(f"the PETS rollout kernel takes float32 only, got {t.dtype} for "
                             f"{name}")
        if t.device != controls.device:
            return ValueError(f"all inputs must be on {controls.device}, got {t.device} for "
                              f"{name}")
        if (shape is None and t.numel() != 1
                and name not in ("state", "controls", "normals", "ref_xy")):
            return ValueError(f"{name} must hold one element, got {tuple(t.shape)}")
        if shape is not None and tuple(t.shape) != shape:
            return ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if contiguous and not t.is_contiguous():
            return ValueError(f"{name} must be contiguous")
        # (a tensor that is not contiguous is copied to a new, aligned one)
        if name in ALIGNED and t.is_contiguous() and t.data_ptr() % 16:
            return ValueError(f"{name} must start on 16 bytes")
    return None


def takes(state, controls, normals, dt, params, ref_xy, cp) -> bool:
    """Whether :func:`pets_rollout_cost` takes these inputs once each is made
    contiguous."""
    return _problem(state, controls, normals, dt, params, ref_xy, cp, contiguous=False) is None


def _check_inputs(state, controls, normals, dt, params, ref_xy, cp, evals, fused):
    problem = _problem(state, controls, normals, dt, params, ref_xy, cp)
    if problem is not None:
        raise problem
    for name, t in (("evals", evals), ("fused", fused)):
        if t is not None and (t.dtype != torch.int64 or tuple(t.shape) != (1,)
                              or t.device != controls.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (1,) int64 tensor on "
                             f"{controls.device}")


def pets_rollout_cost_reference(state, controls, normals, dt, params, ref_xy, cp, evals=None,
                                fused=None):
    """The plain version: models/pets_pe.py's particle states of every
    sequence from ``state`` and their costs, op by op, adding K·P·(T-1) to
    ``evals`` and ``fused`` as the kernel does."""
    from ccv_mppi_path_tracker_tpu_torch.models import pets_pe

    k = controls.shape[1]
    states = pets_pe.particle_states(state.expand(k, -1), controls, dt, params, normals)
    costs = pets_pe.states_cost(states, ref_xy, cp)
    for group in (evals, fused):
        if group is not None:
            group.add_(PARTICLES * controls[..., 0].numel())
    return costs


def pets_rollout_cost(state, controls, normals, dt, params, ref_xy, cp, evals=None,
                      fused=None):
    """The raw costs (E, K·P/E) of K sequences' P particles, in
    models/pets_pe.py's member-by-member layout: each particle's rollout
    through its member and its tracking cost,
    ``states_cost(particle_states(...))``.

    state: (7,) the start state of every sequence; controls (T-1, K, 2); normals (T-1, K·P, 4), particle index k·P + p; dt
    and cp.v_ref, cp.path_weight, cp.v_weight one element each; ``params``
    (models/pets_pe.py PEParams) the ensemble of :func:`weight_shapes`, the
    standardiser (6,) and the log-variance bounds (4,); ref_xy (R, 2) the
    reference window, 1 <= R <= :data:`MAX_REF`. All contiguous float32 on
    one device, normals and the hidden matrices on 16 bytes. evals and fused:
    the (1,) int64 device counters ``model.pe_evals`` and ``model.pe_fused``
    (utils/profiling.py device_group), each added K·P·(T-1) where given.

    A CPU tensor runs :func:`pets_rollout_cost_reference`; a CUDA tensor
    launches the kernel, counted in ``pets_rollout_cost.launches`` (a launch
    captured into a CUDA graph counts once a replay, utils/cuda_graph.py).
    """
    _check_inputs(state, controls, normals, dt, params, ref_xy, cp, evals, fused)
    if controls.device.type == "cpu":
        return pets_rollout_cost_reference(state, controls, normals, dt, params, ref_xy, cp,
                                           evals, fused)
    if controls.device.type != "cuda":
        raise ValueError(f"no PETS rollout kernel for device {controls.device}")
    from ccv_mppi_path_tracker_tpu_torch.kernels.build import load_library

    lib = _bind(load_library("pets_rollout"))
    tm1, k = controls.shape[0], controls.shape[1]
    costs = torch.empty((MEMBERS, k * PARTICLES // MEMBERS), dtype=torch.float32,
                        device=controls.device)
    ptrs = [t.data_ptr() for _, t, _ in _operands(state, controls, normals, dt, params, ref_xy,
                                                  cp)]
    with torch.cuda.device(controls.device):
        stream = torch.cuda.current_stream(controls.device).cuda_stream
        err = lib.pets_rollout_cost(*ptrs, costs.data_ptr(),
                                    None if evals is None else evals.data_ptr(),
                                    None if fused is None else fused.data_ptr(),
                                    k, tm1, ref_xy.shape[0], stream)
    if err != 0:
        msg = lib.pets_rollout_error_string(err).decode()
        raise RuntimeError(f"PETS rollout kernel launch failed: {msg} ({err})")
    pets_rollout_cost.launches += 1
    return costs


pets_rollout_cost.launches = 0
count_launches(pets_rollout_cost)
