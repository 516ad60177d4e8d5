"""The eager update's fused PETS ensemble rollout (kernels/pets_rollout.py,
csrc/pets_rollout.cu) on the CPU: which calls models/pets_pe.py
``rollout_cost`` hands to it, that the CPU keeps ``rollout_cost`` and the
eager update bit for bit as they were, the wrapper's checks, its binding
against the source's entry point, the kernel's arithmetic, the counters and
the reader ``pe_fused.pe``.

The kernel's own code is compiled here with g++ against a small stand-in of
the CUDA runtime (a lane a ``ucontext`` fiber, the 256 lanes of a block run
in turn on one thread, ``__syncthreads`` handing over to the next lane; the
asynchronous copies plain copies; the ``__f*_rn`` operations plain float
operations with contraction off) and held to the plain version. Its costs
differ from the plain version's only where the CPU's matrix products sum in
another order than the kernel's ascending chains, and where glibc's expf,
log1pf, sinf and cosf round otherwise than CUDA's: 2.6e-7 relative at most
over these cases, so the costs are held to 1e-6. The kernel itself runs only
on the card: chip_smoke.py phase 40 holds it to the plain version there."""

import ctypes
import dataclasses
import json
import re
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from ccv_mppi_path_tracker_tpu_torch.core.presets import pets_pe_launch
from ccv_mppi_path_tracker_tpu_torch.core.random import PROPAGATION_ROBOT
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, RefWindow
from ccv_mppi_path_tracker_tpu_torch.kernels import build
from ccv_mppi_path_tracker_tpu_torch.kernels import pets_rollout as pr
from ccv_mppi_path_tracker_tpu_torch.models import pets_pe
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals, sample_controls
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import softmax_weights, weighted_update
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.solver import compile_step, mppi_step
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "ccv_mppi_path_tracker_tpu_torch" / "csrc" / "pets_rollout.cu"
K, T = 16, 6
E, P = pets_pe.MEMBERS, pets_pe.PARTICLES
COST_RTOL = 1e-6        # see the module docstring
U_GAP = 1e-6            # of the box: the update through the kernel's code
BOX = 2.0


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def problem(k=K, t=T, seed=3, dtype=torch.float32):
    """(cfg, sp, cp, path, state, ctrl) of the ensemble at K=k, T=t on the
    CPU: the cell's course at a seeded offset, a seeded pose with a seeded
    roll and velocities, a seeded warm start inside the box."""
    with open(ROOT / "benchmark" / "configs" / "pets_pe-K5120-P20-T30.json") as f:
        conf = json.load(f)
    rng = harness.inputs_rng(seed)
    course = harness.course_for(conf, {"course_offset_m": 1.0}, rng)
    state = torch.from_numpy(harness.start_pose(course, 7, rng, [0.05] * 3)).to(dtype)
    g = torch.Generator().manual_seed(seed)
    state[3:] = (0.3 * torch.randn(4, generator=g)).to(dtype)
    cfg, sp, cp, _ = pets_pe_launch(num_samples=k, horizon=t, dtype=dtype, device="cpu")
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device="cpu")
    u_prev = torch.clamp(0.4 * torch.randn((t - 1, 2), generator=g), -1.0, 1.0).to(dtype)
    return cfg, sp, cp, path, state, ControllerState(u_prev, seed, 2)


def hook_args(k=K, t=T, seed=3, dtype=torch.float32):
    """(state0, controls, dt, params, ref, cp, rng): rollout_cost's
    arguments as the eager arm passes them."""
    cfg, sp, cp, path, state, ctrl = problem(k, t, seed, dtype)
    dt = torch.tensor(0.1, dtype=dtype)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, t)
    noise = draw_standard_normals(**ctrl.rng(), shape=(t - 1, k, 2), dtype=dtype, device="cpu")
    u = sample_controls(ctrl.u_prev, sp, k, noise=noise) if t > 1 else noise
    return (state.expand(k, -1), u, dt, pets_pe.default_params("cpu", dtype), ref, cp,
            ctrl.rng())


def propagation_normals(u, rng):
    tm1, k, _ = u.shape
    return draw_standard_normals(**rng, shape=(tm1, k * P, pets_pe.OUT), robot=PROPAGATION_ROBOT,
                                 dtype=u.dtype, device=u.device)


def parent_rollout_cost(state0, u, dt, params, ref, cp, rng):
    """models/pets_pe.py ``rollout_cost`` as it was before the kernel,
    frozen, without its counters: the (K,) sequence costs."""
    costs = pets_pe.states_cost(pets_pe.particle_states(state0, u, dt, params,
                                                        propagation_normals(u, rng)),
                                ref.xy, cp)
    costs = torch.where(torch.isfinite(costs), costs, pets_pe.NONFINITE_COST)
    k = u.shape[1]
    return torch.mean(costs.reshape(E, k, P // E).permute(1, 2, 0).reshape(k, P), dim=1)


def wrapper_args(k=K, t=T, seed=3):
    state0, u, dt, params, ref, cp, rng = hook_args(k, t, seed)
    return dict(state=state0[0], controls=u, normals=propagation_normals(u, rng), dt=dt,
                params=params, ref_xy=ref.xy.contiguous(), cp=cp)


@pytest.fixture
def on_the_card(monkeypatch):
    """Dispatch as if the tensors were on the card, with the launcher
    replaced by one that records its call and returns the plain version's
    costs (counting as the kernel does): what reaches it would launch."""
    launched = []

    def launch(*args, **kwargs):
        launched.append((args, kwargs))
        return pr.pets_rollout_cost_reference(*args, **kwargs)

    monkeypatch.setattr(pets_pe, "_on_card", lambda t: True)
    monkeypatch.setattr(pr, "pets_rollout_cost", launch)
    return launched


def refuse(*args, **kwargs):
    raise AssertionError("the PETS rollout kernel was launched")


# --- the dispatch ---------------------------------------------------------------------------

def test_the_kernel_s_shapes_are_the_model_s():
    assert (pr.LAYERS, pr.MEMBERS, pr.PARTICLES, pr.OUT) == (
        pets_pe.LAYERS, pets_pe.MEMBERS, pets_pe.PARTICLES, pets_pe.OUT)
    assert pets_pe.EVALS == pr.COUNTERS


def test_the_cpu_runs_the_plain_version(monkeypatch):
    monkeypatch.setattr(pr, "pets_rollout_cost", refuse)
    state0, u, dt, params, ref, cp, rng = hook_args()
    normals = propagation_normals(u, rng)
    assert pets_pe._fused_operands(state0, u, normals, dt, params, ref, cp) is None
    got = pets_pe.rollout_cost(state0, u, dt, params, ref, cp, **rng)
    assert torch.equal(got, parent_rollout_cost(state0, u, dt, params, ref, cp, rng))
    assert profiling.counters() == {"model.pe_evals": K * P * (T - 1)}


def test_a_float32_call_on_the_card_goes_to_the_kernel(on_the_card):
    """The operands reach the launcher once, contiguous, the start state as
    the one state it expands, the draw's normals, a number dt made a tensor,
    with the counters' groups of utils/profiling.py; the costs and the
    counters are the op-by-op version's."""
    state0, u, dt, params, ref, cp, rng = hook_args()
    strided = u.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    ref = RefWindow(ref.xy.T.contiguous().T, ref.yaw)
    costs = pets_pe.rollout_cost(state0, strided, 0.1, params, ref, cp, **rng)
    (args, kwargs), = on_the_card
    state, controls, normals, dt_t, p, xy, c = args
    assert torch.equal(state, state0[0]) and state.shape == (7,)
    assert controls.is_contiguous() and torch.equal(controls, u)
    assert torch.equal(normals, propagation_normals(u, rng))
    assert xy.is_contiguous() and torch.equal(xy, ref.xy)
    assert dt_t.dtype == torch.float32 and dt_t.item() == pytest.approx(0.1)
    assert all(a is b for a, b in zip(p.w + p.b, params.w + params.b))
    assert torch.equal(c.v_ref, cp.v_ref)
    cpu = torch.device("cpu")
    assert kwargs["evals"] is profiling._DEVICE_COUNTERS[(pr.COUNTERS, cpu)]
    assert kwargs["fused"] is profiling._DEVICE_COUNTERS[(pr.FUSED, cpu)]
    want = parent_rollout_cost(state0, u, torch.tensor(0.1), params, ref, cp, rng)
    assert costs.shape == (K,) and torch.equal(costs, want)
    assert profiling.counters() == {"model.pe_evals": K * P * (T - 1),
                                    "model.pe_fused": K * P * (T - 1)}


def test_default_weights_go_to_the_kernel(on_the_card):
    state0, u, dt, _, ref, cp, rng = hook_args()
    pets_pe.rollout_cost(state0, u, dt, None, ref, cp, **rng)
    (args, _), = on_the_card
    assert args[4].w[1] is pets_pe.default_params("cpu").w[1]


def test_a_float32_call_on_a_card_launches_the_kernel():
    """On a card: one launch, the costs within COST_RTOL of the op-by-op
    version's (chip_smoke.py phase 40 runs this at the cell's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here; chip_smoke.py phase 40 runs the kernel on the card")
    dev = torch.device("cuda", 0)
    state0, u, dt, _, ref, cp, rng = hook_args()
    params = pets_pe.default_params(dev)
    cp = dataclasses.replace(cp, **{f.name: getattr(cp, f.name).to(dev)
                                    for f in dataclasses.fields(cp)})
    args = (state0.to(dev), u.to(dev), dt.to(dev), params,
            RefWindow(ref.xy.to(dev), ref.yaw.to(dev)), cp)
    before = pr.pets_rollout_cost.launches
    got = pets_pe.rollout_cost(*args, seed=rng["seed"], step=rng["step"])
    assert pr.pets_rollout_cost.launches == before + 1
    want = parent_rollout_cost(*args, dict(key=None, seed=rng["seed"], step=rng["step"]))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=0)


@pytest.mark.parametrize("case", ["float64", "grad_controls", "grad_weight", "grad_cost",
                                  "weight_shape", "members", "long_window", "number_weight",
                                  "off_16_bytes", "states", "states_of_another_count"])
def test_the_plain_version_runs_where_the_kernel_does_not_take_the_call(case, on_the_card,
                                                                        monkeypatch):
    """float64, grad on a control, a weight or a cost weight, a hidden layer
    of another width, another number of members, a window past MAX_REF
    points, a cost weight that is a number, a hidden matrix that starts off
    16 bytes, K distinct start states or start states of another count: the
    call runs op by op even on the card, bit for bit as before."""
    monkeypatch.setattr(pr, "pets_rollout_cost", refuse)
    dtype = torch.float64 if case == "float64" else torch.float32
    state0, u, dt, params, ref, cp, rng = hook_args(dtype=dtype)
    if case == "grad_controls":
        u = u.clone().requires_grad_(True)
    if case == "grad_weight":
        params = dataclasses.replace(params, w=(params.w[0], params.w[1].clone().requires_grad_(
            True), *params.w[2:]))
    if case == "grad_cost":
        cp = dataclasses.replace(cp, path_weight=cp.path_weight.clone().requires_grad_(True))
    if case == "weight_shape":       # 100 units in the first hidden layer
        params = dataclasses.replace(params, w=(params.w[0][:, :100], params.w[1][:, :, :100],
                                                *params.w[2:]),
                                     b=(params.b[0][:, :100], *params.b[1:]))
    if case == "members":            # 4 members of 5 particles
        params = dataclasses.replace(params, w=tuple(w[:4] for w in params.w),
                                     b=tuple(b[:4] for b in params.b))
    if case == "long_window":
        ref = RefWindow(torch.cat([ref.xy] * (pr.MAX_REF // T + 1)), ref.yaw)
    if case == "number_weight":
        cp = dataclasses.replace(cp, v_weight=1.0)
    if case == "off_16_bytes":
        w2 = torch.empty(params.w[1].numel() + 1)[1:].view_as(params.w[1]).copy_(params.w[1])
        params = dataclasses.replace(params, w=(params.w[0], w2, *params.w[2:]))
    if case == "states":
        state0 = state0 + torch.linspace(0.0, 0.1, K)[:, None]
    if case == "states_of_another_count":
        state0 = state0[:1].expand(2, -1)
    normals = propagation_normals(u.detach(), rng)
    assert pets_pe._fused_operands(state0, u, normals, dt, params, ref, cp) is None
    if case in ("members", "states_of_another_count"):
        return              # the op-by-op version takes only P/E particles a member, K states
    with torch.enable_grad():
        got = pets_pe.rollout_cost(state0, u, dt, params, ref, cp, **rng)
        want = parent_rollout_cost(state0, u, dt, params, ref, cp, rng)
    assert torch.equal(got, want)


def test_no_kernel_under_a_torch_func_transform(on_the_card):
    state0, u, dt, params, ref, cp, rng = hook_args()
    normals = propagation_normals(u, rng)
    seen = []
    torch.func.vmap(lambda x: seen.append(
        pets_pe._fused_operands(state0, u, normals, dt, params, ref, cp)) or x)(torch.ones(2))
    assert seen == [None]
    assert pets_pe._fused_operands(state0, u, normals, dt, params, ref, cp) is not None


def parent_eager(cfg, ctrl, state, path, dt, sp, cp):
    """``mppi_step``'s eager arm for the ensemble as it was before the
    kernel, frozen: (u_opt, stats)."""
    params = pets_pe.default_params(state.device, state.dtype)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    tm1, u_dim = ctrl.u_prev.shape
    noise = draw_standard_normals(**ctrl.rng(), shape=(tm1, cfg.num_samples, u_dim),
                                  dtype=ctrl.u_prev.dtype, device=state.device)
    u = sample_controls(ctrl.u_prev, sp, cfg.num_samples, steer_off=cfg.steer_off, noise=noise)
    costs = parent_rollout_cost(state.expand(cfg.num_samples, -1), u, dt, params, ref, cp,
                                ctrl.rng())
    weights, stats = softmax_weights(costs, sp.lam)
    return weighted_update(weights, u), stats


@pytest.mark.parametrize("route", ["cpu", "wrapper"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_the_eager_update_is_bit_for_bit_the_parent_s(seed, dtype, route, monkeypatch):
    """On the CPU (and through the wrapper's plain version, as if on the
    card, where the dtype lets it) u_opt and the stats equal the parent's
    eager arm; the fused counter counts only the wrapper's float32 calls."""
    if route == "wrapper":
        monkeypatch.setattr(pets_pe, "_on_card", lambda t: True)
    cfg, sp, cp, path, state, ctrl = problem(seed=seed, dtype=dtype)
    dt = torch.tensor(0.1, dtype=dtype)
    want_u, want_stats = parent_eager(cfg, ctrl, state, path, dt, sp, cp)
    _, res = mppi_step(cfg, ctrl, state, path, dt, sp, cp)
    assert torch.equal(res.u_opt, want_u)
    assert all(torch.equal(res.stats[name], want) for name, want in want_stats.items())
    counted = profiling.counters()
    # the particles', and the planned path's ensemble-mean rollout (E a step)
    assert counted["model.pe_evals"] == K * P * (T - 1) + E * (T - 1)
    fused = K * P * (T - 1) if route == "wrapper" and dtype == torch.float32 else 0
    assert counted.get("model.pe_fused", 0) == fused


def test_a_compiled_update_takes_the_wrapper_once_a_call(on_the_card):
    """compile_step(use_kernel="auto") on the CPU, as if on the card: each
    chained call hands the particles to the launcher once."""
    cfg, sp, cp, path, state, ctrl = problem()
    step = compile_step(cfg, use_kernel="auto", lean=True)
    for _ in range(3):
        ctrl, _ = step(ctrl, state, path, torch.tensor(0.1), sp, cp)
    assert len(on_the_card) == 3
    assert profiling.counters()["model.pe_fused"] == 3 * K * P * (T - 1)


# --- the wrapper ------------------------------------------------------------------------------

def meta_args(k=5120, t=30):
    meta = dict(device="meta", dtype=torch.float32)
    shapes = pr.weight_shapes()
    params = pets_pe.PEParams(tuple(torch.empty(s, **meta) for s in shapes[0::2]),
                              tuple(torch.empty(s, **meta) for s in shapes[1::2]),
                              torch.empty(6, **meta), torch.empty(6, **meta),
                              torch.empty(4, **meta), torch.empty(4, **meta))
    cp = types.SimpleNamespace(**{n: torch.empty((), **meta) for n in pr.COST_NAMES})
    return (torch.empty(7, **meta), torch.empty((t - 1, k, 2), **meta),
            torch.empty((t - 1, k * P, 4), **meta), torch.empty((), **meta), params,
            torch.empty((t, 2), **meta), cp)


def test_the_wrapper_takes_the_cell_s_shapes():
    assert pr.takes(*meta_args())
    with pytest.raises(ValueError, match="no PETS rollout kernel for device meta"):
        pr.pets_rollout_cost(*meta_args())


@pytest.mark.parametrize("bad", ["dtype", "shape_state", "states", "shape_controls", "no_samples",
                                 "shape_normals", "weight_shape", "layers", "bounds_shape",
                                 "no_window", "long_window", "scalar_shape", "device",
                                 "contiguous", "off_16_bytes", "number_dt", "params", "cp",
                                 "counter_dtype", "counter_shape"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a = wrapper_args()
    evals = None
    if bad == "dtype":
        a["controls"] = a["controls"].double()
    if bad == "shape_state":
        a["state"] = a["state"][:5]
    if bad == "states":
        a["state"] = a["state"].expand(K, -1).contiguous()
    if bad == "shape_controls":
        a["controls"] = torch.zeros((T - 1, K, 3))
    if bad == "no_samples":
        a["controls"] = torch.zeros((T - 1, 0, 2))
    if bad == "shape_normals":
        a["normals"] = a["normals"][:, :K]
    if bad == "weight_shape":
        a["params"] = dataclasses.replace(a["params"], b=(*a["params"].b[:-1], torch.zeros(E, 9)))
    if bad == "layers":
        a["params"] = dataclasses.replace(a["params"], w=a["params"].w[:4], b=a["params"].b[:4])
    if bad == "bounds_shape":
        a["params"] = dataclasses.replace(a["params"], max_logvar=torch.zeros(5))
    if bad == "no_window":
        a["ref_xy"] = torch.zeros((0, 2))
    if bad == "long_window":
        a["ref_xy"] = torch.zeros((pr.MAX_REF + 1, 2))
    if bad == "scalar_shape":
        a["dt"] = torch.full((2,), 0.1)
    if bad == "device":
        a["dt"] = torch.empty((), device="meta")
    if bad == "contiguous":
        a["controls"] = a["controls"].transpose(0, 1).contiguous().transpose(0, 1)
    if bad == "off_16_bytes":
        a["normals"] = torch.empty(a["normals"].numel() + 1)[1:].view_as(a["normals"])
    if bad == "number_dt":
        a["dt"] = 0.1
    if bad == "params":
        a["params"] = types.SimpleNamespace(w=a["params"].w)
    if bad == "cp":
        a["cp"] = types.SimpleNamespace(v_ref=a["cp"].v_ref)
    if bad == "counter_dtype":
        evals = torch.zeros(1, dtype=torch.int32)
    if bad == "counter_shape":
        evals = torch.zeros(2, dtype=torch.int64)
    error = TypeError if bad in ("dtype", "number_dt", "params", "cp") else ValueError
    with pytest.raises(error):
        pr.pets_rollout_cost(**a, evals=evals)
    assert not pr.takes(**a) or bad in ("contiguous", "counter_dtype", "counter_shape")


def test_the_wrapper_s_plain_version_counts_as_the_kernel_does():
    a = wrapper_args()
    evals, fused = (torch.zeros(1, dtype=torch.int64) for _ in range(2))
    got = pr.pets_rollout_cost(**a, evals=evals, fused=fused)
    assert evals.tolist() == fused.tolist() == [K * P * (T - 1)]
    want = pets_pe.states_cost(pets_pe.particle_states(
        a["state"].expand(K, -1), a["controls"], a["dt"], a["params"], a["normals"]),
        a["ref_xy"], a["cp"])
    assert got.shape == (E, K * P // E)
    assert torch.equal(got, want) and "model.pe_evals" not in profiling.counters()


# --- the source -------------------------------------------------------------------------------

def entry_signature(src):
    """The entry point's parameters as SIGNATURE spells them, read from its
    definition: p a pointer, i an int."""
    params = re.search(r"int pets_rollout_cost\(([^)]*)\)\s*\{", src).group(1)
    return "pets_rollout_cost:" + "".join("p" if "*" in p else "i" for p in params.split(","))


def test_the_signature_and_the_constants_are_the_source_s():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert tuple(int(consts[n]) for n in ("kThreads", "kRows", "kChunk", "kMaxRef")) == (
        pr.THREADS, pr.ROWS, pr.CHUNK, pr.MAX_REF)
    h, n_hidden = int(consts["kH"]), int(consts["kHidden"])
    assert ((int(consts["kIn"]), h),) + ((h, h),) * n_hidden + ((h, int(consts["kHead"])),) == (
        pr.LAYERS)
    assert tuple(int(consts[n]) for n in ("kS", "kU", "kOut", "kMembers", "kParticles")) == (
        pr.NUM_STATES, pr.NUM_CONTROLS, pr.OUT, pr.MEMBERS, pr.PARTICLES)
    assert entry_signature(src) == pr.SIGNATURE
    assert pr.SIGNATURE in src.replace('" "', "").replace('"', "")


def stub_library(signature=pr.SIGNATURE, rows=pr.ROWS):
    """A stand-in of the loaded library's functions, for _bind."""
    def fn(value):
        return lambda *a: value
    return types.SimpleNamespace(
        pets_rollout_signature=fn(signature.encode()), pets_rollout_cost=fn(0),
        pets_rollout_threads=fn(pr.THREADS), pets_rollout_rows=fn(rows),
        pets_rollout_chunk=fn(pr.CHUNK), pets_rollout_max_ref=fn(pr.MAX_REF),
        pets_rollout_error_string=fn(b""))


@pytest.mark.parametrize("lib, ok", [(stub_library(), True),
                                     (stub_library(signature=pr.SIGNATURE + "i"), False),
                                     (stub_library(rows=128), False)],
                         ids=["same", "signature", "rows"])
def test_the_binding_holds_the_library_to_the_wrapper(lib, ok):
    if ok:
        assert pr._bind(lib) is lib and lib._pets_rollout_bound
        assert lib.pets_rollout_cost.argtypes[-1] is ctypes.c_void_p
        assert lib.pets_rollout_cost.argtypes[-2] is ctypes.c_int
    else:
        with pytest.raises(RuntimeError):
            pr._bind(lib)


def test_the_arithmetic_is_float32_precise_on_the_cuda_cores():
    """No fast-math flag, no intrinsic of lower precision, no tensor-core or
    TF32 instruction, no double; the swish, softplus and transcendental
    functions PyTorch's CUDA ops use."""
    src = re.sub(r"//[^\n]*", "", SOURCE.read_text())
    assert not re.search(r"__(expf|exp10f|logf|log2f|sinf|cosf|tanf|sincosf|powf|fdividef|"
                         r"frcp_\w+|log1pf)\b", src)
    assert not re.search(r"\.approx|\.ftz|\bwmma\b|\bmma\b|wgmma|tf32|\bdouble\b|__half|bfloat",
                         src, re.IGNORECASE)
    for fn in ("expf(", "log1pf(", "sinf(", "cosf(", "fmaf("):
        assert fn in src
    assert "x / (1.0f + expf(-x))" in src and "x > 20.0f ? x : log1pf(expf(x))" in src
    assert not any("fast_math" in f or "fast-math" in f or "ftz" in f for f in build.NVCC_FLAGS)


# --- the kernel's code on the CPU, through a stand-in of the CUDA runtime ---------------------

STANDIN = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>
using std::min;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct Index { unsigned x = 0; };
inline Index threadIdx, blockIdx;
inline float4* g_dyn = nullptr;
// a block's lanes: one fiber each, run in turn on one thread; __syncthreads
// hands over to the next lane, so lane 0 goes on once every lane got there
inline std::vector<ucontext_t> g_lanes;
inline ucontext_t g_main;
inline std::function<void()> g_body;
inline void lane_entry() { g_body(); }
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define PETS_COPY16(dst, src) std::memcpy((dst), (src), 16)
#define PETS_COPY8(dst, src) std::memcpy((dst), (src), 8)
#define PETS_COPY_COMMIT()
#define PETS_COPY_WAIT()
inline void __syncthreads() {
  const unsigned me = threadIdx.x, next = (me + 1) % g_lanes.size();
  threadIdx.x = next;
  swapcontext(&g_lanes[me], &g_lanes[next]);
  threadIdx.x = me;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long o = *p; *p += v; return o;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "stand-in"; }
template <class Kernel, class A>
void standin_launch(Kernel kernel, unsigned blocks, int threads, size_t smem, A a) {
  std::vector<float4> dyn(smem / sizeof(float4) + 1);
  g_dyn = dyn.data();
  std::vector<char> stacks(static_cast<size_t>(threads) << 16);
  g_body = [&] { kernel(a); };
  g_lanes.assign(threads, ucontext_t{});
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    for (int t = 0; t < threads; ++t) {
      getcontext(&g_lanes[t]);
      g_lanes[t].uc_stack.ss_sp = stacks.data() + (static_cast<size_t>(t) << 16);
      g_lanes[t].uc_stack.ss_size = size_t{1} << 16;
      g_lanes[t].uc_link = &g_main;
      makecontext(&g_lanes[t], lane_entry, 0);
    }
    for (int t = 0; t < threads; ++t) {   // lane t comes back here when its body ends
      threadIdx.x = t;
      swapcontext(&g_main, &g_lanes[t]);
    }
  }
}
"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """csrc/pets_rollout.cu built with g++ against STANDIN, bound as the
    card's library is."""
    out = tmp_path_factory.mktemp("pets_rollout")
    src = SOURCE.read_text().replace("#include <cuda_runtime.h>", '#include "standin.h"')
    src = src.replace("extern __shared__ float4 s_mem[];", "float4* s_mem = g_dyn;")
    src, n = re.subn(r"pets_rollout_kernel<<<(\w+), (\w+), (\w+), .*?>>>\(a\);",
                     r"standin_launch(pets_rollout_kernel, \1, \2, \3, a);", src)
    assert n == 1
    (out / "standin.h").write_text(STANDIN)
    (out / "pets_rollout.cpp").write_text(src)
    lib = out / "libpets_rollout_standin.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-march=native", "-ffp-contract=off", "-shared",
                    "-fPIC", "-w", "-o", str(lib), str(out / "pets_rollout.cpp")],
                   check=True, capture_output=True)
    return pr._bind(ctypes.CDLL(str(lib)))


def standin_costs(lib, a, pad=0, evals=None, fused=None, k=None):
    """The stand-in launch's costs ((E, K·P/E + pad) floats, NaN where
    nothing was written) and its return code."""
    kk = a["controls"].shape[1]
    k = kk if k is None else k
    costs = torch.full((E, kk * P // E + pad), float("nan"))
    ptrs = [t.data_ptr() for _, t, _ in pr._operands(**a)]
    err = lib.pets_rollout_cost(*ptrs, costs.data_ptr(),
                                None if evals is None else evals.data_ptr(),
                                None if fused is None else fused.data_ptr(),
                                k, a["controls"].shape[0], a["ref_xy"].shape[0], None)
    return costs, err


@pytest.mark.parametrize("k, t", [(3, 30), (45, 8), (41, 4), (7, 1), (2, 2), (9, 15)])
def test_the_kernel_s_code_computes_the_plain_version_s_costs(standin, k, t):
    """Ragged K (K·P/E rows of a member past a 160-row tile's edge at K=41
    and 45; a block's rows past the member's store nothing), T down to 1 (no
    step), R = T window points; the counters K·P·(T-1)."""
    a = wrapper_args(k, t, seed=k + t)
    evals, fused = (torch.zeros(1, dtype=torch.int64) for _ in range(2))
    costs, err = standin_costs(standin, a, evals=evals, fused=fused)
    want = pr.pets_rollout_cost_reference(**a)
    assert err == 0
    np.testing.assert_allclose(costs.numpy(), want.numpy(), rtol=COST_RTOL, atol=0)
    assert evals.tolist() == fused.tolist() == [k * P * (t - 1)]


def test_rows_past_the_member_s_end_store_nothing(standin):
    """K=3: 12 rows a member, one block each; the costs of one member's rows
    land in its own row of the (E, K·P/E) layout and nowhere else."""
    a = wrapper_args(3, 3)
    flat = torch.full((E * 12 + 16,), float("nan"))
    ptrs = [t.data_ptr() for _, t, _ in pr._operands(**a)]
    assert standin.pets_rollout_cost(*ptrs, flat.data_ptr(), None, None, 3, 2, 3, None) == 0
    assert torch.isfinite(flat[:E * 12]).all() and torch.isnan(flat[E * 12:]).all()


@pytest.mark.parametrize("bad", ["no_samples", "long_window", "off_16_bytes"])
def test_the_entry_point_refuses_a_launch_it_cannot_make(standin, bad):
    a = wrapper_args(4, 4)
    if bad == "long_window":
        a["ref_xy"] = torch.zeros((pr.MAX_REF + 1, 2))
    if bad == "off_16_bytes":
        a["normals"] = torch.empty(a["normals"].numel() + 1)[1:].view_as(a["normals"])
    costs, err = standin_costs(standin, a, k=0 if bad == "no_samples" else None)
    assert err == 1 and torch.isnan(costs).all()


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_an_update_through_the_kernel_s_code(standin, seed, monkeypatch):
    """mppi_step with the dispatch on the kernel's code: u_opt within U_GAP
    of the box of the plain update, the counters K·P·(T-1) each."""
    k, t = 24, 8
    cfg, sp, cp, path, state, ctrl = problem(k, t, seed)
    dt = torch.tensor(0.1)
    want = mppi_step(cfg, ctrl, state, path, dt, sp, cp, lean=True)[1].u_opt
    profiling.reset()

    def launch(state, controls, normals, dt, params, ref_xy, cp, evals=None, fused=None):
        a = dict(state=state, controls=controls, normals=normals, dt=dt, params=params,
                 ref_xy=ref_xy, cp=cp)
        costs, err = standin_costs(standin, a, evals=evals, fused=fused)
        assert err == 0
        return costs

    monkeypatch.setattr(pets_pe, "_on_card", lambda t: True)
    monkeypatch.setattr(pr, "pets_rollout_cost", launch)
    got = mppi_step(cfg, ctrl, state, path, dt, sp, cp, lean=True)[1].u_opt
    assert ((got - want).abs() / BOX).max().item() < U_GAP
    assert profiling.counters() == {"model.pe_evals": k * P * (t - 1),
                                    "model.pe_fused": k * P * (t - 1)}


# --- the counters and the reader --------------------------------------------------------------

def test_pe_fused_reads_the_share_the_kernel_took(monkeypatch):
    read = harness.reader("pe_fused.pe")
    assert read({}) is None
    profiling.count_on_device(pr.COUNTERS, torch.tensor([40]))
    assert read({}) is None                 # the op-by-op rollout: no fused counter
    profiling.count_on_device(pr.FUSED, torch.tensor([10]))
    assert read({}) == 25.0
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None
    (entry,) = [m for m in harness.load_benchmark()["per_layer"] if m["name"] == "pe_fused.pe"]
    assert entry == {"name": "pe_fused.pe", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "eager update",
                     "moves": "propagations_per_s", "workloads": ["pets_pe.update"]}


@pytest.mark.parametrize("on_card", [False, True])
def test_pe_fused_on_a_small_run(on_card, monkeypatch):
    """The cell through harness.run at K=16, T=6 on the CPU: the plain
    version reads no share; with the dispatch told it is on the card the
    wrapper's plain version takes every update and the share reads 100."""
    if on_card:
        monkeypatch.setattr(pets_pe, "_on_card", lambda t: True)
    line, _ = harness.run("pets_pe.update", 2**31 + 31, 0.0, True, torch.device("cpu"), 0.0,
                          config_overrides={"num_samples": K, "horizon": T},
                          traffic_overrides={"warmup_units": 2, "trace_units": 3,
                                             "check_sample": 2})
    assert line["correct"] and line["failed"] == 0
    want = {"pe_evals.pe": {"value": K * P * (T - 1), "unit": "evals"}}
    if on_card:
        want["pe_fused.pe"] = {"value": 100.0, "unit": "%"}
    assert line["metrics"] == want
