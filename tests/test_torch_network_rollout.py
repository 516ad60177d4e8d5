"""The eager update's fused network rollout (kernels/network_rollout.py,
csrc/network_rollout.cu) on the CPU: which calls models/autorally_nn.py
``rollout_cost`` hands to it, that the CPU keeps ``cost(rollout(...))`` and
the eager update bit for bit as they were, the wrapper's checks, its binding
against the source's entry point, the kernel's arithmetic flags, the
counters and the reader ``nn_fused.nn``.

The kernel's own code is compiled here with g++ against a small stand-in of
the CUDA runtime (a thread a lane, a ``std::barrier`` a block for
``__syncthreads``, the ``__f*_rn`` operations as plain float operations with
contraction off) and held to the plain version. Its costs differ from the
plain version's only where the CPU's matrix products sum in another order
than the kernel's ascending chains: 2.6e-7 relative at most over these
cases, so the costs are held to 1e-6. The kernel itself runs only on the
card: chip_smoke.py phase 38 holds it to the plain version there."""

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
from ccv_mppi_path_tracker_tpu_torch.core.presets import autorally_nn_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, RefWindow
from ccv_mppi_path_tracker_tpu_torch.kernels import build
from ccv_mppi_path_tracker_tpu_torch.kernels import network_rollout as nr
from ccv_mppi_path_tracker_tpu_torch.models import autorally_nn, get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import model_rollout
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals, sample_controls
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import softmax_weights, weighted_update
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, mppi_step
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import _sigma_suggest
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "ccv_mppi_path_tracker_tpu_torch" / "csrc" / "network_rollout.cu"
K, T = 64, 8
COST_RTOL = 1e-6        # see the module docstring
U_GAP = 1e-6            # of the box: the update through the kernel's code
BOX = 2.0


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def problem(k=K, t=T, seed=3, dtype=torch.float32):
    """(cfg, sp, cp, path, state, ctrl) of the network model at K=k, T=t
    on the CPU: the cell's course at a seeded offset, a seeded pose with a
    seeded roll and velocities, a seeded warm start inside the box."""
    with open(ROOT / "benchmark" / "configs" / "autorally_nn-K102400-T30.json") as f:
        conf = json.load(f)
    rng = harness.inputs_rng(seed)
    course = harness.course_for(conf, {"course_offset_m": 1.0}, rng)
    state = torch.from_numpy(harness.start_pose(course, 7, rng, [0.05] * 3)).to(dtype)
    g = torch.Generator().manual_seed(seed)
    state[3:] = (0.3 * torch.randn(4, generator=g)).to(dtype)
    cfg, sp, cp, _ = autorally_nn_launch(num_samples=k, horizon=t, dtype=dtype, device="cpu")
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device="cpu")
    u_prev = torch.clamp(0.4 * torch.randn((t - 1, 2), generator=g), -1.0, 1.0).to(dtype)
    return cfg, sp, cp, path, state, ControllerState(u_prev, seed, 2)


def hook_args(k=K, t=T, seed=3, dtype=torch.float32):
    """(state0, controls, dt, params, ref, cp): rollout_cost's arguments as
    the eager arm passes them."""
    cfg, sp, cp, path, state, ctrl = problem(k, t, seed, dtype)
    dt = torch.tensor(0.1, dtype=dtype)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, t)
    noise = draw_standard_normals(**ctrl.rng(), shape=(t - 1, k, 2), dtype=dtype, device="cpu")
    u = sample_controls(ctrl.u_prev, sp, k, noise=noise) if t > 1 else noise
    return state.expand(k, -1), u, dt, autorally_nn.default_params("cpu", dtype), ref, cp


def wrapper_args(k=K, t=T, seed=3):
    state0, u, dt, params, ref, cp = hook_args(k, t, seed)
    return dict(state=state0[0], controls=u, dt=dt, params=params, ref_xy=ref.xy.contiguous(),
                cp=cp)


@pytest.fixture
def on_the_card(monkeypatch):
    """Dispatch as if the tensors were on the card, with the launcher
    replaced by one that records its call and returns the plain version's
    costs: what reaches it would launch."""
    launched = []

    def launch(*args, **kwargs):
        launched.append((args, kwargs))
        return nr.network_rollout_cost_reference(*args)

    monkeypatch.setattr(autorally_nn, "_on_card", lambda t: True)
    monkeypatch.setattr(nr, "network_rollout_cost", launch)
    return launched


def refuse(*args, **kwargs):
    raise AssertionError("the network rollout kernel was launched")


# --- the dispatch ---------------------------------------------------------------------------

def test_the_cpu_runs_the_plain_version(monkeypatch):
    monkeypatch.setattr(nr, "network_rollout_cost", refuse)
    args = hook_args()
    assert autorally_nn._fused_operands(*args) is None
    assert torch.equal(autorally_nn.rollout_cost(*args),
                       autorally_nn.cost(autorally_nn.rollout(*args[:4]), args[1], {}, *args[4:]))


def test_a_float32_call_on_the_card_goes_to_the_kernel(on_the_card):
    """The operands reach the launcher once, contiguous, the start state as
    the one state it expands, a number dt made a tensor, with the counters'
    groups of utils/profiling.py."""
    state0, u, dt, params, ref, cp = hook_args()
    strided = u.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    ref = RefWindow(ref.xy.T.contiguous().T, ref.yaw)
    costs = autorally_nn.rollout_cost(state0, strided, 0.1, params, ref, cp)
    (args, kwargs), = on_the_card
    state, controls, dt_t, p, xy, c = args
    assert torch.equal(state, state0[0]) and state.shape == (7,)
    assert controls.is_contiguous() and torch.equal(controls, u)
    assert xy.is_contiguous() and torch.equal(xy, ref.xy)
    assert dt_t.dtype == torch.float32 and dt_t.item() == pytest.approx(0.1)
    assert all(torch.equal(getattr(p, n), getattr(params, n)) for n in nr.WEIGHT_NAMES)
    assert c.v_ref is cp.v_ref or torch.equal(c.v_ref, cp.v_ref)
    cpu = torch.device("cpu")
    assert kwargs["evals"] is profiling._DEVICE_COUNTERS[(nr.COUNTERS, cpu)]
    assert kwargs["fused"] is profiling._DEVICE_COUNTERS[(nr.FUSED, cpu)]
    assert costs.shape == (K,)


def test_default_weights_go_to_the_kernel(on_the_card):
    state0, u, dt, _, ref, cp = hook_args()
    autorally_nn.rollout_cost(state0, u, dt, None, ref, cp)
    (args, _), = on_the_card
    assert args[3].w2 is autorally_nn.default_params("cpu").w2


@pytest.mark.parametrize("case", ["float64", "grad_controls", "grad_weight", "grad_cost",
                                  "states", "one_sample_of_many", "weight_shape",
                                  "long_window", "number_weight"])
def test_the_plain_version_runs_where_the_kernel_does_not_take_the_call(case, on_the_card,
                                                                        monkeypatch):
    """float64, grad on a control, a weight or a cost weight, K distinct
    start states, a start state of another count, weights of another shape,
    a window past MAX_REF points or a cost weight that is a number: the
    call runs op by op even on the card, as cost(rollout(...))."""
    monkeypatch.setattr(nr, "network_rollout_cost", refuse)
    state0, u, dt, params, ref, cp = hook_args(dtype=torch.float64 if case == "float64"
                                                 else torch.float32)
    if case == "grad_controls":
        u = u.clone().requires_grad_(True)
    if case == "grad_weight":
        params = dataclasses.replace(params, w2=params.w2.clone().requires_grad_(True))
    if case == "grad_cost":
        cp = dataclasses.replace(cp, path_weight=cp.path_weight.clone().requires_grad_(True))
    if case == "states":
        state0 = state0.contiguous()
    if case == "one_sample_of_many":
        state0 = state0[:1]
    if case == "weight_shape":       # 16 units in the first layer
        params = dataclasses.replace(params, w1=params.w1[:16], b1=params.b1[:16],
                                     w2=params.w2[:, :16])
    if case == "long_window":
        ref = RefWindow(torch.cat([ref.xy] * (nr.MAX_REF // T + 1)), ref.yaw)
    if case == "number_weight":
        cp = dataclasses.replace(cp, v_weight=1.0)
    assert autorally_nn._fused_operands(state0, u, dt, params, ref, cp) is None
    if case not in ("one_sample_of_many",):
        with torch.enable_grad():
            got = autorally_nn.rollout_cost(state0, u, dt, params, ref, cp)
            want = autorally_nn.cost(autorally_nn.rollout(state0, u, dt, params), u, {}, ref,
                                     cp)
        assert torch.equal(got, want)


def test_no_kernel_under_a_torch_func_transform(on_the_card):
    state0, u, dt, params, ref, cp = hook_args()
    seen = []
    torch.func.vmap(lambda x: seen.append(
        autorally_nn._fused_operands(state0, u, dt, params, ref, cp)) or x)(torch.ones(2))
    assert seen == [None]
    assert autorally_nn._fused_operands(state0, u, dt, params, ref, cp) is not None


def test_a_fleet_batch_takes_the_plain_version(monkeypatch):
    """The fleet's eager tick vmaps mppi_step: each robot's rollout and
    cost run op by op, the same with the dispatch told it is on the card."""
    cfg, sp, cp, path, state, ctrl = problem()
    fleet = ControllerState(torch.stack([ctrl.u_prev, -ctrl.u_prev]), 3, 0)
    states = torch.stack([state, state + 0.01])
    step = build_fleet_step(cfg, use_kernel=False)
    want = step(fleet, states, path, torch.tensor(0.1), sp, cp)[1].u_opt
    monkeypatch.setattr(autorally_nn, "_on_card", lambda t: True)
    monkeypatch.setattr(nr, "network_rollout_cost", refuse)
    got = step(fleet, states, path, torch.tensor(0.1), sp, cp)[1].u_opt
    assert torch.equal(got, want)


@pytest.mark.parametrize("lean", [True, False])
def test_the_eager_arm_takes_the_hook_only_where_no_state_is_needed(lean, on_the_card):
    cfg, sp, cp, path, state, ctrl = problem()
    mppi_step(cfg, ctrl, state, path, torch.tensor(0.1), sp, cp, lean=lean)
    assert len(on_the_card) == 1
    if not lean:
        _, res = mppi_step(cfg, ctrl, state, path, torch.tensor(0.1), sp, cp,
                           debug_candidates=4)
        assert len(on_the_card) == 1 and res.stats["candidates"].shape == (4, T, 2)


# --- bit for bit on the CPU -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_on_the_cpu_the_hook_is_cost_of_rollout(seed, dtype):
    state0, u, dt, params, ref, cp = hook_args(seed=seed, dtype=dtype)
    got = autorally_nn.rollout_cost(state0, u, dt, params, ref, cp)
    counted = profiling.counters()
    want = autorally_nn.cost(autorally_nn.rollout(state0, u, dt, params), u, {}, ref, cp)
    assert torch.equal(got, want)
    assert counted == {"model.nn_evals": K * (T - 1)}


def parent_eager(cfg, ctrl, state, path, dt, sp, cp, elite_frac=None, adapt_sigma=False):
    """``mppi_step``'s eager arm for the network model as it was before the
    rollout_cost hook, frozen: (u_opt, stats, opt_states)."""
    model = get_model(cfg.model)
    params = model.default_params(device=state.device, dtype=state.dtype)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    tm1, u_dim = ctrl.u_prev.shape
    noise = draw_standard_normals(**ctrl.rng(), shape=(tm1, cfg.num_samples, u_dim),
                                  dtype=ctrl.u_prev.dtype, device=state.device)
    u = sample_controls(ctrl.u_prev, sp, cfg.num_samples, steer_off=cfg.steer_off, noise=noise)
    states = model_rollout(model, state.expand(cfg.num_samples, -1), u, dt, params)
    costs = trajectory_costs(cfg.model, states, u, {}, ref, cp)
    weights, stats = softmax_weights(costs, sp.lam, elite_frac=elite_frac)
    u_opt = weighted_update(weights, u)
    if adapt_sigma:
        stats["sigma_suggest"] = _sigma_suggest(weighted_update(weights, u * u), u_opt)
    return u_opt, stats, model_rollout(model, state, u_opt, dt, params)


@pytest.mark.parametrize("route", ["cpu", "wrapper"])
@pytest.mark.parametrize("options", [{}, {"elite_frac": 0.1}, {"adapt_sigma": True}],
                         ids=["vanilla", "elite", "adapt_sigma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_eager_update_is_bit_for_bit_the_parent_s(dtype, options, route, monkeypatch):
    """On the CPU (and through the wrapper's plain version, as if on the
    card, where the dtype lets it) u_opt, the stats and the planned path
    equal the parent's eager arm."""
    if route == "wrapper":
        monkeypatch.setattr(autorally_nn, "_on_card", lambda t: True)
    cfg, sp, cp, path, state, ctrl = problem(dtype=dtype)
    dt = torch.tensor(0.1, dtype=dtype)
    want_u, want_stats, want_states = parent_eager(cfg, ctrl, state, path, dt, sp, cp, **options)
    _, res = mppi_step(cfg, ctrl, state, path, dt, sp, cp, **options)
    assert torch.equal(res.u_opt, want_u) and torch.equal(res.opt_states, want_states)
    assert set(want_stats) <= set(res.stats)
    assert all(torch.equal(res.stats[name], want) for name, want in want_stats.items())
    fused = profiling.counters().get("model.nn_fused", 0)
    assert fused == (K * (T - 1) if route == "wrapper" and dtype == torch.float32 else 0)


# --- the wrapper ------------------------------------------------------------------------------

def test_the_wrapper_takes_the_cell_s_shapes():
    meta = dict(device="meta", dtype=torch.float32)
    params = autorally_nn.NNParams(*[torch.empty(s, **meta) for s in nr.weight_shapes()])
    cp = types.SimpleNamespace(**{n: torch.empty((), **meta) for n in nr.COST_NAMES})
    assert nr.takes(torch.empty(7, **meta), torch.empty((29, 102400, 2), **meta),
                    torch.empty((), **meta), params, torch.empty((30, 2), **meta), cp)
    with pytest.raises(ValueError, match="no network rollout kernel for device meta"):
        nr.network_rollout_cost(torch.empty(7, **meta), torch.empty((29, 102400, 2), **meta),
                                torch.empty((), **meta), params,
                                torch.empty((30, 2), **meta), cp)


@pytest.mark.parametrize("bad", ["dtype", "shape_state", "shape_controls", "no_samples",
                                 "weight_shape", "no_window", "long_window", "scalar_shape",
                                 "device", "contiguous", "number_dt", "params", "cp",
                                 "counter_dtype", "counter_shape"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a = wrapper_args()
    evals = None
    if bad == "dtype":
        a["controls"] = a["controls"].double()
    if bad == "shape_state":
        a["state"] = a["state"][:5]
    if bad == "shape_controls":
        a["controls"] = torch.zeros((T - 1, K, 3))
    if bad == "no_samples":
        a["controls"] = torch.zeros((T - 1, 0, 2))
    if bad == "weight_shape":
        a["params"] = dataclasses.replace(a["params"], b3=torch.zeros(5))
    if bad == "no_window":
        a["ref_xy"] = torch.zeros((0, 2))
    if bad == "long_window":
        a["ref_xy"] = torch.zeros((nr.MAX_REF + 1, 2))
    if bad == "scalar_shape":
        a["dt"] = torch.full((2,), 0.1)
    if bad == "device":
        a["dt"] = torch.empty((), device="meta")
    if bad == "contiguous":
        a["controls"] = a["controls"].transpose(0, 1).contiguous().transpose(0, 1)
    if bad == "number_dt":
        a["dt"] = 0.1
    if bad == "params":
        a["params"] = types.SimpleNamespace(w1=a["params"].w1)
    if bad == "cp":
        a["cp"] = types.SimpleNamespace(v_ref=a["cp"].v_ref)
    if bad == "counter_dtype":
        evals = torch.zeros(1, dtype=torch.int32)
    if bad == "counter_shape":
        evals = torch.zeros(2, dtype=torch.int64)
    error = TypeError if bad in ("dtype", "number_dt", "params", "cp") else ValueError
    with pytest.raises(error):
        nr.network_rollout_cost(**a, evals=evals)
    assert not nr.takes(**a) or bad in ("contiguous", "counter_dtype", "counter_shape")


def test_the_wrapper_s_plain_version_counts_as_the_kernel_does():
    a = wrapper_args()
    evals, fused = (torch.zeros(1, dtype=torch.int64) for _ in range(2))
    got = nr.network_rollout_cost(**a, evals=evals, fused=fused)
    assert evals.tolist() == fused.tolist() == [K * (T - 1)]
    want = autorally_nn.cost(autorally_nn.euler_states(a["state"].expand(K, -1), a["controls"],
                                                       a["dt"], a["params"]),
                             a["controls"], {}, RefWindow(a["ref_xy"], a["ref_xy"][:, 0]),
                             a["cp"])
    assert torch.equal(got, want) and "model.nn_evals" not in profiling.counters()


# --- the source -------------------------------------------------------------------------------

def entry_signature(src):
    """The entry point's parameters as SIGNATURE spells them, read from its
    definition: p a pointer, i an int."""
    params = re.search(r"int network_rollout_cost\(([^)]*)\)\s*\{", src).group(1)
    return "network_rollout_cost:" + "".join(
        "p" if "*" in p else "i" for p in params.split(","))


def test_the_signature_and_the_constants_are_the_source_s():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kPer"]), int(consts["kMaxRef"])) == (
        nr.THREADS, nr.SAMPLES_PER_THREAD, nr.MAX_REF)
    assert ((int(consts["kIn"]), int(consts["kH"])), (int(consts["kH"]), int(consts["kH"])),
            (int(consts["kH"]), int(consts["kOut"]))) == nr.LAYERS == autorally_nn.LAYERS
    assert (int(consts["kS"]), int(consts["kU"])) == (nr.NUM_STATES, nr.NUM_CONTROLS)
    assert entry_signature(src) == nr.SIGNATURE
    assert nr.SIGNATURE in src.replace('" "', "").replace('"', "")


def stub_library(signature=nr.SIGNATURE, threads=nr.THREADS):
    """A stand-in of the loaded library's functions, for _bind."""
    def fn(value):
        return lambda *a: value
    return types.SimpleNamespace(
        network_rollout_signature=fn(signature.encode()), network_rollout_cost=fn(0),
        network_rollout_threads=fn(threads),
        network_rollout_samples_per_thread=fn(nr.SAMPLES_PER_THREAD),
        network_rollout_max_ref=fn(nr.MAX_REF), network_rollout_error_string=fn(b""))


@pytest.mark.parametrize("lib, ok", [(stub_library(), True),
                                     (stub_library(signature=nr.SIGNATURE + "i"), False),
                                     (stub_library(threads=64), False)],
                         ids=["same", "signature", "threads"])
def test_the_binding_holds_the_library_to_the_wrapper(lib, ok):
    if ok:
        assert nr._bind(lib) is lib and lib._network_rollout_bound
        assert lib.network_rollout_cost.argtypes[-1] is ctypes.c_void_p
        assert lib.network_rollout_cost.argtypes[-2] is ctypes.c_int
    else:
        with pytest.raises(RuntimeError):
            nr._bind(lib)


def test_the_arithmetic_is_float32_precise_on_the_cuda_cores():
    """No fast-math flag, no intrinsic of lower precision, no tensor-core
    instruction, no double."""
    src = re.sub(r"//[^\n]*", "", SOURCE.read_text())
    assert not re.search(r"__(expf|exp10f|logf|log2f|sinf|cosf|tanf|sincosf|powf|fdividef)\b",
                         src)
    assert not re.search(r"tanh\.approx|\bwmma\b|\bmma\b|wgmma|\bdouble\b|__half|bfloat", src)
    assert "tanhf(" in src and "sinf(" in src and "cosf(" in src
    assert not any("fast_math" in f or "fast-math" in f for f in build.NVCC_FLAGS)


# --- the kernel's code on the CPU, through a stand-in of the CUDA runtime ---------------------

STANDIN = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
using std::min;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct Index { unsigned x = 0; };
inline thread_local Index threadIdx, blockIdx;
inline std::barrier<>* g_bar = nullptr;
inline float4* g_dyn = nullptr;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
inline void __syncthreads() { g_bar->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long o = *p; *p += v; return o;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "stand-in"; }
template <class Kernel, class A>
void standin_launch(Kernel kernel, unsigned blocks, int threads, size_t smem, A a) {
  std::vector<float4> dyn(smem / sizeof(float4) + 1);
  g_dyn = dyn.data();
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> bar(threads);
    g_bar = &bar;
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, t] { threadIdx.x = t; blockIdx.x = b; kernel(a); });
    for (auto& lane : lanes) lane.join();
  }
}
"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """csrc/network_rollout.cu built with g++ against STANDIN, bound as the
    card's library is."""
    out = tmp_path_factory.mktemp("network_rollout")
    src = SOURCE.read_text().replace("#include <cuda_runtime.h>", '#include "standin.h"')
    src = src.replace("extern __shared__ float4 s_ref[];", "float4* s_ref = g_dyn;")
    src, n = re.subn(r"network_rollout_kernel<<<(\w+), (\w+), (\w+), .*?>>>\(a\);",
                     r"standin_launch(network_rollout_kernel, \1, \2, \3, a);", src)
    assert n == 1
    (out / "standin.h").write_text(STANDIN)
    (out / "network_rollout.cpp").write_text(src)
    lib = out / "libnetwork_rollout_standin.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-pthread", "-w", "-o", str(lib), str(out / "network_rollout.cpp")],
                   check=True, capture_output=True)
    return nr._bind(ctypes.CDLL(str(lib)))


def standin_costs(lib, a, pad=0, evals=None, fused=None, k=None):
    """The stand-in launch's costs (K + pad floats, NaN where nothing was
    written) and its return code."""
    k = a["controls"].shape[1] if k is None else k
    costs = torch.full((a["controls"].shape[1] + pad,), float("nan"))
    ptrs = [t.data_ptr() for _, t, _ in nr._operands(**a)]
    err = lib.network_rollout_cost(*ptrs, costs.data_ptr(),
                                   None if evals is None else evals.data_ptr(),
                                   None if fused is None else fused.data_ptr(),
                                   k, a["controls"].shape[0], a["ref_xy"].shape[0], None)
    return costs, err


@pytest.mark.parametrize("k, t", [(64, 8), (100, 15), (129, 30), (1, 3), (65, 2), (200, 1)])
def test_the_kernel_s_code_computes_the_plain_version_s_costs(standin, k, t):
    """Ragged K (a thread past K stores nothing), T down to 1 (no step), R
    = T window points; the counters K·(T-1)."""
    a = wrapper_args(k, t, seed=k + t)
    evals, fused = (torch.zeros(1, dtype=torch.int64) for _ in range(2))
    costs, err = standin_costs(standin, a, pad=64, evals=evals, fused=fused)
    want = nr.network_rollout_cost_reference(**a)
    assert err == 0 and torch.isnan(costs[k:]).all()
    np.testing.assert_allclose(costs[:k].numpy(), want.numpy(), rtol=COST_RTOL, atol=0)
    assert evals.tolist() == fused.tolist() == [k * (t - 1)]


@pytest.mark.parametrize("bad", ["no_samples", "long_window"])
def test_the_entry_point_refuses_a_launch_it_cannot_make(standin, bad):
    a = wrapper_args(8, 4)
    if bad == "long_window":
        a["ref_xy"] = torch.zeros((nr.MAX_REF + 1, 2))
    costs, err = standin_costs(standin, a, k=0 if bad == "no_samples" else None)
    assert err == 1 and torch.isnan(costs).all()


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_an_update_through_the_kernel_s_code(standin, seed, monkeypatch):
    """mppi_step with the dispatch on the kernel's code: u_opt within
    U_GAP of the box of the plain update, the counters K·(T-1) each."""
    k, t = 512, 12
    cfg, sp, cp, path, state, ctrl = problem(k, t, seed)
    dt = torch.tensor(0.1)
    want = mppi_step(cfg, ctrl, state, path, dt, sp, cp, lean=True)[1].u_opt
    profiling.reset()

    def launch(state, controls, dt, params, ref_xy, cp, evals=None, fused=None):
        a = dict(state=state, controls=controls, dt=dt, params=params, ref_xy=ref_xy, cp=cp)
        costs, err = standin_costs(standin, a, evals=evals, fused=fused)
        assert err == 0
        return costs

    monkeypatch.setattr(autorally_nn, "_on_card", lambda t: True)
    monkeypatch.setattr(nr, "network_rollout_cost", launch)
    got = mppi_step(cfg, ctrl, state, path, dt, sp, cp, lean=True)[1].u_opt
    assert ((got - want).abs() / BOX).max().item() < U_GAP
    assert profiling.counters() == {"model.nn_evals": k * (t - 1), "model.nn_fused": k * (t - 1)}


# --- the counters and the reader --------------------------------------------------------------

def test_nn_fused_reads_the_share_the_kernel_took(monkeypatch):
    read = harness.reader("nn_fused.nn")
    assert read({}) is None
    profiling.count_on_device(nr.COUNTERS, torch.tensor([40]))
    assert read({}) is None                 # the op-by-op rollout: no fused counter
    profiling.count_on_device(nr.FUSED, torch.tensor([10]))
    assert read({}) == 25.0
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None
    (entry,) = [m for m in harness.load_benchmark()["per_layer"] if m["name"] == "nn_fused.nn"]
    assert entry == {"name": "nn_fused.nn", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "eager update",
                     "moves": "propagations_per_s", "workloads": ["autorally_nn.update"]}


@pytest.mark.parametrize("on_card", [False, True])
def test_nn_fused_on_a_small_run(on_card, monkeypatch):
    """The cell through harness.run at K=64, T=8 on the CPU: the plain
    version reads no share; with the dispatch told it is on the card the
    wrapper's plain version takes every update and the share reads 100."""
    if on_card:
        monkeypatch.setattr(autorally_nn, "_on_card", lambda t: True)
    line, _ = harness.run("autorally_nn.update", 2**31 + 29, 0.0, True, torch.device("cpu"),
                          0.0, config_overrides={"num_samples": K, "horizon": T},
                          traffic_overrides={"warmup_units": 2, "trace_units": 3,
                                             "check_sample": 2})
    assert line["correct"] and line["failed"] == 0
    want = {"nn_evals.nn": {"value": K * (T - 1), "unit": "evals"}}
    if on_card:
        want["nn_fused.nn"] = {"value": 100.0, "unit": "%"}
    assert line["metrics"] == want
