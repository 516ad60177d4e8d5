"""The refine stage's fused Gauss-Newton kernel (kernels/gauss_newton.py,
csrc/gauss_newton.cu) on the CPU: which calls ``gauss_newton_refine`` hands
to it, that the CPU keeps the op-by-op steps bit for bit, the wrapper's
checks, the shared-memory plan, the kernel's name against the benchmark's
trace reader, the counters and the reader ``refine_fused.gn``. The kernel
itself runs only on the card: chip_smoke.py phase 36 holds it against the
op-by-op stage there."""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from benchmark import harness, trace
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS, full_body_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.diff import gradients
from ccv_mppi_path_tracker_tpu_torch.kernels import gauss_newton as gn
from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "ccv_mppi_path_tracker_tpu_torch" / "csrc"


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def inputs(horizon=10, seed=3, preset="full_body"):
    """(cfg, u, state, ref, dt, sp, cp, mp) of one refine call on the CPU,
    float32, a control sequence drawn inside the box."""
    if preset == "full_body":
        cfg, sp, cp, course = full_body_launch(num_samples=64, horizon=horizon, device="cpu")
        state = torch.tensor([0.05, float(course[0, 1]) + 0.1, 0.1, 0.02, -0.03])
        mp = default_params(device="cpu")
    else:
        cfg, sp, cp, course = PRESETS[preset](num_samples=64, horizon=horizon, device="cpu")
        state = torch.tensor([0.05, float(course[0, 1]) + 0.1, 0.1])
        mp = None
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    dt = torch.tensor(0.1)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, horizon)
    g = torch.Generator().manual_seed(seed)
    u = 0.3 * torch.randn((horizon - 1, sp.u_min.shape[0]), generator=g)
    u[:, 0] += 1.0
    return cfg, torch.clamp(u, sp.u_min, sp.u_max), state, ref, dt, sp, cp, mp


def wrapper_args(horizon=10):
    cfg, u, state, ref, dt, sp, cp, mp = inputs(horizon)
    return dict(u=u, state=state, ref_xy=ref.xy.contiguous(), ref_yaw=ref.yaw.contiguous(),
                dt=dt, u_min=sp.u_min, u_max=sp.u_max, cp=cp, mp=mp)


@pytest.fixture
def on_the_card(monkeypatch):
    """Dispatch as if the tensors were on the card, with the launcher
    replaced by one that records its call: what reaches it would launch."""
    launched = []

    def launch(*args, **kwargs):
        launched.append((args, kwargs))
        return args[0]

    monkeypatch.setattr(gradients, "_on_card", lambda t: True)
    monkeypatch.setattr(gn, "gauss_newton_steps", launch)
    return launched


def refuse(*args, **kwargs):
    raise AssertionError("the fused kernel was launched")


# --- the dispatch -----------------------------------------------------------------------------

def test_the_cpu_runs_the_op_by_op_steps(monkeypatch):
    monkeypatch.setattr(gn, "gauss_newton_steps", refuse)
    cfg, *rest = inputs()
    assert gradients._fused_inputs(cfg, *rest, 3) is None
    gradients.gauss_newton_refine(cfg, *rest)


def test_a_full_body_float32_call_on_the_card_goes_to_the_kernel(on_the_card):
    """The operands reach the launcher once, contiguous, with the counters'
    groups of utils/profiling.py; a number dt becomes a tensor."""
    cfg, u, state, ref, dt, sp, cp, mp = inputs()
    ref = RefWindow(ref.xy.T.contiguous().T, ref.yaw)       # a strided window
    assert not ref.xy.is_contiguous()
    out = gradients.gauss_newton_refine(cfg, u, state, ref, 0.1, sp, cp, mp, num_steps=2,
                                        damping=5e-3)
    (args, kwargs), = on_the_card
    assert out is u and args[-2:] == (2, 5e-3)
    assert all(t.is_contiguous() for t in args[:7]) and torch.equal(args[2], ref.xy)
    assert args[4].dtype == torch.float32 and args[4].item() == pytest.approx(0.1)
    cpu = torch.device("cpu")
    assert kwargs["counts"] is profiling._DEVICE_COUNTERS[(gn.COUNTERS, cpu)]
    assert kwargs["fused"] is profiling._DEVICE_COUNTERS[(gn.FUSED, cpu)]


def test_default_body_parameters_go_to_the_kernel(on_the_card):
    cfg, u, state, ref, dt, sp, cp, _ = inputs()
    gradients.gauss_newton_refine(cfg, u, state, ref, dt, sp, cp, None)
    (args, _), = on_the_card
    assert torch.equal(args[8].inertia, default_params(device="cpu").inertia)


@pytest.mark.parametrize("case", ["grad", "grad_param", "float64", "unicycle", "horizon",
                                  "no_steps", "param_shape"])
def test_the_op_by_op_steps_run_where_the_kernel_does_not_take_the_call(case, on_the_card,
                                                                        monkeypatch):
    """With grad, a float64 sequence, another model, a horizon past the
    shared-memory plan, no step, or a parameter of another shape, the call
    runs op by op even on the card."""
    monkeypatch.setattr(gn, "gauss_newton_steps", refuse)
    preset = "diff_drive" if case == "unicycle" else "full_body"
    cfg, u, state, ref, dt, sp, cp, mp = inputs(40 if case == "horizon" else 10,
                                                preset=preset)
    steps = 0 if case == "no_steps" else 1
    if case == "grad":
        u = u.clone().requires_grad_(True)
    if case == "grad_param":
        cp = dataclasses.replace(cp, path_weight=cp.path_weight.clone().requires_grad_(True))
    if case == "float64":
        u = u.double()
    if case == "param_shape":
        cp = dataclasses.replace(cp, v_weight=cp.v_weight.reshape(1).expand(2))
    assert gradients._fused_inputs(cfg, u, state, ref, dt, sp, cp, mp, steps) is None
    if case not in ("float64", "param_shape"):
        with torch.enable_grad():
            gradients.gauss_newton_refine(cfg, u, state, ref, dt, sp, cp, mp, num_steps=steps)


def test_no_kernel_under_a_torch_func_transform(on_the_card):
    cfg, u, state, ref, dt, sp, cp, mp = inputs()
    seen = []
    torch.func.vmap(lambda x: seen.append(
        gradients._fused_inputs(cfg, u, state, ref, dt, sp, cp, mp, 3)) or x)(torch.ones(2))
    assert seen == [None]
    assert gradients._fused_inputs(cfg, u, state, ref, dt, sp, cp, mp, 3) is not None


def test_on_the_cpu_the_refinement_is_bit_for_bit_the_op_by_op_one():
    """Output and counters of gauss_newton_refine equal those of
    gauss_newton_refine_plain; the wrapper's plain version gives the same
    sequence and adds [3, accepted] and 3 fused steps to the groups it gets."""
    cfg, *rest = inputs(horizon=12, seed=5)
    got = gradients.gauss_newton_refine(cfg, *rest)
    counted = profiling.counters()
    profiling.reset()
    want = gradients.gauss_newton_refine_plain(cfg, *rest)
    assert torch.equal(got, want) and profiling.counters() == counted
    assert counted["refine.lm_steps"] == 3 and "refine.fused_steps" not in counted
    counts = torch.zeros(2, dtype=torch.int64)
    fused = torch.zeros(1, dtype=torch.int64)
    a = wrapper_args(12)
    a.update(u=rest[0])
    a["state"], a["dt"] = rest[1], rest[3]
    before = gn.gauss_newton_steps.launches
    out = gn.gauss_newton_steps(**a, num_steps=3, damping=1e-3, counts=counts, fused=fused)
    assert gn.gauss_newton_steps.launches == before
    assert torch.equal(out, want)
    assert counts.tolist() == [3, counted.get("refine.lm_accepted", 0)] and fused.tolist() == [3]


# --- the wrapper's checks ---------------------------------------------------------------------

def test_the_wrapper_takes_the_flagship_shapes():
    a = wrapper_args(30)
    assert gn.takes(**a, num_steps=3)
    gn._check_inputs(**a, num_steps=3, counts=None, fused=None)


@pytest.mark.parametrize("bad", ["dtype", "shape_u", "shape_state", "shape_box", "device",
                                 "contiguous", "counts", "plan", "steps", "number"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a = wrapper_args()
    counts = None
    steps = 3
    if bad == "dtype":
        a["u"] = a["u"].double()
    if bad == "shape_u":
        a["u"] = a["u"][:, :3].contiguous()
    if bad == "shape_state":
        a["state"] = a["state"][:3]
    if bad == "shape_box":
        a["u_min"] = a["u_min"][None]
    if bad == "device":
        a["ref_yaw"] = torch.empty(a["ref_yaw"].shape, device="meta")
    if bad == "contiguous":
        a["ref_xy"] = a["ref_xy"].T.contiguous().T
    if bad == "counts":
        counts = torch.zeros(2, dtype=torch.int32)
    if bad == "plan":
        a["u"] = torch.zeros((99, 5))
    if bad == "steps":
        steps = 0
    if bad == "number":
        a["dt"] = 0.1
    with pytest.raises((TypeError, ValueError)):
        gn.gauss_newton_steps(**a, num_steps=steps, damping=1e-3, counts=counts)


# --- the shared-memory plan and the source --------------------------------------------------

def test_the_plan_fits_the_flagship_and_refuses_long_horizons():
    bytes30 = gn.smem_bytes(30, 5, 30)
    assert 0 < bytes30 < 232_448 and gn.fits(30, 5, 30)
    assert gn.fits(33, 5, 33) and not gn.fits(34, 5, 34)
    assert not gn.fits(100, 5, 100) and gn.smem_bytes(100, 5, 100) > 232_448
    assert gn.smem_bytes(30, 3, 30) == -1 and not gn.fits(30, 3, 30)
    assert gn.smem_bytes(2, 5, 2) == -1


def test_the_plan_constants_are_the_source_s():
    src = (CSRC / "gauss_newton.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == gn.THREADS and int(consts["kMaxSmem"]) == gn.MAX_SMEM
    assert int(consts["kTile"]) == gn.TILE
    assert int(consts["kU"]) == gn.NUM_CONTROLS
    per_time = re.search(r"enum \{\n(.*?)TV_COUNT", src, re.S).group(1)
    assert len(re.findall(r"\bTV_\w+", per_time)) == gn.PER_TIME
    assert gn.SIGNATURE in src.replace('" "', "").replace('"', "")


def global_names(src):
    """The name of each ``__global__`` function in a CUDA source."""
    names = []
    for m in re.finditer(r"__global__", src):
        head = src[m.end():src.index("{", m.end())]
        bounds = head.find("__launch_bounds__")
        if bounds >= 0:   # drop the attribute's balanced parentheses
            depth, i = 0, head.index("(", bounds)
            while True:
                depth += {"(": 1, ")": -1}.get(head[i], 0)
                i += 1
                if depth == 0:
                    break
            head = head[:bounds] + head[i:]
        names.append(re.search(r"(\w+)\s*\(", head).group(1))
    return names


def test_no_entry_point_carries_the_trace_reader_s_kernel_name():
    """benchmark/trace.py matches the fused kernel by substring and
    work_refine splits a unit at its last match: a refine kernel so named
    would zero refine_device_us.gn."""
    names = [name for path in sorted(CSRC.glob("*.cu")) for name in global_names(path.read_text())]
    assert "gauss_newton_kernel" in names and "rollout_cost_kernel" in names
    assert [n for n in names if trace.KERNEL_NAME in n] == ["rollout_cost_kernel"]


# --- the counters and the reader ---------------------------------------------------------------

def test_a_device_group_is_made_once_and_shared_with_count_on_device():
    group = profiling.device_group(gn.FUSED, "cpu")
    assert group.dtype == torch.int64 and group.tolist() == [0]
    assert profiling.device_group(gn.FUSED, torch.device("cpu")) is group
    profiling.count_on_device(gn.FUSED, torch.tensor([4]))
    assert group.tolist() == [4] and profiling.counters()["refine.fused_steps"] == 4
    profiling.reset()
    assert group.tolist() == [0]


def test_a_device_group_is_not_first_made_under_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    made = dict(profiling._DEVICE_COUNTERS)
    assert profiling.device_group(("refine.x",), torch.device("cuda", 0)) is None
    assert profiling._DEVICE_COUNTERS == made


def test_refine_fused_reads_the_share_the_kernel_took(monkeypatch):
    read = harness.reader("refine_fused.gn")
    assert read({}) is None
    profiling.count_on_device(gn.COUNTERS, torch.tensor([6, 1]))
    assert read({}) is None                 # the op-by-op stage: no fused counter
    profiling.count_on_device(gn.FUSED, torch.tensor([3]))
    assert read({}) == 50.0
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None
    (entry,) = [m for m in harness.load_benchmark()["per_layer"] if m["name"] == "refine_fused.gn"]
    assert entry == {"name": "refine_fused.gn", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "refine stage",
                     "moves": "propagations_per_s", "workloads": ["full_body_gn.update"]}

