"""The Gauss-Newton-refined full-body update against its plain reference
(``benchmark/reference_gn.py``), and the refine stage's device counters
(utils/profiling.py), on the CPU at K=256, T=10.

The reference rolls out by the sequential Euler step, takes J by reverse mode
and solves with ``torch.linalg.solve``; the port rolls out in closed form,
takes J by forward mode and solves by Cholesky. The two agree to float32
rounding, which the damped Gauss-Newton step carries into the controls along
the directions the residuals barely see (the damping is 1e-3): at these
sizes the float32 reference lies up to 2.2e-4 of the box from the same
reference in float64. So the port is held to 1e-3 of each channel's box
width. A stage cut short, or the reference in bfloat16, moves the controls by
a tenth of the box or more.
"""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness, reference, reference_gn, work, work_refine
from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.diff.gradients import gauss_newton_refine
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
K, T = 256, 10
TOL = 1e-3          # of the box: see the module docstring
COUNTERS = ("refine.lm_steps", "refine.lm_accepted")


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def config(**cost):
    with open(ROOT / "benchmark" / "configs" / "full_body-GN3-K102400-T30.json") as f:
        conf = dict(json.load(f), num_samples=K, horizon=T)
    conf["cost"] = dict(conf["cost"], **cost)
    return conf


def case(seed):
    """(conf, cfg, sp, cp, course, path, pose) of the cell's inputs at K, T."""
    conf = config()
    rng = harness.inputs_rng(seed)
    course = harness.course_for(conf, {"course_offset_m": 1.0}, rng)
    pose = torch.from_numpy(harness.start_pose(course, 5, rng, [0.05] * 3))
    cfg, sp, cp, _ = full_body_launch(num_samples=K, horizon=T, device="cpu")
    return conf, cfg, sp, cp, course, PathBuffer.from_points(course, 0.1, device="cpu"), pose


def box(conf):
    sol = conf["solver"]
    return (torch.tensor(sol["u_max"], dtype=torch.float64)
            - torch.tensor(sol["u_min"], dtype=torch.float64))


def gap(conf, a, b):
    return ((a.double() - b.double()).abs() / box(conf)).max().item()


def port_chain(seed, updates=2, use_kernel=True, refine_steps=3):
    """[(u_prev, u_opt)] of ``updates`` chained refined updates of the port."""
    conf, cfg, sp, cp, course, path, pose = case(seed)
    ctrl = ControllerState.initial(seed, T, 5, device="cpu")
    out = []
    for _ in range(updates):
        nxt, res = mppi_step(cfg, ctrl, pose, path, torch.tensor(0.1), sp, cp,
                             use_kernel=use_kernel, lean=True, refine_steps=refine_steps,
                             refine_method="gauss_newton")
        out.append((ctrl.u_prev, res.u_opt))
        ctrl = nxt
    return out


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_the_refined_update_matches_the_reference(seed, use_kernel):
    """Two chained updates, each from the port's own warm start (the first
    from zeros), on the kernel's plain version and on the eager path."""
    conf, *_, course, _, pose = case(seed)
    for n, (u_prev, u_opt) in enumerate(port_chain(seed, use_kernel=use_kernel)):
        want, undecided = reference_gn.update_marked(conf, course, pose[None],
                                                     None if n == 0 else u_prev[None], seed, n)
        assert not undecided.any()
        assert gap(conf, u_opt, want[0]) < TOL
        unrefined = reference.update(conf, course, pose[None],
                                     None if n == 0 else u_prev[None], seed, n)
        assert gap(conf, u_opt, unrefined[0]) > 100 * TOL   # the stage is seen


def test_zero_steps_is_the_sampled_reference():
    conf, *_, course, _, pose = case(11)
    u_prev = 0.1 * torch.ones((1, T - 1, 5))
    got, undecided = reference_gn.update_marked(conf, course, pose[None], u_prev, 11, 4,
                                                steps=0)
    assert torch.equal(got, reference.update(conf, course, pose[None], u_prev, 11, 4))
    assert undecided.tolist() == [False]


def test_residuals_square_to_the_cost():
    """With every weight on (the ZMP and roll-rate terms too), the sum of
    the squared residuals is the reference's cost of the sequence, but for
    the 1e-12 under each distance's root."""
    conf = config(zmp_weight=10.0, roll_v_weight=0.5)
    course = reference.course(conf["course"], (0.3, -0.2))
    pose = torch.tensor([[course[3, 0] + 0.05, course[3, 1] - 0.04, 0.1, 0.02, -0.01]],
                        dtype=torch.float64)
    x = reference.Inputs(conf, course, pose, None, torch.float64)
    g = torch.Generator().manual_seed(5)
    u = (torch.rand((T - 1, 5), generator=g, dtype=torch.float64) - 0.5) * 0.8
    u[:, 0] = torch.linspace(-0.5, 1.5, T - 1, dtype=torch.float64)   # both signs of v
    r = reference_gn.residuals(x, 0, u)
    assert r.shape == (work_refine.sizes(T, 5)[0],)
    s = [x.pose[0]]
    for t in range(T - 1):
        s.append(reference.euler("full_body", s[-1], u[t], x.dt))
    states = torch.stack(s)[None, :, None]
    cost = reference.costs("full_body", states, u[None, :, None], x.ref_xy, x.ref_yaw[:, 0],
                           x.dt, x.cost, conf["body"])[0, 0]
    eps = (T - 2) * conf["cost"]["path_weight"] * reference_gn.EPS
    assert torch.sum(r * r).item() == pytest.approx(cost.item() + eps, rel=1e-12)


def test_a_stage_cut_short_fails_the_comparison():
    """On inputs where the reference accepts a step after the first, the
    port with one step lies a tenth of the box or more from the reference's
    three, as the reference's own one step does."""
    seed = 3
    conf, *_, course, _, pose = case(seed)
    ((_, one),) = port_chain(seed, updates=1, refine_steps=1)
    three = reference_gn.update(conf, course, pose[None], None, seed, 0)
    own_one = reference_gn.update_marked(conf, course, pose[None], None, seed, 0, steps=1)[0]
    assert gap(conf, own_one, three) > 0.1
    assert gap(conf, one, three) > 100 * TOL
    assert gap(conf, one, own_one[0]) < TOL


def test_update_marked_marks_a_tie():
    """With every residual but the yaw error weighted 0, J is 0 and the step
    leaves the cost where it was: each accept sits on its threshold."""
    conf, *_, course, _, pose = case(3)
    flat = dict(conf, cost=dict(conf["cost"], path_weight=0.0, v_weight=0.0, back_weight=0.0))
    _, undecided = reference_gn.update_marked(flat, course, pose[None], None, 3, 0)
    assert undecided.tolist() == [True]
    _, undecided = reference_gn.update_marked(conf, course, pose[None], None, 3, 0)
    assert undecided.tolist() == [False]


# --- the device counters ----------------------------------------------------------------------

def refine_inputs(seed=3):
    conf, cfg, sp, cp, course, path, pose = case(seed)
    ref = resample_reference(path, pose[:2], cp.v_ref, torch.tensor(0.1), T)
    u = 0.2 * torch.randn((T - 1, 5), generator=torch.Generator().manual_seed(seed))
    return cfg, torch.clamp(u, sp.u_min, sp.u_max), pose, ref, torch.tensor(0.1), sp, cp


def test_the_eager_step_counts_its_steps_and_accepts():
    calls = 4
    for c in range(1, calls + 1):
        port_chain(3, updates=1, use_kernel=False)
        counted = profiling.counters()
        assert counted["refine.lm_steps"] == 3 * c
        assert 1 <= counted.get("refine.lm_accepted", 0) <= counted["refine.lm_steps"]


def test_counting_leaves_u_opt_bit_equal(monkeypatch):
    counted = [u for _, u in port_chain(2**31 + 5, use_kernel=False)]
    read = profiling.counters()
    assert read["refine.lm_steps"] == 6
    monkeypatch.setattr(profiling, "device_counting", lambda *tensors: False)
    profiling.reset()
    plain = [u for _, u in port_chain(2**31 + 5, use_kernel=False)]
    assert all(torch.equal(a, b) for a, b in zip(counted, plain))
    assert profiling.counters() == {}


def test_reset_zeroes_the_counters_in_place():
    gauss_newton_refine(*refine_inputs())
    group = profiling._DEVICE_COUNTERS[(COUNTERS, torch.device("cpu"))]
    assert group.dtype == torch.int64 and group[0].item() == 3
    profiling.reset()
    assert profiling._DEVICE_COUNTERS[(COUNTERS, torch.device("cpu"))] is group
    assert group.tolist() == [0, 0]
    assert not set(COUNTERS) & set(profiling.counters())


def test_nothing_is_counted_under_a_transform_or_with_grad():
    cfg, u, *rest = refine_inputs()
    with torch.enable_grad():
        gauss_newton_refine(cfg, u.clone().requires_grad_(True), *rest)
    assert profiling.counters() == {}
    seen = []
    torch.func.vmap(lambda v: seen.append(profiling.device_counting(v)) or v)(torch.ones(2, 3))
    torch.func.grad(lambda v: seen.append(profiling.device_counting(v.detach())) or v.sum())(
        torch.ones(3))
    assert seen == [False, False] and profiling.device_counting(torch.ones(2))


def test_a_counter_is_not_first_made_under_a_capture(monkeypatch):
    """Made under a capture it would come from the graph's pool with its
    fill captured: nothing is counted, nothing made."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    made = dict(profiling._DEVICE_COUNTERS), dict(profiling._DEVICE_CONSTANTS)
    assert profiling.device_constant(True, torch.bool, "cuda") is None
    increments = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert profiling.count_on_device(("x", "y"), increments) is False
    assert (profiling._DEVICE_COUNTERS, profiling._DEVICE_CONSTANTS) == made


# --- the work count and the import rule -------------------------------------------------------

def test_work_refine_at_the_cell_s_shape():
    """T=30, U=5: m = 141 residuals, n = 145 unknowns; by hand, one
    evaluation is 27 Euler steps of 14 and 28 terms of (159 + 3) + 2 + 23
    + 2 + 2, and the yaw's 2."""
    m, n = 141, 145
    assert work_refine.sizes(30, 5) == (m, n)
    ev = 27 * 14 + 28 * (159 + 3 + 2 + 23 + 2 + 2) + 2
    assert ev == 5728 == work_refine.evaluation(30)
    step = ((n + 1) * ev + 2 * m * n * n + 2 * m * n + n ** 3 / 3 + 2 * n * n
            + 3 * n + ev + 2 * m + 4)
    got = work_refine.refine_work(30, 5, 3)
    assert got == {"flops": 3 * step, "int_ops": 0, "bytes": 3 * 4 * (m * n + n * n)}
    assert work_refine.bound_us(30, 5, 3) == pytest.approx(3 * step / work.FP32_PEAK * 1e6)


def test_reference_gn_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "benchmark" / "reference_gn.py").read_text())
    names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "torch", "benchmark"}
    code = ("import sys; from benchmark import harness; "
            "harness.reference_module({'reference': 'benchmark/reference_gn.py'}); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & (set(harness.FORBIDDEN) | {"ccv_mppi_path_tracker_tpu_torch"})
