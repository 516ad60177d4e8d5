"""MPPI over AutoRally's learned network model (models/autorally_nn.py)
against its plain reference (``benchmark/reference_nn.py``), on the CPU at
K=256, T=8: the step against the equations, the seeded weights, the eager
update and a chained compiled update, the device counter of the network's
evaluations, ``use_kernel="auto"`` on every entry point, and the model
parameters' way to the step, which leaves the built-in models' results bit
for bit as they were.

The tolerances, of each control channel's box width: float64 rounding of
the same arithmetic in another order lies near 1e-15, so the float64 update
is held to 1e-12; float32 rounding moves an update by up to 5e-8 at these
sizes (the float32 reference from the float64 one: 2.3e-8 to 4.6e-8 over
three seeds), so the float32 update is held to 1e-6, where the reference
in bfloat16 lies 1.1e-3 to 1.9e-3 away.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, reference_nn, work, work_nn
from ccv_mppi_path_tracker_tpu_torch.core.presets import (
    autorally_nn_launch,
    diff_drive_launch,
    full_body_launch,
    rate_limited_launch,
    steering_launch,
)
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.models import autorally_nn, get_model
from ccv_mppi_path_tracker_tpu_torch.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import (
    CLOSED_FORM_MODELS,
    rollout,
    rollout_closed_form,
)
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals, sample_controls
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import softmax_weights, weighted_update
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.runtime.loop import ControlLoop, run_tracking_experiment
from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, compile_step, mppi_step
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import resolve_auto
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
K, T = 256, 8
BOX = 2.0           # each channel's box width, [-1, 1]
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}   # see the module docstring
SEEDS = [3, 2**31 + 5]


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def config(k=K, t=T):
    with open(ROOT / "benchmark" / "configs" / "autorally_nn-K102400-T30.json") as f:
        return dict(json.load(f), num_samples=k, horizon=t)


def case(seed, dtype=torch.float32):
    """(conf, cfg, sp, cp, course, path, pose) of the cell's inputs at K, T."""
    conf = config()
    rng = harness.inputs_rng(seed)
    course = harness.course_for(conf, {"course_offset_m": 1.0}, rng)
    pose = torch.from_numpy(harness.start_pose(course, 7, rng, [0.05] * 3)).to(dtype)
    cfg, sp, cp, _ = autorally_nn_launch(num_samples=K, horizon=T, dtype=dtype, device="cpu")
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device="cpu")
    return conf, cfg, sp, cp, course, path, pose


def gap(a, b):
    return ((a.double() - b.double()).abs() / BOX).max().item()


def dt(dtype=torch.float32):
    return torch.tensor(0.1, dtype=dtype)


# --- the model --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_step_is_the_equations(dtype):
    g = torch.Generator().manual_seed(7)
    s = torch.randn((5, 7), generator=g, dtype=dtype)
    u = torch.rand((5, 2), generator=g, dtype=dtype) * 2 - 1
    p = autorally_nn.default_params("cpu", dtype)
    z = torch.cat([s[:, 3:], u], dim=1)
    h1 = torch.tanh(z @ p.w1.T + p.b1)
    h2 = torch.tanh(h1 @ p.w2.T + p.b2)
    net = h2 @ p.w3.T + p.b3
    yaw, vx, vy, r = s[:, 2], s[:, 4], s[:, 5], s[:, 6]
    want = s + 0.1 * torch.cat([torch.stack([vx * torch.cos(yaw) - vy * torch.sin(yaw),
                                             vx * torch.sin(yaw) + vy * torch.cos(yaw),
                                             -r], dim=1), net], dim=1)
    got = autorally_nn.step(s, u, 0.1)
    eps = torch.finfo(dtype).eps
    torch.testing.assert_close(got, want, rtol=8 * eps, atol=8 * eps)
    assert [tuple(w.shape) for w in (p.w1, p.b1, p.w2, p.b2, p.w3, p.b3)] == [
        (32, 6), (32,), (32, 32), (32,), (4, 32), (4,)]
    plant = reference_nn.plant(config(), s.double().numpy(), u.double().numpy(), 0.1)
    np.testing.assert_allclose(plant, want.double().numpy().astype(np.float32), rtol=1e-5,
                               atol=1e-6)


def test_default_params_are_the_reference_s_redraw():
    conf = config()
    assert conf["weights"]["seed"] == autorally_nn.WEIGHTS["seed"]
    assert conf["weights"]["output_scale"] == autorally_nn.WEIGHTS["output_scale"]
    assert conf["weights"]["order"] == autorally_nn.WEIGHTS["order"]
    p = autorally_nn.default_params("cpu")
    ours = [getattr(p, name) for name in autorally_nn.WEIGHTS["order"]]
    theirs = reference_nn.weights(conf)
    assert all(a.dtype == torch.float32 and torch.equal(a, b) for a, b in zip(ours, theirs))
    assert autorally_nn.default_params("cpu") is p          # made once a device and dtype
    p64 = autorally_nn.default_params("cpu", torch.float64)
    assert p64 is not p and torch.equal(p64.w2, p.w2.double())


def test_a_zero_control_rollout_from_rest_stays_bounded():
    """The bound the configuration's ``assumed`` states, at T=30."""
    states = autorally_nn.rollout(torch.zeros(7), torch.zeros((29, 2)), 0.1)
    peak = states.abs().amax(dim=0)
    assert peak[4] < 0.15 and peak[5] < 0.61 and peak[6] < 0.6


# --- the update against the reference -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_one_eager_update_matches_the_reference(seed, dtype):
    conf, cfg, sp, cp, course, path, pose = case(seed, dtype)
    ctrl = ControllerState.initial(seed, T, 2, dtype=dtype, device="cpu")
    _, res = mppi_step(cfg, ctrl, pose, path, dt(dtype), sp, cp, lean=True)
    want = reference_nn.update(conf, course, pose[None], None, seed, 0, dtype=dtype)[0]
    assert gap(res.u_opt, want) < TOL[dtype]
    assert gap(res.u_opt, ctrl.u_prev) > 1e-3          # the update moved


@pytest.mark.parametrize("seed", SEEDS)
def test_three_chained_compiled_updates_match_the_reference(seed):
    """compile_step(use_kernel="auto", lean=True), as the cell runs it, each
    update from the port's own previous output; and the bfloat16 control
    fails the tolerance."""
    conf, cfg, sp, cp, course, path, pose = case(seed)
    step = compile_step(cfg, use_kernel="auto", lean=True)
    ctrl = ControllerState.initial(seed, T, 2, device="cpu")
    for n in range(3):
        nxt, res = step(ctrl, pose, path, dt(), sp, cp)
        u_prev = None if n == 0 else ctrl.u_prev[None]
        want = reference_nn.update(conf, course, pose[None], u_prev, seed, n)[0]
        assert gap(res.u_opt, want) < TOL[torch.float32]
        control = reference_nn.update(conf, course, pose[None], u_prev, seed, n,
                                      dtype=torch.bfloat16)[0]
        assert gap(control, want) > 100 * TOL[torch.float32]
        assert nxt.step == n + 1 and torch.equal(nxt.u_prev, res.u_opt)
        ctrl = nxt


def test_model_params_reach_the_step():
    """Weights passed as ``model_params`` are the ones the rollouts use: on
    the eager path, the planned path and the refinement."""
    conf, cfg, sp, cp, course, path, pose = case(5)
    ctrl = ControllerState.initial(5, T, 2, device="cpu")
    p = autorally_nn.default_params("cpu")
    _, base = mppi_step(cfg, ctrl, pose, path, dt(), sp, cp)
    _, same = mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, model_params=p)
    assert torch.equal(base.u_opt, same.u_opt) and torch.equal(base.opt_states, same.opt_states)
    other = autorally_nn.NNParams(p.w1, p.b1, p.w2, p.b2, -p.w3, -p.b3)
    _, flipped = mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, model_params=other)
    assert gap(flipped.u_opt, base.u_opt) > 1e-3
    torch.testing.assert_close(
        flipped.opt_states, autorally_nn.rollout(pose, flipped.u_opt, dt(), other))
    _, refined = mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, model_params=other,
                           refine_steps=1, refine_step_size=0.05)
    _, refined_default = mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, refine_steps=1,
                                   refine_step_size=0.05)
    assert gap(refined.u_opt, refined_default.u_opt) > 1e-3


def test_the_fused_kernel_refuses_the_model():
    _, cfg, sp, cp, _, path, pose = case(3)
    ctrl = ControllerState.initial(3, T, 2, device="cpu")
    with pytest.raises(ValueError, match="autorally_nn"):
        mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, use_kernel=True)


# --- the device counter and the span ----------------------------------------------------------

def test_nn_evals_adds_k_t_minus_1_an_update():
    _, cfg, sp, cp, _, path, pose = case(3)
    ctrl = ControllerState.initial(3, T, 2, device="cpu")
    step = compile_step(cfg, use_kernel="auto", lean=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for n in range(1, 4):
            ctrl, _ = step(ctrl, pose, path, dt(), sp, cp)
            assert profiling.counters()["model.nn_evals"] == n * K * (T - 1)
    # the stages of the eager arm, each once a step, spans under the profiler
    assert {n: v["count"] for n, v in profiling.spans().items() if n.startswith("stage.")} == {
        f"stage.{n}": 3 for n in ("prologue", "draw", "samples", "rollout_cost", "average",
                                  "finish")}
    profiling.reset()
    mppi_step(cfg, ctrl, pose, path, dt(), sp, cp)          # not lean: the planned path too
    assert profiling.counters()["model.nn_evals"] == K * (T - 1) + T - 1


def test_nothing_is_counted_under_a_transform_or_with_grad():
    u = torch.zeros((T - 1, 3, 2))
    torch.func.vmap(lambda s: autorally_nn.rollout(s, u[:, 0], 0.1))(torch.zeros((4, 7)))
    with torch.enable_grad():
        autorally_nn.rollout(torch.zeros(3, 7), u.requires_grad_(True), 0.1)
    assert "model.nn_evals" not in profiling.counters()


# --- use_kernel="auto" --------------------------------------------------------------------------

def test_auto_resolves_by_model_and_device():
    nn, *_ = autorally_nn_launch(num_samples=K, horizon=T, device="cpu")
    fb, *_ = full_body_launch(num_samples=K, horizon=T, device="cpu")
    for device in ("cpu", "cuda", "cuda:0"):
        assert resolve_auto(nn, {"use_kernel": "auto"}, torch.device(device)) == {
            "use_kernel": False}
    assert resolve_auto(fb, {"use_kernel": "auto", "lean": True}, torch.device("cpu")) == {
        "use_kernel": False, "lean": True}
    assert resolve_auto(fb, {"use_kernel": "auto"}, torch.device("cuda"))["use_kernel"] is True
    options = {"use_kernel": True}
    assert resolve_auto(fb, options, torch.device("cpu")) is options


@pytest.mark.parametrize("bad", ["auto", 1, None])
def test_mppi_step_takes_only_a_bool(bad):
    _, cfg, sp, cp, _, path, pose = case(3)
    ctrl = ControllerState.initial(3, T, 2, device="cpu")
    with pytest.raises(ValueError, match="True or False"):
        mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, use_kernel=bad)


def test_auto_on_every_entry_point_is_the_eager_path_here():
    """compile_step, ControlLoop, the closed loop and the fleet tick with
    "auto" run the eager path on the CPU, as use_kernel=False does."""
    _, cfg, sp, cp, course, path, pose = case(3)
    ctrl = ControllerState.initial(3, T, 2, device="cpu")
    want = mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, lean=True)[1].u_opt
    got = compile_step(cfg, use_kernel="auto", lean=True)(ctrl, pose, path, dt(), sp, cp)[1]
    assert torch.equal(got.u_opt, want)
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path,
                       solver_options={"use_kernel": "auto", "lean": True})
    loop.ctrl = ctrl
    assert torch.equal(loop.step(pose, dt=0.1).u_opt, want)
    run = run_tracking_experiment(cfg, sp, cp, course, num_steps=2, seed=3, use_kernel="auto")
    assert np.isfinite(run["logs"]["u0"]).all()
    fb_cfg, fb_sp, fb_cp, fb_course = full_body_launch(num_samples=64, horizon=T, device="cpu")
    fb_path = PathBuffer.from_points(fb_course, 0.1, device="cpu")
    fleet = ControllerState(torch.zeros((2, T - 1, 5)), 3, 0)
    states = torch.zeros((2, 5))
    auto = build_fleet_step(fb_cfg, use_kernel="auto")(fleet, states, fb_path, dt(), fb_sp,
                                                       fb_cp)[1]
    eager = build_fleet_step(fb_cfg, use_kernel=False)(fleet, states, fb_path, dt(), fb_sp,
                                                       fb_cp)[1]
    assert torch.equal(auto.u_opt, eager.u_opt)


# --- the built-in models are as they were -------------------------------------------------------

def parent_eager(cfg, ctrl, state, path, dt, sp, cp, delay=None):
    """``mppi_step``'s eager arm as it was before the model's parameters
    reached the rollouts (lean=False, no options but ``delay``), frozen:
    (u_opt, opt_states)."""
    model = get_model(cfg.model)
    if delay is not None:
        state = model.step(state, ctrl.u_prev[0], delay)
    model_params = None
    if model.default_params is not None:
        model_params = model.default_params(device=state.device, dtype=state.dtype)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    tm1, u_dim = ctrl.u_prev.shape
    noise = draw_standard_normals(**ctrl.rng(), shape=(tm1, cfg.num_samples, u_dim),
                                  dtype=ctrl.u_prev.dtype, device=state.device)
    u = sample_controls(ctrl.u_prev, sp, cfg.num_samples, steer_off=cfg.steer_off, noise=noise)
    state0 = state.expand(cfg.num_samples, -1)
    if cfg.model in CLOSED_FORM_MODELS:
        states = rollout_closed_form(cfg.model, state0, u, dt)
    else:
        states = rollout(model.step, state0, u, dt)
    aux = {}
    if model.aux_from_rollout is not None:
        aux = model.aux_from_rollout(states, u, dt, model_params)
    weights, _ = softmax_weights(trajectory_costs(cfg.model, states, u, aux, ref, cp), sp.lam)
    u_opt = weighted_update(weights, u)
    if cfg.model in CLOSED_FORM_MODELS:
        return u_opt, rollout_closed_form(cfg.model, state, u_opt, dt)
    return u_opt, rollout(model.step, state, u_opt, dt)


@pytest.mark.parametrize("delay", [None, 0.05])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("launch", [diff_drive_launch, steering_launch, rate_limited_launch,
                                    full_body_launch], ids=lambda f: f.__name__)
def test_builtin_models_are_bit_equal_to_the_parent_eager_arm(launch, dtype, delay):
    cfg, sp, cp, course = launch(num_samples=K, horizon=T, dtype=dtype, device="cpu")
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device="cpu")
    g = torch.Generator().manual_seed(11)
    state = torch.zeros(cfg.num_states, dtype=dtype)
    state[:2] = torch.as_tensor(course[2], dtype=dtype)
    u_prev = 0.1 * torch.randn((T - 1, cfg.num_controls), generator=g, dtype=dtype)
    ctrl = ControllerState(u_prev, 9, 4)
    want_u, want_states = parent_eager(cfg, ctrl, state, path, dt(dtype), sp, cp, delay)
    _, res = mppi_step(cfg, ctrl, state, path, dt(dtype), sp, cp, delay=delay)
    assert torch.equal(res.u_opt, want_u) and torch.equal(res.opt_states, want_states)


# --- the benchmark's pieces ---------------------------------------------------------------------

def test_work_nn_at_the_cell_s_shape():
    """2 (6·32 + 32·32 + 32·4) + 68 + 64 = 2820 an evaluation; at K=102400,
    T=30 about 8.9 GFLOP an update, 94 % of it the network."""
    assert work_nn.NETWORK == 2820
    parts = work_nn.per_sample(30)
    assert parts == {"network": 29 * 2820, "kinematics": 29 * 23,
                     "scan": 30 * (8 + 150 + 1), "speed": 90}
    flops = work_nn.update_flops(102400, 30)
    assert flops == 102400 * sum(parts.values())
    assert 0.93 < parts["network"] / sum(parts.values()) < 0.95
    units = {"unit_us": np.array([50.0, 60.0]), "unit": np.array([0, 0, 1], dtype=np.int32),
             "start_us": np.array([10.0, 30.0, 5.0]), "dur_us": np.array([5.0, 1000.0, 2000.0]),
             "name": np.zeros(3, dtype=np.int32), "names": ["k"]}
    assert work_nn.device_span_us(units) == (1020.0 + 2000.0) / 2
    assert work_nn.update_mfu(units, 102400, 30) == pytest.approx(
        100 * flops / (1510e-6 * work.FP32_PEAK))


def test_the_readers_on_a_small_run():
    """The four readers through ``harness.run`` at K, T on the CPU: nothing
    traced here, so the device readers read None; the counter reads
    K·(T-1) an update."""
    line, _ = harness.run("autorally_nn.update", 2**31 + 7, 0.0, True, torch.device("cpu"), 0.0,
                          config_overrides={"num_samples": K, "horizon": T},
                          traffic_overrides={"warmup_units": 2, "trace_units": 3,
                                             "check_sample": 2})
    assert line["correct"] and line["failed"] == 0
    assert line["metrics"] == {"nn_evals.nn": {"value": K * (T - 1), "unit": "evals"}}


def test_reference_nn_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "benchmark" / "reference_nn.py").read_text())
    names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "numpy", "torch", "benchmark"}
    code = ("import sys; from benchmark import harness; "
            "harness.reference_module({'reference': 'benchmark/reference_nn.py'}); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & (set(harness.FORBIDDEN) | {"ccv_mppi_path_tracker_tpu_torch"})
