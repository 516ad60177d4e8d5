"""MPPI over PETS's probabilistic ensemble (models/pets_pe.py) against its
plain reference (``benchmark/reference_pe.py``), on the CPU at the published
widths (E = 5 members of 6-200-200-200-200-8, P = 20 particles) and a small
K = 16, T = 6: the member equations and the log-variance bounds, the seeded
weights, the TS-infinity assignment, the propagation normals' counters, the
eager update and a chained compiled update, the key-less paths' ensemble
mean, the non-finite costs and the device counters, the fleet's refusal, and
the eager arm's calls of every other model, bit for bit as they were.

The tolerances, of each control channel's box width: float64 rounding of
the same arithmetic in another order lies near 1e-16 here (1.0e-16 and
1.1e-16 over the two seeds), so the float64 update is held to 1e-10; float32
rounding moves an update by up to 1e-7 at these sizes (the float32
reference from the float64 one: 3.5e-8 and 7.7e-8; the port from it 6.6e-8
and 7.4e-8), so the float32 update is held to 1e-6, where the reference in
bfloat16 lies 3.0e-3 and 4.7e-3 away.
"""

import ast
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, reference, reference_pe, work, work_pe
from ccv_mppi_path_tracker_tpu_torch.core.presets import (
    autorally_nn_launch,
    diff_drive_launch,
    full_body_launch,
    pets_pe_launch,
    rate_limited_launch,
    steering_launch,
)
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.models import get_model, pets_pe
from ccv_mppi_path_tracker_tpu_torch.models import registry
from ccv_mppi_path_tracker_tpu_torch.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import CLOSED_FORM_MODELS, rollout_closed_form
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals, sample_controls
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import softmax_weights, weighted_update
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, compile_step, mppi_step
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
K, T = 16, 6
E, P = pets_pe.MEMBERS, pets_pe.PARTICLES
BOX = 2.0           # each channel's box width, [-1, 1]
TOL = {torch.float64: 1e-10, torch.float32: 1e-6}   # see the module docstring
SEEDS = [3, 2**31 + 5]


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def config(k=K, t=T):
    with open(ROOT / "benchmark" / "configs" / "pets_pe-K5120-P20-T30.json") as f:
        return dict(json.load(f), num_samples=k, horizon=t)


def case(seed, dtype=torch.float32):
    """(conf, cfg, sp, cp, course, path, pose) of the cell's inputs at K, T."""
    conf = config()
    rng = harness.inputs_rng(seed)
    course = harness.course_for(conf, {"course_offset_m": 1.0}, rng)
    pose = torch.from_numpy(harness.start_pose(course, 7, rng, [0.05] * 3)).to(dtype)
    cfg, sp, cp, _ = pets_pe_launch(num_samples=K, horizon=T, dtype=dtype, device="cpu")
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device="cpu")
    return conf, cfg, sp, cp, course, path, pose


def gap(a, b):
    return ((a.double() - b.double()).abs() / BOX).max().item()


def dt(dtype=torch.float32):
    return torch.tensor(0.1, dtype=dtype)


def softplus64(x):
    return np.logaddexp(0.0, x)


def constant_heads(params, means, logvars):
    """``params`` with every member's head a constant: member e's mean
    ``means[e]`` (4,) and log-variance ``logvars[e]`` before the bounds."""
    w5 = torch.zeros_like(params.w[-1])
    b5 = torch.cat([torch.as_tensor(means, dtype=w5.dtype),
                    torch.as_tensor(logvars, dtype=w5.dtype)], dim=1)
    return dataclasses.replace(params, w=params.w[:-1] + (w5,), b=params.b[:-1] + (b5,))


def as_particles(x, k):
    """(E, K·P/E, ...) in the call's member-by-member layout -> (K, P, ...),
    particle p = j·E + e."""
    rest = tuple(x.shape[2:])
    x = x.reshape((E, k, P // E) + rest).permute(1, 2, 0, *range(3, 3 + len(rest)))
    return x.reshape((k, P) + rest)


# --- the model --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_each_member_is_the_equations(dtype):
    g = torch.Generator().manual_seed(7)
    dyn = torch.randn((E, 9, 4), generator=g, dtype=dtype)
    u = torch.rand((E, 9, 2), generator=g, dtype=dtype) * 2 - 1
    p = pets_pe.default_params("cpu", dtype)
    mean, logvar = pets_pe.heads(dyn, u, p)
    lv_max, lv_min = pets_pe.LOGVAR_BOUNDS
    for e in range(E):
        h = (torch.cat([dyn[e], u[e]], dim=1) - p.mu_in) / p.sigma_in
        for n in range(4):
            h = h @ p.w[n][e].T + p.b[n][e]
            h = h * torch.sigmoid(h)
        out = (h @ p.w[4][e].T + p.b[4][e]).double().numpy()
        lv = lv_max - softplus64(lv_max - out[:, 4:])
        lv = lv_min + softplus64(lv - lv_min)
        eps = 64 * torch.finfo(dtype).eps
        np.testing.assert_allclose(mean[e].double().numpy(), out[:, :4], rtol=eps, atol=eps)
        np.testing.assert_allclose(logvar[e].double().numpy(), lv, rtol=eps, atol=eps)
    assert [tuple(w.shape) for w in p.w] == [(E, o, i) for i, o in pets_pe.LAYERS]
    # the mean step against the plant's NumPy float64 ensemble mean
    s = torch.randn((5, 7), generator=g, dtype=dtype) * 0.3
    uu = torch.rand((5, 2), generator=g, dtype=dtype) * 2 - 1
    got = pets_pe.step(s, uu, 0.1)
    want = reference_pe.plant(config(), s.double().numpy(), uu.double().numpy(), 0.1)
    np.testing.assert_allclose(got.double().numpy().astype(np.float32), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("lv", [-1e4, -60.0, -10.5, -10.0, -7.0, 0.0, 0.5, 0.75, 30.0, 1e4])
def test_the_log_variance_bounds_at_extreme_inputs(lv):
    """BNN.py's two softplus bounds, against their float64 formulas, with
    the head's raw log-variance set to ``lv`` (torch's softplus is linear
    past 20, where the formula's excess is under float32's resolution)."""
    p = constant_heads(pets_pe.default_params("cpu", torch.float64),
                       torch.zeros((E, 4)), torch.full((E, 4), lv))
    _, got = pets_pe.heads(torch.zeros((E, 3, 4), dtype=torch.float64),
                           torch.zeros((E, 3, 2), dtype=torch.float64), p)
    lv_max, lv_min = pets_pe.LOGVAR_BOUNDS
    want = lv_min + softplus64(lv_max - softplus64(lv_max - lv) - lv_min)
    np.testing.assert_allclose(got.numpy(), np.full((E, 3, 4), want), rtol=1e-12, atol=1e-12)
    assert lv_min <= want <= lv_max + softplus64(lv_min - lv_max) + 1e-12


def test_default_params_are_the_reference_s_redraw():
    conf = config()
    spec = conf["weights"]
    assert spec["seed"] == pets_pe.WEIGHTS["seed"]
    assert spec["hidden_gain"] == pets_pe.WEIGHTS["hidden_gain"] == math.sqrt(6)
    assert spec["output_scale"] == pets_pe.WEIGHTS["output_scale"]
    assert spec["logvar_offset"] == pets_pe.WEIGHTS["logvar_offset"]
    assert (conf["members"], conf["particles"]) == (E, P)
    assert [tuple(x) for x in conf["layers"]] == list(pets_pe.LAYERS)
    assert conf["logvar_bounds"] == list(pets_pe.LOGVAR_BOUNDS)
    p = pets_pe.default_params("cpu")
    theirs = reference_pe.weights(conf)
    for e in range(E):
        ours = [t[e] for pair in zip(p.w, p.b) for t in pair]
        assert all(a.dtype == torch.float32 and torch.equal(a, b)
                   for a, b in zip(ours, theirs[e]))
    assert torch.equal(p.mu_in, torch.tensor(conf["scaler"]["mu_in"]))
    assert torch.equal(p.sigma_in, torch.tensor(conf["scaler"]["sigma_in"]))
    assert pets_pe.default_params("cpu") is p          # made once a device and dtype
    p64 = pets_pe.default_params("cpu", torch.float64)
    assert p64 is not p and torch.equal(p64.w[2], p.w[2].double())


def test_a_zero_control_mean_rollout_from_rest_stays_in_the_envelope():
    """The envelope the configuration's weights block states, at T=30."""
    p = pets_pe.default_params("cpu")
    states = pets_pe.rollout(torch.zeros(7), torch.zeros((29, 2)), 0.1)
    assert (states[:, 3:].abs().amax(dim=0) < 0.15).all()
    dyn = states[:-1, 3:].reshape(1, -1, 4).expand(E, -1, -1)
    _, logvar = pets_pe.heads(dyn, torch.zeros((E, dyn.shape[1], 2)), p)
    sigma = torch.exp(0.5 * logvar)
    assert 0.029 < sigma.min() and sigma.max() < 0.033


# --- particles and their normals --------------------------------------------------------------

def test_ts_infinity_each_member_takes_its_particles_at_every_step():
    """With member e's change a constant e + 1 and no noise, particle p of
    every sequence moves by p mod E + 1 at every step: each member takes P/E
    = 4 particles of each sequence, the same ones throughout."""
    p = constant_heads(pets_pe.default_params("cpu", torch.float64),
                       [[e + 1.0] * 4 for e in range(E)], torch.full((E, 4), -1e4))
    controls = torch.rand((T - 1, K, 2), dtype=torch.float64) * 2 - 1
    states = pets_pe.particle_states(torch.zeros((K, 7), dtype=torch.float64), controls, 0.1,
                                     p, torch.zeros((T - 1, K * P, 4), dtype=torch.float64))
    per = as_particles(states[1:, ..., 3:].movedim(0, 2), K) - as_particles(
        states[:-1, ..., 3:].movedim(0, 2), K)               # (K, P, T-1, 4)
    want = (torch.arange(P) % E + 1.0).double()
    assert torch.equal(per, want.view(1, P, 1, 1).expand_as(per))
    assert all(int((torch.arange(P) % E == e).sum()) == P // E for e in range(E))


@pytest.mark.parametrize("first_sample", [0, 48])
def test_the_propagation_normals_are_the_reference_s_on_their_counters(first_sample):
    """The particles' normals are reference.normals at 'robot' 2^31 and
    sample index (first_sample + k) P + p, in float32 on either path; the
    rollout's costs are those of particle_states under them."""
    seed, step = 2**31 + 11, 4
    got = draw_standard_normals(None, seed, step, (T - 1, K * P, 4),
                                robot=pets_pe.PROPAGATION_ROBOT,
                                first_sample=first_sample * P, device="cpu")
    want = reference.normals(seed, step, [2**31], T - 1, first_sample * P,
                             (first_sample + K) * P, 4, "cpu")[0]
    assert torch.equal(got, want)
    _, cfg, sp, cp, _, path, pose = case(3)
    ref = resample_reference(path, pose[:2], cp.v_ref, dt(), T)
    u = torch.rand((T - 1, K, 2)) * 2 - 1
    p = pets_pe.default_params("cpu")
    costs = pets_pe.rollout_cost(pose.expand(K, -1), u, dt(), p, ref, cp, seed=seed, step=step,
                                 first_sample=first_sample)
    states = pets_pe.particle_states(pose.expand(K, -1), u, dt(), p, want)
    mine = as_particles(pets_pe.states_cost(states, ref.xy, cp), K).mean(dim=1)
    assert torch.equal(costs, mine)


def test_the_propagation_stream_is_disjoint_from_the_exploration_stream():
    """No counter of one is a counter of the other: the exploration's word 3
    is a robot index, under 2^31, the propagation's 2^31 + robot; the plant's
    word 2 is 2^31, the propagation's a pair index under 2. So the normals
    differ, and two shards of K/2 sequences draw the unsharded particles."""
    seed, step = 5, 2
    explore = draw_standard_normals(None, seed, step, (T - 1, K * P, 4), device="cpu")
    prop = draw_standard_normals(None, seed, step, (T - 1, K * P, 4),
                                 robot=pets_pe.PROPAGATION_ROBOT, device="cpu")
    assert not torch.isclose(explore, prop).any()
    whole = draw_standard_normals(None, seed, step, (T - 1, K * P, 4),
                                  robot=pets_pe.PROPAGATION_ROBOT, device="cpu")
    halves = [draw_standard_normals(None, seed, step, (T - 1, K // 2 * P, 4),
                                    robot=pets_pe.PROPAGATION_ROBOT,
                                    first_sample=s * P, device="cpu") for s in (0, K // 2)]
    assert torch.equal(torch.cat(halves, dim=1), whole)


# --- the update against the reference -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_one_eager_update_matches_the_reference(seed, dtype):
    conf, cfg, sp, cp, course, path, pose = case(seed, dtype)
    ctrl = ControllerState.initial(seed, T, 2, dtype=dtype, device="cpu")
    _, res = mppi_step(cfg, ctrl, pose, path, dt(dtype), sp, cp, lean=True)
    want = reference_pe.update(conf, course, pose[None], None, seed, 0, dtype=dtype)[0]
    assert gap(res.u_opt, want) < TOL[dtype]
    assert gap(res.u_opt, ctrl.u_prev) > 1e-3          # the update moved


@pytest.mark.parametrize("seed", SEEDS)
def test_three_chained_compiled_updates_match_the_reference(seed):
    """compile_step(use_kernel="auto", lean=True), as the cell runs it, each
    update from the port's own previous output and drawing both streams
    anew; and the bfloat16 control fails the tolerance."""
    conf, cfg, sp, cp, course, path, pose = case(seed)
    step = compile_step(cfg, use_kernel="auto", lean=True)
    ctrl = ControllerState.initial(seed, T, 2, device="cpu")
    for n in range(3):
        nxt, res = step(ctrl, pose, path, dt(), sp, cp)
        u_prev = None if n == 0 else ctrl.u_prev[None]
        want = reference_pe.update(conf, course, pose[None], u_prev, seed, n)[0]
        assert gap(res.u_opt, want) < TOL[torch.float32]
        control = reference_pe.update(conf, course, pose[None], u_prev, seed, n,
                                      dtype=torch.bfloat16)[0]
        assert gap(control, want) > 100 * TOL[torch.float32]
        assert nxt.step == n + 1 and torch.equal(nxt.u_prev, res.u_opt)
        ctrl = nxt


# --- the key-less paths -------------------------------------------------------------------------

def mean_rollout(state, controls, p):
    """The ensemble-mean rollout written out: every member's mean change on
    the same state, averaged, no noise."""
    states = [state]
    for u in controls:
        s = states[-1]
        mean, _ = pets_pe.heads(s[3:].expand(E, 1, 4), u.expand(E, 1, 2), p)
        yaw, vx, vy, r = s[2], s[4], s[5], s[6]
        pose = s[:3] + 0.1 * torch.stack([vx * torch.cos(yaw) - vy * torch.sin(yaw),
                                          vx * torch.sin(yaw) + vy * torch.cos(yaw), -r])
        states.append(torch.cat([pose, s[3:] + mean.mean(dim=0)[0]]))
    return torch.stack(states)


def test_the_keyless_paths_propagate_the_ensemble_mean():
    """The planned path, delay's prediction and the refinement get no key:
    they roll out the members' mean change with no noise, and so repeat."""
    _, cfg, sp, cp, _, path, pose = case(5, torch.float64)
    ctrl = ControllerState.initial(5, T, 2, dtype=torch.float64, device="cpu")
    p = pets_pe.default_params("cpu", torch.float64)
    _, res = mppi_step(cfg, ctrl, pose, path, dt(torch.float64), sp, cp)
    torch.testing.assert_close(res.opt_states, mean_rollout(pose, res.u_opt, p),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(pets_pe.rollout(pose, res.u_opt, dt(torch.float64)), res.opt_states)
    predicted = pets_pe.step(pose, ctrl.u_prev[0], 0.05)
    _, delayed = mppi_step(cfg, ctrl, pose, path, dt(torch.float64), sp, cp, delay=0.05)
    _, from_predicted = mppi_step(cfg, ctrl, predicted, path, dt(torch.float64), sp, cp)
    assert torch.equal(delayed.u_opt, from_predicted.u_opt)
    _, refined = mppi_step(cfg, ctrl, pose, path, dt(torch.float64), sp, cp, refine_steps=1,
                           refine_step_size=0.05)
    _, again = mppi_step(cfg, ctrl, pose, path, dt(torch.float64), sp, cp, refine_steps=1,
                         refine_step_size=0.05)
    assert torch.equal(refined.u_opt, again.u_opt) and gap(refined.u_opt, res.u_opt) > 1e-6


# --- non-finite costs, the counters, the span --------------------------------------------------

def test_a_non_finite_particle_cost_counts_as_1e6():
    """Member 0 made to give NaN: its P/E particles of every sequence cost
    1e6 each, counted in model.pe_nonfinite, and each sequence's cost is the
    mean with them; with the ensemble sound nothing is counted."""
    _, cfg, sp, cp, _, path, pose = case(3)
    ref = resample_reference(path, pose[:2], cp.v_ref, dt(), T)
    u = torch.rand((T - 1, K, 2)) * 2 - 1
    p = pets_pe.default_params("cpu")
    sound = pets_pe.rollout_cost(pose.expand(K, -1), u, dt(), p, ref, cp, seed=1, step=0)
    assert "model.pe_nonfinite" not in profiling.counters()
    b1 = p.b[0].clone()
    b1[0, 0] = float("nan")
    bad = dataclasses.replace(p, b=(b1,) + p.b[1:])
    costs = pets_pe.rollout_cost(pose.expand(K, -1), u, dt(), bad, ref, cp, seed=1, step=0)
    normals = draw_standard_normals(None, 1, 0, (T - 1, K * P, 4),
                                    robot=pets_pe.PROPAGATION_ROBOT, device="cpu")
    each = as_particles(pets_pe.states_cost(
        pets_pe.particle_states(pose.expand(K, -1), u, dt(), p, normals), ref.xy, cp), K)
    each[:, ::E] = 1e6
    assert torch.equal(costs, each.mean(dim=1)) and (costs > sound).all()
    assert profiling.counters()["model.pe_nonfinite"] == K * P // E


def test_pe_evals_adds_k_p_t_minus_1_an_update():
    _, cfg, sp, cp, _, path, pose = case(3)
    ctrl = ControllerState.initial(3, T, 2, device="cpu")
    step = compile_step(cfg, use_kernel="auto", lean=True)
    for n in range(1, 4):
        ctrl, _ = step(ctrl, pose, path, dt(), sp, cp)
        assert profiling.counters()["model.pe_evals"] == n * K * P * (T - 1)
    assert profiling.spans()["model.pe_rollout"]["count"] == 3
    profiling.reset()
    mppi_step(cfg, ctrl, pose, path, dt(), sp, cp)          # not lean: the planned path too
    assert profiling.counters()["model.pe_evals"] == K * P * (T - 1) + E * (T - 1)


def test_nothing_is_counted_under_a_transform_or_with_grad():
    u = torch.zeros((T - 1, 3, 2))
    torch.func.vmap(lambda s: pets_pe.rollout(s, u[:, 0], 0.1))(torch.zeros((4, 7)))
    with torch.enable_grad():
        pets_pe.rollout(torch.zeros(3, 7), u.requires_grad_(True), 0.1)
    assert "model.pe_evals" not in profiling.counters()


# --- what the model refuses ---------------------------------------------------------------------

def test_the_fleet_refuses_the_model():
    cfg, *_ = pets_pe_launch(num_samples=K, horizon=T, device="cpu")
    for use_kernel in (False, "auto"):
        with pytest.raises(ValueError, match="pets_pe"):
            build_fleet_step(cfg, use_kernel=use_kernel)


def test_debug_candidates_and_the_fused_kernel_are_refused():
    _, cfg, sp, cp, _, path, pose = case(3)
    ctrl = ControllerState.initial(3, T, 2, device="cpu")
    with pytest.raises(ValueError, match="pets_pe"):
        mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, debug_candidates=2)
    with pytest.raises(ValueError, match="pets_pe"):
        mppi_step(cfg, ctrl, pose, path, dt(), sp, cp, use_kernel=True)


# --- every other model's call is as it was -----------------------------------------------------

def lean_eager(cfg, ctrl, state, path, dt, sp, cp):
    """The eager arm's lean update as every deterministic model ran it before
    a model could sample its own transitions, frozen: the rollout_cost hook
    called with its six arguments where the model has one."""
    model = get_model(cfg.model)
    params = None
    if model.default_params is not None:
        params = model.default_params(device=state.device, dtype=state.dtype)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    tm1, u_dim = ctrl.u_prev.shape
    noise = draw_standard_normals(**ctrl.rng(), shape=(tm1, cfg.num_samples, u_dim),
                                  dtype=ctrl.u_prev.dtype, device=state.device)
    u = sample_controls(ctrl.u_prev, sp, cfg.num_samples, steer_off=cfg.steer_off, noise=noise)
    state0 = state.expand(cfg.num_samples, -1)
    if model.rollout_cost is not None:
        costs = model.rollout_cost(state0, u, dt, params, ref, cp)
    else:
        states = rollout_closed_form(cfg.model, state0, u, dt)
        aux = {}
        if model.aux_from_rollout is not None:
            aux = model.aux_from_rollout(states, u, dt, params)
        costs = trajectory_costs(cfg.model, states, u, aux, ref, cp)
    return weighted_update(softmax_weights(costs, sp.lam)[0], u)


@pytest.mark.parametrize("launch", [autorally_nn_launch, diff_drive_launch, steering_launch,
                                    rate_limited_launch, full_body_launch],
                         ids=lambda f: f.__name__)
def test_every_other_model_is_bit_equal_through_the_eager_arm(launch, monkeypatch):
    """Lean eager updates of autorally_nn and the four built-in models equal
    the frozen composition bit for bit; autorally_nn's rollout_cost gets its
    six arguments and no key."""
    cfg, sp, cp, course = launch(num_samples=64, horizon=T, device="cpu")
    model = get_model(cfg.model)
    assert not model.stochastic
    assert cfg.model in CLOSED_FORM_MODELS or model.rollout_cost is not None
    calls = []
    if model.rollout_cost is not None:
        def recording(*args, **kwargs):
            calls.append((len(args), kwargs))
            return model.rollout_cost(*args, **kwargs)
        monkeypatch.setitem(registry._REGISTRY, cfg.model,
                            dataclasses.replace(model, rollout_cost=recording))
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    state = torch.zeros(cfg.num_states)
    state[:2] = torch.as_tensor(course[2])
    g = torch.Generator().manual_seed(11)
    ctrl = ControllerState(0.1 * torch.randn((T - 1, cfg.num_controls), generator=g), 9, 4)
    _, res = mppi_step(cfg, ctrl, state, path, dt(), sp, cp, lean=True)
    assert torch.equal(res.u_opt, lean_eager(cfg, ctrl, state, path, dt(), sp, cp))
    if model.rollout_cost is not None:
        assert calls[0] == (6, {})


# --- the benchmark's pieces ---------------------------------------------------------------------

def test_work_pe_at_the_cell_s_shape():
    """248044 operations a member evaluation; at K=5120, P=20, T=30 about
    0.737 TFLOP an update, over 99.9 % of it the ensemble."""
    assert work_pe.NETWORK == 2 * (6 * 200 + 3 * 200 * 200 + 200 * 8) + 808 + 1600 + 12 + 24
    parts = work_pe.per_particle(30)
    assert parts == {"network": 29 * 248044, "noise": 29 * 20, "kinematics": 29 * 15,
                     "scan": 30 * (8 + 150 + 1), "speed": 90, "particle": 3}
    flops = work_pe.update_flops(5120, 30, 20)
    assert flops == 5120 * 20 * sum(parts.values())
    assert 0.736e12 < flops < 0.738e12 and parts["network"] / sum(parts.values()) > 0.999
    units = {"unit_us": np.array([50.0, 60.0]), "unit": np.array([0, 0, 1], dtype=np.int32),
             "start_us": np.array([10.0, 30.0, 5.0]), "dur_us": np.array([5.0, 1000.0, 2000.0]),
             "name": np.zeros(3, dtype=np.int32), "names": ["k"]}
    assert work_pe.update_mfu(units, 5120, 30, 20) == pytest.approx(
        100 * flops / (1510e-6 * work.FP32_PEAK))
    assert work_pe.update_mfu(None, 5120, 30, 20) is None


def test_the_cell_s_entries():
    """One configuration, one cell, five per-layer metrics of the eager
    update (``pe_fused.pe``, the fused kernel's share, since it came), and
    the cell in propagations_per_s's list."""
    bench = harness.load_benchmark()
    (conf,) = [c for c in bench["configs"] if c["name"] == "pets_pe-K5120-P20-T30"]
    assert conf["reduced"] == [] and conf["file"].endswith("pets_pe-K5120-P20-T30.json")
    cell = harness.find(bench, "workloads", "pets_pe.update")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (conf["name"], "update-pe", 1)
    mine = [m for m in bench["per_layer"] if "pets_pe.update" in m.get("workloads", [])]
    assert sorted(m["name"] for m in mine) == sorted(
        ["pe_device_us.pe", "pe_ops.pe", "pe_evals.pe", "update_mfu.pe", "pe_fused.pe"])
    assert all(m["layer"] == "eager update" and m["moves"] == "propagations_per_s"
               and m["workloads"] == ["pets_pe.update"] for m in mine)
    assert "pets_pe.update" in harness.find(bench, "end_to_end", "propagations_per_s")[
        "workloads"]


def test_the_readers_on_a_small_run():
    """The four readers through ``harness.run`` at K, T on the CPU: nothing
    traced here, so the device readers read None; the counter reads
    K·P·(T-1) an update."""
    line, _ = harness.run("pets_pe.update", 2**31 + 7, 0.0, True, torch.device("cpu"), 0.0,
                          config_overrides={"num_samples": K, "horizon": T},
                          traffic_overrides={"warmup_units": 2, "trace_units": 3,
                                             "check_sample": 2})
    assert line["correct"] and line["failed"] == 0
    assert line["metrics"] == {"pe_evals.pe": {"value": K * P * (T - 1), "unit": "evals"}}


def test_reference_pe_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "benchmark" / "reference_pe.py").read_text())
    names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "numpy", "torch", "benchmark"}
    code = ("import sys; from benchmark import harness; "
            "harness.reference_module({'reference': 'benchmark/reference_pe.py'}); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & (set(harness.FORBIDDEN) | {"ccv_mppi_path_tracker_tpu_torch"})
