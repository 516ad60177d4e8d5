"""The port's differentiable side against the JAX package, on the same seeded
numpy inputs: the trajectory cost, its gradient and residuals, both
refinements and ``mppi_step(refine_steps=...)``, system identification, the
``sysid`` command; and the closed loop's solver stats.

Tolerances: float64 rtol 1e-9 for the cost, gradients, residuals and the
gradient refinement; rtol 1e-7 for Gauss-Newton (a Cholesky solve here, an
LU solve in JAX); float32 rtol 2e-4 atol 2e-5 for the kernel path
(tests/test_fuzz_options.py:95-98); rtol 1e-8 for the Adam fits; rtol 1e-12
for the chunked gradient sums.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu import diff as jdiff
from ccv_mppi_path_tracker_tpu.core.types import RefWindow as JaxRefWindow
from ccv_mppi_path_tracker_tpu.models import get_model as jax_get_model
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.models.full_body import zmp_chain as jax_zmp_chain
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.runtime.loop import build_simulate_scan
from ccv_mppi_path_tracker_tpu_torch import cli, diff
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy, learned_from_numpy
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, SolverConfig
from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import fused_sample_rollout_cost
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment, simulate
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step
from test_torch_solver import MODELS, Case

F64 = dict(rtol=1e-9, atol=1e-12)
GN = dict(rtol=1e-7, atol=1e-10)
KERNEL = dict(rtol=2e-4, atol=2e-5)
FIT = dict(rtol=1e-8)
DT = 0.1


def close(port, ref, tol=F64):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


class Problem:
    """One control sequence of ``model`` at horizon T in both packages: the
    node config's parameters, a curved reference window, a start state and
    random controls (or zeros), float64."""

    def __init__(self, model, T=12, seed=0, zero=False):
        config, state = MODELS[model]
        self.jcfg, self.jsp, self.jcp = config(num_samples=8, horizon=T, dtype=np.float64)
        self.cfg = SolverConfig(model=model, num_samples=8, horizon=T)
        rng = np.random.RandomState(seed)
        u_dim = np.asarray(self.jsp.u_min).shape[0]
        self.u = np.zeros((T - 1, u_dim)) if zero else rng.randn(T - 1, u_dim) * 0.3
        self.state = np.array(state, np.float64) + 0.05 * rng.randn(len(state))
        xy = np.stack([np.arange(T) * 0.1, 0.2 * np.sin(0.3 * np.arange(T))], -1)
        yaw = np.arctan2(np.gradient(xy[:, 1]), np.gradient(xy[:, 0]))
        self.jref = JaxRefWindow(xy=jnp.asarray(xy), yaw=jnp.asarray(yaw))
        self.ref = RefWindow(xy=torch.as_tensor(xy), yaw=torch.as_tensor(yaw))
        self.jmp = jax_default_params(np.float64) if model == "full_body" else None
        jpath = JaxPathBuffer.from_points(xy, 0.1, dtype=np.float64)
        self.sp, self.cp, self.mp, self.tu, _ = from_numpy(
            self.jsp, self.jcp, self.jmp, self.u, jpath, dtype=torch.float64)

    def jax_args(self, u=None):
        return (jnp.asarray(self.u if u is None else u), jnp.asarray(self.state), self.jref,
                DT, self.jcp, self.jmp)

    def port_args(self, u=None):
        return (self.tu if u is None else torch.as_tensor(u), torch.as_tensor(self.state),
                self.ref, DT, self.cp, self.mp)


@pytest.mark.parametrize("model", list(MODELS))
def test_cost_gradient_and_residuals_match_jax(model):
    p = Problem(model)
    jcost = jdiff.make_trajectory_cost(p.jcfg)
    jres = jdiff.make_trajectory_residuals(p.jcfg)
    jargs, args = p.jax_args()[1:], p.port_args()[1:]
    # jitted: op-by-op JAX through its scan takes seconds a call
    jc, jg, jr, jj = jax.jit(lambda u: (
        jcost(u, *jargs), jax.grad(lambda v: jcost(v, *jargs))(u), jres(u, *jargs),
        jax.jacfwd(lambda v: jres(v, *jargs))(u)))(jnp.asarray(p.u))
    cost = diff.make_trajectory_cost(p.cfg)
    res = diff.make_trajectory_residuals(p.cfg)
    close(cost(*p.port_args()), jc)
    close(torch.func.grad(lambda u: cost(u, *args))(p.tu), jg)
    close(res(*p.port_args()), jr)
    close(torch.func.jacfwd(lambda u: res(u, *args))(p.tu), jj)


@pytest.mark.parametrize("model", list(MODELS))
def test_residuals_square_to_cost(model):
    p = Problem(model, seed=1)
    r = diff.make_trajectory_residuals(p.cfg)(*p.port_args())
    c = diff.make_trajectory_cost(p.cfg)(*p.port_args())
    close(torch.sum(r * r), c)


def _straight_ref(T):
    xy = np.stack([np.arange(T) * 0.1, np.zeros(T)], -1)
    return RefWindow(xy=torch.as_tensor(xy), yaw=torch.zeros(T, dtype=torch.float64))


def _diff_drive(T):
    from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch

    return diff_drive_launch(horizon=T, dtype=torch.float64, device="cpu")


def _fd_check(f, u, entries, rtol):
    g = torch.func.grad(f)(u)
    eps = 1e-6
    for i, j in entries:
        up, um = u.clone(), u.clone()
        up[i, j] += eps
        um[i, j] -= eps
        fd = (float(f(up)) - float(f(um))) / (2 * eps)
        np.testing.assert_allclose(float(g[i, j]), fd, rtol=rtol, atol=1e-7)
    return g


def test_cost_gradient_matches_finite_difference():
    """Twin of tests/test_diff.py:24-39."""
    cfg, sp, cp, _ = _diff_drive(8)
    cost = diff.make_trajectory_cost(cfg)
    u = torch.as_tensor(np.random.RandomState(0).randn(7, 2) * 0.3)
    _fd_check(lambda u: cost(u, torch.zeros(3, dtype=torch.float64), _straight_ref(8), DT,
                             cp), u, [(0, 0), (3, 1), (6, 0)], 1e-5)


def test_gradient_through_long_horizon():
    """Twin of tests/test_diff.py:124-147: T=100, generic controls."""
    cfg, sp, cp, _ = _diff_drive(100)
    cost = diff.make_trajectory_cost(cfg)
    rng = np.random.RandomState(7)
    u = 0.5 + 0.1 * rng.randn(99, 2)
    u[:, 1] = 0.2 * rng.randn(99)
    g = _fd_check(lambda u: cost(u, torch.zeros(3, dtype=torch.float64),
                                 _straight_ref(100), DT, cp),
                  torch.as_tensor(u), [(0, 0), (0, 1), (50, 0), (98, 0), (98, 1)], 1e-4)
    assert g.shape == (99, 2) and bool(torch.isfinite(g).all())


def _refine_case(model, method, zero):
    return pytest.param(model, method, zero,
                        id=f"{model}-{method}{'-zero_start' if zero else ''}")


@pytest.mark.parametrize(
    "model,method,zero",
    [_refine_case(m, meth, False) for m in MODELS for meth in ("gradient", "gauss_newton")]
    # from a zero warm start the full_body residual min(v, 0) sits on its tie
    + [_refine_case("full_body", meth, True) for meth in ("gradient", "gauss_newton")],
)
def test_refine_matches_jax(model, method, zero):
    p = Problem(model, seed=2, zero=zero)
    args, jargs = p.port_args(), p.jax_args()
    if method == "gradient":
        got = diff.gradient_refine(p.cfg, args[0], *args[1:4], p.sp, p.cp, p.mp,
                                   step_size=0.02, num_steps=3)
        ref = jax.jit(lambda u: jdiff.gradient_refine(
            p.jcfg, u, *jargs[1:4], p.jsp, p.jcp, p.jmp, step_size=0.02,
            num_steps=3))(jargs[0])
        tol = F64
    else:
        got = diff.gauss_newton_refine(p.cfg, args[0], *args[1:4], p.sp, p.cp, p.mp,
                                       num_steps=3)
        ref = jax.jit(lambda u: jdiff.gauss_newton_refine(
            p.jcfg, u, *jargs[1:4], p.jsp, p.jcp, p.jmp, num_steps=3))(jargs[0])
        tol = GN
    assert float((got - args[0]).abs().max()) > 1e-3  # it moved
    close(got, ref, tol)


def test_gauss_newton_one_shots_quadratic_cost():
    """Twin of tests/test_diff.py:169-188: with path_weight 0 one GN step
    lands on v_ref where one gradient step does not."""
    cfg, sp, cp, _ = _diff_drive(10)
    cp = dataclasses.replace(cp, path_weight=torch.tensor(0.0, dtype=torch.float64))
    state, u0 = torch.zeros(3, dtype=torch.float64), torch.zeros((9, 2), dtype=torch.float64)
    u1 = diff.gauss_newton_refine(cfg, u0, state, _straight_ref(10), DT, sp, cp,
                                  num_steps=1, damping=1e-9)
    np.testing.assert_allclose(u1[:, 0].numpy(), float(cp.v_ref), rtol=1e-5)
    g1 = diff.gradient_refine(cfg, u0, state, _straight_ref(10), DT, sp, cp,
                              step_size=0.02, num_steps=1)
    assert abs(float(g1[0, 0]) - float(cp.v_ref)) > 1e-2


@pytest.mark.parametrize("method", ["gradient", "gauss_newton"])
def test_refinement_lowers_the_cost_inside_the_box(method):
    """Twins of tests/test_diff.py:42-53 and :191-203: off the path and
    misaligned, from a zero warm start."""
    cfg, sp, cp, _ = _diff_drive(10)
    cost = diff.make_trajectory_cost(cfg)
    state = torch.tensor([0.0, 0.4, 0.5], dtype=torch.float64)
    u0 = torch.zeros((9, 2), dtype=torch.float64)
    if method == "gradient":
        u1 = diff.gradient_refine(cfg, u0, state, _straight_ref(10), DT, sp, cp,
                                  step_size=0.02, num_steps=10)
    else:
        u1 = diff.gauss_newton_refine(cfg, u0, state, _straight_ref(10), DT, sp, cp,
                                      num_steps=3)
    ref = _straight_ref(10)
    assert float(cost(u1, state, ref, DT, cp)) < float(cost(u0, state, ref, DT, cp))
    assert float(u1[:, 0].max()) <= float(sp.u_max[0]) + 1e-12


def _step_case(model, method, steer_off=False):
    return pytest.param(model, method, steer_off,
                        id=f"{model}-{method}{'-steer_off' if steer_off else ''}")


@pytest.mark.parametrize(
    "model,method,steer_off",
    [_step_case(m, meth) for m in MODELS for meth in ("gradient", "gauss_newton")]
    + [_step_case("full_body", meth, True) for meth in ("gradient", "gauss_newton")],
)
def test_refined_eager_step_matches_jax(model, method, steer_off):
    case = Case(64, model=model, steer_off=steer_off, horizon=10)
    opts = dict(refine_steps=3, refine_method=method)
    jctrl, jres = jax.jit(lambda: case.jax(**opts))()
    ctrl, res = case.port(**opts)
    _, plain = case.port()
    assert float((res.u_opt - plain.u_opt).abs().max()) > 1e-4  # refinement moved it
    close(res.u_opt, jres.u_opt, GN)
    close(ctrl.u_prev, jctrl.u_prev, GN)
    close(res.opt_states, jres.opt_states, GN)
    for name in ("min_cost", "mean_cost", "ess"):  # the sampled update's stats
        close(res.stats[name], jres.stats[name], F64)
    _, lean = case.port(lean=True, **opts)
    assert torch.equal(lean.u_opt, res.u_opt)
    if steer_off:
        assert bool((res.u_opt[:, 2] == 0).all())


@pytest.mark.parametrize("model", ["full_body", "unicycle"])
def test_refined_kernel_step_matches_jax_kernel(model):
    """The kernel path (its plain version on the CPU) plus gradient
    refinement against the JAX kernel in interpret mode plus the same
    refinement, float32. Gauss-Newton is held at float64 only: its accept
    test can flip on float32 round-off."""
    case = Case(300, f64=False, model=model, horizon=10)  # a masked tail
    opts = dict(refine_steps=3, refine_method="gradient")
    _, jres = case.jax(use_kernel=True, kernel_interpret=True, **opts)
    before = fused_sample_rollout_cost.launches
    _, res = case.port(use_kernel=True, **opts)
    _, lean = case.port(use_kernel=True, lean=True, **opts)
    assert fused_sample_rollout_cost.launches == before
    close(res.u_opt, jres.u_opt, KERNEL)
    assert torch.equal(lean.u_opt, res.u_opt)


def test_refined_step_runs_under_no_grad_and_rejects_an_unknown_method():
    case = Case(32, horizon=8)
    _, res = case.port(refine_steps=2, refine_method="gauss_newton")
    with torch.no_grad():
        _, quiet = case.port(refine_steps=2, refine_method="gauss_newton")
    assert torch.equal(res.u_opt, quiet.u_opt)
    with pytest.raises(ValueError, match="refine_method"):
        case.port(refine_steps=1, refine_method="newton")


# --- system identification ------------------------------------------------

def _transitions(n, seed, gains):
    rng = np.random.RandomState(seed)
    states, controls = rng.randn(n, 3), rng.randn(n, 2)
    next_states = np.asarray(jax_get_model("unicycle").step(
        jnp.asarray(states), jnp.asarray(controls * gains), DT))
    return states, controls, next_states


def test_fit_control_gains_matches_jax():
    data = _transitions(512, 1, np.array([0.85, 1.1]))
    jfit, jlosses = jdiff.fit_control_gains("unicycle", *map(jnp.asarray, data), DT,
                                            num_steps=100)
    fit, losses = diff.fit_control_gains("unicycle", *map(torch.as_tensor, data), DT,
                                         num_steps=100)
    close(fit.gains, jfit.gains, FIT)
    close(losses, jlosses, FIT)


def test_system_id_recovers_control_gains():
    """Twin of tests/test_diff.py:56-68."""
    true_gains = np.array([0.85, 1.1])
    data = _transitions(512, 1, true_gains)
    fitted, losses = diff.fit_control_gains("unicycle", *map(torch.as_tensor, data), DT,
                                            num_steps=400)
    np.testing.assert_allclose(fitted.gains.numpy(), true_gains, rtol=1e-3)
    assert float(losses[-1]) < float(losses[0]) * 1e-3


def _zmp_data():
    """tests/test_diff.py:71-88's data: the true ZMP of random rollouts."""
    rng = np.random.RandomState(2)
    states, controls = rng.randn(12, 64, 5) * 0.2, rng.randn(11, 64, 5) * 0.5
    true = jax_default_params(np.float64)
    observed = np.asarray(jax_zmp_chain(jnp.asarray(states), jnp.asarray(controls), DT,
                                        true)[..., 1])
    init = dataclasses.replace(jax_default_params(np.float64), base2com=np.asarray(0.6))
    return states, controls, observed, true, init


@pytest.mark.parametrize("num_steps", [100, 500])
def test_fit_full_body_params_matches_jax(num_steps):
    states, controls, observed, true, jinit = _zmp_data()
    jfit, jlosses = jdiff.fit_full_body_params(
        jnp.asarray(states), jnp.asarray(controls), jnp.asarray(observed), DT, jinit,
        num_steps=num_steps, learning_rate=0.02)
    init = learned_from_numpy(FullBodyParams, jinit, dtype=torch.float64)
    fit, losses = diff.fit_full_body_params(
        torch.as_tensor(states), torch.as_tensor(controls), torch.as_tensor(observed), DT,
        init, num_steps=num_steps, learning_rate=0.02)
    for name in ("mass", "base2com", "inertia", "gravity_z"):
        close(getattr(fit, name), getattr(jfit, name), FIT)
    # the converged tail is round-off, 1e-25 against a first loss of 1e-2
    close(losses, jlosses, dict(FIT, atol=1e-12 * float(jlosses[0])))
    assert float(init.base2com) == 0.6  # the fit does not write into its init
    if num_steps == 500:  # twin of tests/test_diff.py:85-88
        np.testing.assert_allclose(float(fit.base2com), float(true.base2com), rtol=0.02)
        assert float(losses[-1]) < float(losses[0]) * 1e-2


def _rollout_data():
    """tests/test_diff.py:222-228's data."""
    rng = np.random.RandomState(3)
    b, t = 128, 16
    return (np.zeros((b, 3)), rng.randn(t, b, 2) * 0.5, rng.randn(t, b, 3) * 0.1,
            np.array([1.1, 0.9]))


def test_rollout_prediction_loss_and_chunked_gradient_match_jax():
    state0, controls, observed, gains = _rollout_data()
    jp = jdiff.ControlGains(gains=jnp.asarray(gains))
    p = diff.ControlGains(gains=torch.as_tensor(gains))
    targs = tuple(map(torch.as_tensor, (state0, controls, observed)))
    jargs = tuple(map(jnp.asarray, (state0, controls, observed)))
    close(diff.rollout_prediction_loss("unicycle", p, *targs, DT),
          jdiff.rollout_prediction_loss("unicycle", jp, *jargs, DT))
    l1, g1 = diff.rollout_prediction_value_and_grad("unicycle", p, *targs, DT)
    for nc in (1, 4, 8):
        jl, jg = jax.jit(lambda *a, nc=nc: jdiff.rollout_prediction_value_and_grad(
            "unicycle", jp, *a, DT, num_chunks=nc))(*jargs)
        lc, gc = diff.rollout_prediction_value_and_grad("unicycle", p, *targs, DT,
                                                        num_chunks=nc)
        close(lc, jl, FIT)
        close(gc.gains, jg.gains, FIT)
        close(lc, l1, dict(rtol=1e-12))
        close(gc.gains, g1.gains, dict(rtol=1e-12))
    with pytest.raises(ValueError):
        diff.rollout_prediction_value_and_grad("unicycle", p, *targs, DT, num_chunks=3)


def test_sysid_command_recovers_the_gains(capsys):
    assert cli.main(["sysid", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"true_gains", "fitted_gains", "final_loss"}
    assert out["true_gains"] == [0.85, 1.1]
    np.testing.assert_allclose(out["fitted_gains"], out["true_gains"], rtol=1e-3)
    assert not hasattr(cli, "NOT_YET")  # every command is ported


def test_diff_exports_the_jax_package_names():
    assert sorted(diff.__all__) == sorted(jdiff.__all__)
    assert all(hasattr(diff, name) for name in diff.__all__)


# --- the closed loop's solver stats -----------------------------------------

def test_tracking_experiment_logs_finite_stats():
    """Twin of tests/test_runtime.py:50-53: full_body at K=512, 120 cycles."""
    cfg, sp, cp, course = full_body_launch(num_samples=512, horizon=15, device="cpu")
    out = run_tracking_experiment(cfg, sp, cp, course, num_steps=120)
    logs = out["logs"]
    assert set(logs) == {"state", "u0", "ess", "min_cost", "mean_cost"}
    assert out["metrics"]["rmse"] < 0.15
    for name in ("ess", "min_cost", "mean_cost"):
        assert logs[name].shape == (120,) and np.isfinite(logs[name]).all()
    assert (logs["ess"] >= 1.0).all() and (logs["ess"] <= 512).all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_logged_stats_equal_each_cycles_own_step(use_kernel):
    """Each cycle's logged stats are those of the same cycle's full
    mppi_step run alone; the lean loop logs the same states and u0."""
    cfg, sp, cp, course = full_body_launch(num_samples=128, horizon=10, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    state0 = torch.tensor([course[0, 0], course[0, 1], 0.2, 0.0, 0.0])
    dt = torch.tensor(DT)
    opts = {"elite_frac": 0.25}
    ctrl, logs = simulate(cfg, ControllerState.initial(3, 10, 5, device="cpu"), state0, path,
                          dt, sp, cp, num_steps=4, use_kernel=use_kernel,
                          solver_options=opts)
    assert set(logs) == {"state", "u0", "ess", "min_cost", "mean_cost", "elite_thresh"}
    _, lean = simulate(cfg, ControllerState.initial(3, 10, 5, device="cpu"), state0, path,
                       dt, sp, cp, num_steps=4, use_kernel=use_kernel, solver_options=opts,
                       with_stats=False)
    assert set(lean) == {"state", "u0"}
    assert torch.equal(lean["state"], logs["state"]) and torch.equal(lean["u0"], logs["u0"])
    c, state, m = ControllerState.initial(3, 10, 5, device="cpu"), state0, get_model(cfg.model)
    for i in range(4):
        c, res = mppi_step(cfg, c, state, path, dt, sp, cp, use_kernel=use_kernel, **opts)
        for name, value in res.stats.items():
            assert torch.equal(logs[name][i], value), (i, name)
        state = m.step(state, res.u0, dt)
    assert torch.equal(c.u_prev, ctrl.u_prev)


def test_closed_loop_stats_match_jax():
    """With the same injected noise every cycle the two frameworks' loops
    are the same function: the logged stats agree at float64."""
    case = Case(64, horizon=10)
    steps = 4
    sim = build_simulate_scan(case.jcfg, num_steps=steps,
                              solver_options={"noise": jnp.asarray(case.noise)})
    from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState

    jctrl0 = JaxControllerState(u_prev=jnp.asarray(case.u_prev), key=jax.random.PRNGKey(0),
                                step=jnp.zeros((), jnp.int32))
    _, jlogs = sim(jctrl0, jnp.asarray(case.state), case.jpath, jnp.asarray(DT), case.jsp,
                   case.jcp, case.jmp)
    _, logs = simulate(case.cfg, ControllerState(case.tu, 0, 0), torch.as_tensor(case.state),
                       case.path, torch.tensor(DT, dtype=torch.float64), case.sp, case.cp,
                       model_params=case.mp, num_steps=steps,
                       solver_options={"noise": torch.as_tensor(case.noise)})
    assert set(logs) == set(jlogs)
    for name in logs:
        close(logs[name], jlogs[name])
