"""The port's control step and closed loop against the JAX package and the
float64 NumPy oracle, with the same injected noise, for the four models.

- eager path at float64: JAX mppi_step and oracle_step, rtol 1e-9 atol 1e-12
  (tests/test_solver_parity.py's tolerance);
- kernel path at float32 (the plain version on the CPU): JAX mppi_step with
  the Pallas kernel in interpret mode, rtol 2e-5 atol 2e-6
  (tests/test_kernel.py's tolerance);
- a 5-cycle closed loop, port against JAX, per-cycle injected noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.core import config as jax_config
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.models.full_body import step as jax_model_step
from ccv_mppi_path_tracker_tpu.oracle import oracle_step
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.solver import mppi_step as jax_mppi_step
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, SolverConfig
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS, full_body_launch
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import fused_sample_rollout_cost
from ccv_mppi_path_tracker_tpu_torch.models.full_body import step as port_model_step
from ccv_mppi_path_tracker_tpu_torch.paths import sum_of_cosines_course
from ccv_mppi_path_tracker_tpu_torch.runtime import Plant, run_tracking_experiment, simulate
from ccv_mppi_path_tracker_tpu_torch.solver import MPPISolver, mppi_step

T = 12
DT = 0.1
F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-6)

# model -> (JAX config of its node, start state)
MODELS = {
    "unicycle": (jax_config.diff_drive_config, [0.0, -0.1, 0.15]),
    "steering_unicycle": (jax_config.steering_diff_drive_config, [0.0, -0.1, 0.15]),
    "rate_limited_steering": (jax_config.rate_limited_steering_config,
                              [0.0, -0.1, 0.15, 0.1]),
    "full_body": (jax_config.full_body_config, [0.0, -0.1, 0.15, 0.02, -0.03]),
}


def _course():
    return sum_of_cosines_course(amplitudes=(1.0, 0.3, 0.0),
                                 frequencies=(0.25, 0.5, 0.0),
                                 resolution=0.1, course_length=12.0)


class Case:
    """One control-step problem, built in both packages from numpy."""

    def __init__(self, k, f64=True, steer_off=False, seed=42, horizon=T,
                 model="full_body"):
        np_dtype = np.float64 if f64 else np.float32
        self.dtype = torch.float64 if f64 else torch.float32
        self.k, self.horizon = k, horizon
        config, state = MODELS[model]
        jcfg, self.jsp, self.jcp = config(num_samples=k, horizon=horizon,
                                          dtype=np_dtype)
        self.jcfg = dataclasses.replace(jcfg, steer_off=steer_off)
        self.cfg = SolverConfig(model=model, num_samples=k, horizon=horizon,
                                steer_off=steer_off)
        u_dim = np.asarray(self.jsp.u_min).shape[0]
        rng = np.random.RandomState(seed)
        self.noise = rng.randn(horizon - 1, k, u_dim).astype(np_dtype)
        self.u_prev = (rng.randn(horizon - 1, u_dim) * 0.1).astype(np_dtype)
        self.state = np.array(state, np_dtype)
        self.course = _course()
        self.jpath = JaxPathBuffer.from_points(self.course, 0.1, dtype=np_dtype)
        self.jmp = jax_default_params(np_dtype) if model == "full_body" else None
        self.sp, self.cp, self.mp, self.tu, self.path = from_numpy(
            self.jsp, self.jcp, self.jmp, self.u_prev, self.jpath, dtype=self.dtype)

    def jax(self, noise=None, state=None, u_prev=None, **kw):
        ctrl = JaxControllerState(
            u_prev=jnp.asarray(self.u_prev if u_prev is None else u_prev),
            key=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
        return jax_mppi_step(
            self.jcfg, ctrl, jnp.asarray(self.state if state is None else state),
            self.jpath, DT, self.jsp, self.jcp, model_params=self.jmp,
            noise=jnp.asarray(self.noise if noise is None else noise), **kw)

    def port(self, noise=None, state=None, u_prev=None, ctrl=None, **kw):
        if ctrl is None:
            ctrl = ControllerState(
                u_prev=self.tu if u_prev is None else torch.as_tensor(u_prev),
                seed=0, step=0)
        if noise is None:
            noise = torch.as_tensor(self.noise)
        return mppi_step(
            self.cfg, ctrl,
            torch.as_tensor(self.state if state is None else state), self.path,
            DT, self.sp, self.cp, model_params=self.mp, noise=noise, **kw)


def close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


def _step_case(opts, name, model="full_body"):
    # the full_body cases keep the ids they had before the other models came
    return pytest.param(opts, model,
                        id=name if model == "full_body" else f"{model}-{name}")


@pytest.mark.parametrize(
    "opts,model",
    [_step_case({}, "full"), _step_case({"lean": True}, "lean"),
     _step_case({"shift_warm_start": True}, "shift"),
     _step_case({"delay": 0.05}, "delay"),
     _step_case({"delay": 0.05, "shift_warm_start": True, "lean": True},
                "delay_shift_lean")]
    + [_step_case(opts, name, model)
       for model in ("unicycle", "steering_unicycle", "rate_limited_steering")
       for opts, name in (({}, "full"),
                          ({"delay": 0.05, "shift_warm_start": True, "lean": True},
                           "delay_shift_lean"))],
)
def test_eager_step_matches_jax_f64(opts, model):
    case = Case(64, model=model)
    jctrl, jres = case.jax(**opts)
    ctrl, res = case.port(**opts)
    close(res.u_opt, jres.u_opt, F64)
    close(res.u0, jres.u0, F64)
    close(ctrl.u_prev, jctrl.u_prev, F64)
    assert ctrl.step == 1 and ctrl.seed == 0
    if opts.get("lean"):
        assert res.ref is None and res.opt_states is None and res.stats == {}
        return
    close(res.ref.xy, jres.ref.xy, F64)
    close(res.ref.yaw, jres.ref.yaw, F64)
    close(res.opt_states, jres.opt_states, F64)
    for name in ("min_cost", "mean_cost", "ess"):
        close(res.stats[name], jres.stats[name], F64)


def _kernel_case(lean, steer_off, model="full_body"):
    name = f"{lean}-{steer_off}"
    return pytest.param(lean, steer_off, model,
                        id=name if model == "full_body" else f"{model}-{name}")


@pytest.mark.parametrize(
    "lean,steer_off,model",
    [_kernel_case(lean, steer_off) for steer_off in (False, True)
     for lean in (False, True)]
    + [_kernel_case(False, False, model)
       for model in ("unicycle", "steering_unicycle", "rate_limited_steering")],
)
def test_kernel_step_matches_jax_kernel_f32(lean, steer_off, model):
    case = Case(1000, f64=False, steer_off=steer_off, model=model)  # masked tail
    _, jres = case.jax(use_kernel=True, kernel_interpret=True, lean=lean)
    before = fused_sample_rollout_cost.launches
    _, res = case.port(use_kernel=True, lean=lean)
    assert fused_sample_rollout_cost.launches == before  # CPU: plain version
    close(res.u_opt, jres.u_opt, F32)
    if not lean:
        close(res.stats["min_cost"], jres.stats["min_cost"], dict(rtol=2e-5))
        close(res.stats["ess"], jres.stats["ess"], dict(rtol=1e-3))
        close(res.opt_states, jres.opt_states, F32)
    # and against the port's own eager path on the same noise
    _, eager = case.port(lean=lean)
    close(res.u_opt, eager.u_opt.numpy(), F32)


@pytest.mark.parametrize("steer_off", [False, True])
def test_eager_step_matches_numpy_oracle(steer_off):
    case = Case(64, steer_off=steer_off)
    _, res = case.port()
    p = case.jmp
    ora = oracle_step(
        "full_body", case.u_prev, case.state, case.course, 0.1, DT, case.noise,
        control_noise=0.5, lam=1.0, u_min=np.asarray(case.jsp.u_min),
        u_max=np.asarray(case.jsp.u_max), v_ref=float(case.jcp.v_ref),
        steer_off=steer_off, mass=float(p.mass), base2com=float(p.base2com),
        inertia=np.asarray(p.inertia), gravity_z=float(p.gravity_z),
    )
    close(res.ref.xy, ora["ref_xy"], F64)
    close(res.ref.yaw[:-1], ora["ref_yaw"][:-1], F64)
    close(res.stats["min_cost"], ora["costs"].min(), F64)
    close(res.u_opt, ora["u_opt"], F64)


def test_closed_loop_matches_jax_for_five_cycles():
    case = Case(48, horizon=10)
    rng = np.random.RandomState(7)
    jstate, jctrl = jnp.asarray(case.state), None
    state = torch.as_tensor(case.state)
    ctrl = ControllerState(u_prev=case.tu, seed=0, step=0)
    for _ in range(5):
        noise = rng.randn(case.horizon - 1, case.k, 5)
        jctrl = jctrl or JaxControllerState(
            u_prev=jnp.asarray(case.u_prev), key=jax.random.PRNGKey(0),
            step=jnp.zeros((), jnp.int32))
        jctrl, jres = jax_mppi_step(case.jcfg, jctrl, jstate, case.jpath, DT,
                                    case.jsp, case.jcp, model_params=case.jmp,
                                    noise=jnp.asarray(noise), lean=True)
        jstate = jax_model_step(jstate, jres.u0, DT)
        ctrl, res = mppi_step(case.cfg, ctrl, state, case.path, DT, case.sp,
                              case.cp, model_params=case.mp,
                              noise=torch.as_tensor(noise), lean=True)
        state = port_model_step(state, res.u0, DT)
        close(state, jstate, F64)
        close(ctrl.u_prev, jctrl.u_prev, F64)
    assert ctrl.step == 5


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rng_mode_is_a_function_of_seed_and_step(use_kernel):
    case = Case(256, f64=False)
    kw = dict(use_kernel=use_kernel, lean=True)

    def run(seed, step):
        ctrl = ControllerState(u_prev=case.tu, seed=seed, step=step)
        return mppi_step(case.cfg, ctrl, torch.as_tensor(case.state), case.path,
                         DT, case.sp, case.cp, **kw)[1].u_opt

    a = run(3, 0)
    assert torch.isfinite(a).all()
    assert torch.equal(a, run(3, 0))
    assert not torch.equal(a, run(4, 0))
    assert not torch.equal(a, run(3, 1))


def test_solver_wrapper_equals_mppi_step():
    case = Case(128, f64=False)
    solver = MPPISolver(case.cfg, use_kernel=True)
    ctrl = solver.init(seed=5, device="cpu")
    assert ctrl.u_prev.shape == (T - 1, 5) and ctrl.seed == 5 and ctrl.step == 0
    state = torch.as_tensor(case.state)
    _, a = solver.step(ctrl, state, case.path, DT, case.sp, case.cp)
    _, b = mppi_step(case.cfg, ctrl, state, case.path, DT, case.sp, case.cp,
                     use_kernel=True)
    assert torch.equal(a.u_opt, b.u_opt)


@pytest.mark.parametrize(
    "use_kernel,preset",
    [pytest.param(uk, p, id=f"{uk}" if p == "full_body" else f"{p}-{uk}")
     for p in PRESETS for uk in (False, True)],
)
def test_tracking_experiment_on_cpu(use_kernel, preset):
    cfg, sp, cp, course = PRESETS[preset](num_samples=512, horizon=15, device="cpu")
    before = fused_sample_rollout_cost.launches
    out = run_tracking_experiment(cfg, sp, cp, course, num_steps=30,
                                  use_kernel=use_kernel)
    assert fused_sample_rollout_cost.launches == before
    s_dim, u_dim = cfg.num_states, cfg.num_controls
    assert out["logs"]["state"].shape == (30, s_dim)
    assert out["logs"]["u0"].shape == (30, u_dim)
    assert np.isfinite(out["logs"]["state"]).all()
    assert out["ctrl"].step == 30
    assert out["metrics"]["rmse"] < 0.15


def test_simulate_process_noise_is_reproducible():
    cfg, sp, cp, course = full_body_launch(num_samples=128, horizon=10, device="cpu")
    case = Case(128, f64=False, horizon=10)
    plant = Plant(model_name="full_body", process_noise=0.01)

    def run():
        ctrl = ControllerState.initial(1, 10, 5, device="cpu")
        return simulate(cfg, ctrl, torch.as_tensor(case.state), case.path,
                        torch.tensor(DT), sp, cp, plant=plant, num_steps=4)[1]

    a, b = run(), run()
    assert torch.equal(a["state"], b["state"])
    quiet = simulate(cfg, ControllerState.initial(1, 10, 5, device="cpu"),
                     torch.as_tensor(case.state), case.path, torch.tensor(DT),
                     sp, cp, num_steps=4)[1]
    assert not torch.equal(a["state"], quiet["state"])
    with pytest.raises(ValueError):
        plant.step(torch.as_tensor(case.state), torch.zeros(5), DT)
