"""The port's unicycle, steering and rate-limited models, their rollouts,
costs, configs and presets against the JAX package, at float64.

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is tests/test_ops.py's for the closed form (rtol 1e-9, atol
1e-12): the two evaluate the same expressions and differ only in summation
order. The presets' parameters go through ``convert.from_numpy``, and one
eager control step per preset holds the converted port against JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.core import config as jax_config
from ccv_mppi_path_tracker_tpu.core.presets import PRESETS as JAX_PRESETS
from ccv_mppi_path_tracker_tpu.core.types import RefWindow as JaxRefWindow
from ccv_mppi_path_tracker_tpu.models import get_model as jax_get_model
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.ops import costs as jcosts
from ccv_mppi_path_tracker_tpu.ops.rollout import rollout as jax_rollout
from ccv_mppi_path_tracker_tpu.ops.rollout import rollout_closed_form as jax_rollout_cf
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.runtime.plant import Plant as JaxPlant
from ccv_mppi_path_tracker_tpu.solver import mppi_step as jax_mppi_step
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.core import SolverConfig, config
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, RefWindow
from ccv_mppi_path_tracker_tpu_torch.models import Model, get_model, register_model
from ccv_mppi_path_tracker_tpu_torch.models import rate_limited_steering as rls
from ccv_mppi_path_tracker_tpu_torch.ops.costs import tracking_cost, trajectory_costs
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import (
    CLOSED_FORM_MODELS,
    rollout,
    rollout_closed_form,
    steer_limits,
)
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.runtime import Plant
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

TOL = dict(rtol=1e-9, atol=1e-12)
T, K = 12, 64
DT = 0.1
NEW_MODELS = ("unicycle", "steering_unicycle", "rate_limited_steering")


def close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


def _inputs(model, seed=0):
    """(state0 (K, S), controls (T-1, K, U)): rates large enough that the
    rate-limited model's steer and rate clips both act."""
    m = get_model(model)
    rng = np.random.RandomState(seed)
    state0 = rng.randn(K, m.num_states) * 0.3
    controls = rng.randn(T - 1, K, m.num_controls) * 2.0
    return state0, controls


def test_models_are_registered_with_their_shapes():
    for name in NEW_MODELS + ("full_body",):
        ours, ref = get_model(name), jax_get_model(name)
        assert ours.state_names == ref.state_names
        assert ours.control_names == ref.control_names
        assert ours.constants == ref.constants
        assert name in CLOSED_FORM_MODELS
    assert steer_limits("rate_limited_steering") == (rls.STEER_MAX, rls.RATE_MAX)


@pytest.mark.parametrize("model", NEW_MODELS)
def test_model_step_matches_jax(model):
    state0, controls = _inputs(model)
    got = get_model(model).step(torch.as_tensor(state0), torch.as_tensor(controls[0]), 0.1)
    close(got, jax_get_model(model).step(jnp.asarray(state0), jnp.asarray(controls[0]), 0.1))


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("model", NEW_MODELS)
def test_rollouts_match_jax(model, batched):
    state0, controls = _inputs(model, seed=1)
    if not batched:
        state0, controls = state0[0], controls[:, 0]
    step = get_model(model).step
    jseq = jax_rollout(jax_get_model(model).step, jnp.asarray(state0),
                       jnp.asarray(controls), 0.1)
    jcf = jax_rollout_cf(model, jnp.asarray(state0), jnp.asarray(controls), 0.1)
    tseq = rollout(step, torch.as_tensor(state0), torch.as_tensor(controls), 0.1)
    tcf = rollout_closed_form(model, torch.as_tensor(state0),
                              torch.as_tensor(controls), 0.1)
    assert tcf.shape == (T,) + state0.shape
    close(tseq, jseq)
    close(tcf, jcf)
    close(tcf, tseq.numpy())
    if model == "rate_limited_steering" and batched:  # the steer clip is reached
        assert float(tseq[1:, :, 3].abs().max()) == pytest.approx(rls.STEER_MAX)


def test_closed_form_follows_a_reregistered_variant():
    """A custom-limit variant registered under the built-in name: the closed
    form reads its limits, not the module's."""
    name = "rate_limited_steering"
    register_model(rls.make_model(steer_max=0.2, rate_max=0.7))
    try:
        assert steer_limits(name) == (0.2, 0.7)
        state0, controls = _inputs(name, seed=2)
        s0, u = torch.as_tensor(state0), torch.as_tensor(controls)
        seq = rollout(get_model(name).step, s0, u, 0.1)
        close(rollout_closed_form(name, s0, u, 0.1), seq.numpy())
        assert float(seq[1:, :, 3].abs().max()) == pytest.approx(0.2)
    finally:
        register_model(rls.MODEL)
    assert steer_limits(name) == (rls.STEER_MAX, rls.RATE_MAX)


@pytest.mark.parametrize("model", NEW_MODELS)
def test_tracking_cost_matches_jax(model):
    _, _, jcp = jax_config.diff_drive_config(dtype=np.float64, v_ref=1.1,
                                             path_weight=3.0, v_weight=0.7)
    cp = from_numpy({n: 0.0 for n in ("control_noise", "lam", "u_min", "u_max",
                                      "noise_beta")},
                    jcp, None, np.zeros(1), {"xy": np.zeros((2, 2)),
                                             "num_valid": 2, "resolution": 0.1},
                    dtype=torch.float64)[1]
    state0, controls = _inputs(model, seed=3)
    states = jax_rollout(jax_get_model(model).step, jnp.asarray(state0),
                         jnp.asarray(controls), 0.1)
    ref_xy = np.cumsum(np.full((T, 2), 0.1), axis=0) + np.array([0.3, -0.5])
    ref_yaw = np.full(T, 0.1)
    jc = jcosts.trajectory_costs(model, states, jnp.asarray(controls), {},
                                 JaxRefWindow(jnp.asarray(ref_xy), jnp.asarray(ref_yaw)), jcp)
    tref = RefWindow(torch.as_tensor(ref_xy), torch.as_tensor(ref_yaw))
    tstates = torch.tensor(np.asarray(states))
    tc = tracking_cost(tstates, torch.as_tensor(controls), tref, cp)
    assert tc.shape == (K,)
    close(tc, jc)
    close(trajectory_costs(model, tstates, torch.as_tensor(controls), {}, tref, cp),
          jc)


def test_trajectory_costs_honours_a_model_cost_fn():
    name = "unicycle_with_cost_fn_test"
    register_model(Model(
        name=name, state_names=("x", "y", "yaw"), control_names=("v", "w"),
        step=get_model("unicycle").step,
        cost_fn=lambda states, controls, aux, ref, cp: states[-1, :, 0] * 2.0,
    ))
    states = torch.rand(T, K, 3, dtype=torch.float64)
    got = trajectory_costs(name, states, torch.rand(T - 1, K, 2), {}, None, None)
    assert torch.equal(got, states[-1, :, 0] * 2.0)


_CONFIGS = ["diff_drive_config", "steering_diff_drive_config",
            "rate_limited_steering_config", "full_body_config"]


@pytest.mark.parametrize("name", _CONFIGS)
def test_configs_match_jax(name):
    jcfg, jsp, jcp = getattr(jax_config, name)(dtype=np.float64)
    cfg, sp, cp = getattr(config, name)(dtype=torch.float64, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for port, ref in ((sp, jsp), (cp, jcp)):
        for f in dataclasses.fields(port):
            np.testing.assert_array_equal(getattr(port, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)))


@pytest.mark.parametrize("preset", list(JAX_PRESETS))
def test_presets_convert_and_step_like_jax(preset):
    """Each preset's parameters, carried over by from_numpy, equal the
    port's own preset, and one eager step on them matches JAX at float64."""
    k = 96
    jcfg, jsp, jcp, jcourse = JAX_PRESETS[preset](num_samples=k, horizon=T,
                                                  dtype=np.float64)
    cfg, sp0, cp0, course = PRESETS[preset](num_samples=k, horizon=T,
                                            dtype=torch.float64, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(course, jcourse)
    jm = jax_get_model(jcfg.model)
    jmp = jax_default_params(np.float64) if jcfg.model == "full_body" else None
    jpath = JaxPathBuffer.from_points(jcourse, 0.1, dtype=np.float64)
    rng = np.random.RandomState(7)
    u_prev = rng.randn(T - 1, jm.num_controls) * 0.1
    noise = rng.randn(T - 1, k, jm.num_controls)
    sp, cp, mp, tu, path = from_numpy(jsp, jcp, jmp, u_prev, jpath, dtype=torch.float64)
    for port, ref in ((sp, sp0), (cp, cp0)):
        for f in dataclasses.fields(port):
            assert torch.equal(getattr(port, f.name), getattr(ref, f.name))
    state = np.zeros(jm.num_states)
    state[1] = jcourse[0, 1] + 0.05
    jctrl = JaxControllerState(u_prev=jnp.asarray(u_prev), key=jax.random.PRNGKey(0),
                               step=jnp.zeros((), jnp.int32))
    _, jres = jax_mppi_step(jcfg, jctrl, jnp.asarray(state), jpath, DT, jsp, jcp,
                            model_params=jmp, noise=jnp.asarray(noise))
    _, res = mppi_step(cfg, ControllerState(tu, 0, 0), torch.as_tensor(state), path,
                       DT, sp, cp, model_params=mp, noise=torch.as_tensor(noise))
    close(res.u_opt, jres.u_opt)
    close(res.opt_states, jres.opt_states)



@pytest.mark.parametrize("model", NEW_MODELS + ("full_body",))
def test_plant_steps_every_registered_model(model):
    m = get_model(model)
    rng = np.random.RandomState(4)
    state, u = rng.randn(m.num_states), rng.randn(m.num_controls)
    kw = dict(control_gain=0.9, substeps=3)
    got = Plant(model_name=model, **kw).step(torch.as_tensor(state), torch.as_tensor(u), 0.1)
    ref = JaxPlant(model_name=model, **kw).step(None, jnp.asarray(state), jnp.asarray(u), 0.1)
    close(got, ref)


def test_solver_config_reports_the_model_dims():
    for name in NEW_MODELS:
        cfg = SolverConfig(model=name)
        assert (cfg.num_controls, cfg.num_states) == (
            jax_get_model(name).num_controls, jax_get_model(name).num_states)


def test_eager_step_of_a_model_without_a_closed_form():
    """A user-registered model goes through the sequential rollout and the
    built-in tracking cost: registered with the unicycle's step, it gives
    the unicycle's update."""
    name = "unicycle_without_closed_form_test"
    register_model(Model(name=name, state_names=("x", "y", "yaw"),
                         control_names=("v", "w"), step=get_model("unicycle").step))
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=K, horizon=T,
                                                dtype=torch.float64, device="cpu")
    path = PathBuffer.from_points(course, 0.1, dtype=torch.float64, device="cpu")
    noise = torch.as_tensor(np.random.RandomState(9).randn(T - 1, K, 2))
    state = torch.tensor([0.0, float(course[0, 1]), 0.1], dtype=torch.float64)
    ctrl = ControllerState.initial(0, T, 2, dtype=torch.float64, device="cpu")
    ref = mppi_step(cfg, ctrl, state, path, DT, sp, cp, noise=noise)[1]
    custom = dataclasses.replace(cfg, model=name)
    got = mppi_step(custom, ctrl, state, path, DT, sp, cp, noise=noise)[1]
    assert name not in CLOSED_FORM_MODELS
    close(got.u_opt, ref.u_opt.numpy())
    close(got.opt_states, ref.opt_states.numpy())
