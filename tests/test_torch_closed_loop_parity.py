"""Multi-cycle closed-loop lockstep parity: the port's control step against
the JAX step and against the C++ oracle; the twin of
tests/test_closed_loop_parity.py.

Three implementations run a 20-cycle receding-horizon tracking session side
by side at float64 (K=48, T=10), for unicycle, steering_unicycle and
full_body: the port's ``mppi_step`` with its own configuration builders and
plant, ``jax.jit`` of the JAX package's step with its plant, and the port's
host runtime ``runtime/native.py native_oracle_step`` (csrc/ccv_runtime.cpp)
with the NumPy oracle's plant. The same injected noise each cycle; each side
warm-starts from its own last optimum and integrates its own plant with its
own u[0]. u_opt and the state must agree at every cycle to rtol 1e-9 atol
1e-12 (that test's tolerance): a divergence in sampling, reference
resampling, rollout, cost, softmax or update would compound within a few
cycles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.core import config as jax_config
from ccv_mppi_path_tracker_tpu.models import get_model as jax_get_model
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.oracle.numpy_oracle import _rollout_sample
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.solver import mppi_step as jax_mppi_step
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, config
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, sum_of_cosines_course
from ccv_mppi_path_tracker_tpu_torch.runtime.native import native_oracle_step
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

T = 10
K = 48
DT = 0.1
CYCLES = 20
TOL = dict(rtol=1e-9, atol=1e-12)

# model -> (its config builder in the port, in the JAX package; U, S)
MODELS = {
    "unicycle": (config.diff_drive_config, jax_config.diff_drive_config, 2, 3),
    "steering_unicycle": (config.steering_diff_drive_config,
                          jax_config.steering_diff_drive_config, 3, 3),
    "full_body": (config.full_body_config, jax_config.full_body_config, 5, 5),
}


@pytest.mark.parametrize("model_name", list(MODELS))
def test_closed_loop_lockstep_parity(model_name):
    port_config, jax_builder, u_dim, s_dim = MODELS[model_name]
    course = sum_of_cosines_course(amplitudes=(1.0, 0, 0), frequencies=(0.25, 0, 0),
                                   deltas=(0, 0, 0), course_length=10.0)
    cfg, sp, cp = port_config(num_samples=K, horizon=T, path_weight=10.0,
                              dtype=torch.float64, device="cpu")
    jcfg, jsp, jcp = jax_builder(num_samples=K, horizon=T, path_weight=10.0,
                                 dtype=np.float64)
    mp = jmp = None
    if model_name == "full_body":
        mp = default_params(device="cpu", dtype=torch.float64)
        jmp = jax_default_params(np.float64)
    path = PathBuffer.from_points(course, 0.1, dtype=torch.float64, device="cpu")
    jpath = JaxPathBuffer.from_points(course, 0.1, dtype=np.float64)
    plant, jplant = get_model(model_name), jax_get_model(model_name)
    rng = np.random.RandomState(11)

    start = np.zeros(s_dim)
    start[1] = course[0, 1]
    state, jstate, cstate = torch.as_tensor(start), jnp.asarray(start), start.copy()
    ctrl = ControllerState(u_prev=torch.zeros((T - 1, u_dim), dtype=torch.float64),
                           seed=0, step=0)
    jctrl = JaxControllerState(u_prev=jnp.zeros((T - 1, u_dim), jnp.float64),
                               key=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    c_uprev = np.zeros((T - 1, u_dim))
    jstep = jax.jit(lambda c, s, n: jax_mppi_step(jcfg, c, s, jpath, DT, jsp, jcp,
                                                  model_params=jmp, noise=n))

    for cycle in range(CYCLES):
        noise = rng.randn(T - 1, K, u_dim)
        ctrl, res = mppi_step(cfg, ctrl, state, path, DT, sp, cp, model_params=mp,
                              noise=torch.as_tensor(noise))
        jctrl, jres = jstep(jctrl, jstate, jnp.asarray(noise))
        cc = native_oracle_step(model_name, c_uprev, cstate, course, 0.1, DT, noise,
                                control_noise=0.5, lam=1.0, u_min=sp.u_min, u_max=sp.u_max,
                                v_ref=float(cp.v_ref), cp=cp, model_params=mp)
        u_opt = res.u_opt.numpy()
        np.testing.assert_allclose(u_opt, np.asarray(jres.u_opt), **TOL,
                                   err_msg=f"cycle {cycle}: port vs JAX")
        np.testing.assert_allclose(u_opt, cc["u_opt"], **TOL,
                                   err_msg=f"cycle {cycle}: port vs C++ oracle")
        c_uprev = cc["u_opt"]
        # each side integrates its own plant with its own command
        state = plant.step(state, res.u0, DT)
        jstate = jplant.step(jstate, jres.u0, DT)
        cstate = _rollout_sample(model_name, cstate, cc["u_opt"][:1], DT)[1]
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL,
                                   err_msg=f"cycle {cycle} state: port vs JAX")
        np.testing.assert_allclose(state.numpy(), cstate, **TOL,
                                   err_msg=f"cycle {cycle} state: port vs C++ oracle")
    assert ctrl.step == CYCLES
