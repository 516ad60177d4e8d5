"""Randomized configurations: the port's control step against the JAX
package and the float64 NumPy oracle; the twin of tests/test_fuzz_parity.py.

The same 8 trials, ``RandomState(1000 + trial)``, drawn in the same order as
that test: the model (trial mod 4), T 4-24, K 8-95, dt, control noise,
lambda, v_ref, every cost weight, asymmetric control bounds, the course, the
start state, the noise and the warm start.

(a) float64: the port's eager ``mppi_step`` against ``jax.jit`` of the JAX
    step and against ``oracle_step`` on the same injected noise, u_opt at
    rtol 1e-8 atol 1e-11 and min_cost at rtol 1e-8 (that test's tolerance);
(b) float32: the same draws through ``mppi_step(use_kernel=True)`` (the
    kernel's plain version on the CPU) against the eager arm, at the kernel
    gate: costs (the step's min and mean cost) rtol 2e-5, u_opt max|diff| <=
    5e-4 max|u| + 5e-5. No drawn K fills its launch's blocks, so the
    kernel's masked tail is in every trial.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core.config import (
    SolverConfig as JaxSolverConfig,
    make_cost_params,
    make_solver_params,
)
from ccv_mppi_path_tracker_tpu.core.types import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.models import get_model as jax_get_model
from ccv_mppi_path_tracker_tpu.oracle import oracle_step
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.paths import sum_of_cosines_course
from ccv_mppi_path_tracker_tpu.solver import mppi_step as jax_mppi_step
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, SolverConfig
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost,
    launch_shape,
)
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

MODELS = {
    "unicycle": (2, 3),
    "steering_unicycle": (3, 3),
    "rate_limited_steering": (3, 4),
    "full_body": (5, 5),
}
TRIALS = range(8)


def draw(trial):
    """tests/test_fuzz_parity.py's draws of one trial, in its order."""
    rng = np.random.RandomState(1000 + trial)
    model = list(MODELS)[trial % len(MODELS)]
    u_dim, s_dim = MODELS[model]
    d = dict(model=model, T=int(rng.randint(4, 25)), K=int(rng.randint(8, 96)),
             dt=float(rng.uniform(0.05, 0.2)), control_noise=float(rng.uniform(0.2, 1.5)),
             lam=float(rng.uniform(0.3, 3.0)), v_ref=float(rng.uniform(0.3, 2.0)),
             path_w=float(rng.uniform(0.5, 20.0)), v_w=float(rng.uniform(0.1, 5.0)))
    # the full-body weights randomized too: make_cost_params defaults them to
    # 0 and the oracle to 1, so both sides are given them explicitly
    d["fb_w"] = {k: float(rng.uniform(0.1, 5.0))
                 for k in ("zmp_weight", "roll_v_weight", "back_weight", "yaw_weight")}
    d["lo"] = -rng.uniform(0.5, 3.0, u_dim)
    d["hi"] = rng.uniform(0.5, 3.0, u_dim)
    d["course"] = sum_of_cosines_course(
        amplitudes=(rng.uniform(0.5, 1.5), rng.uniform(0, 0.5), 0.0),
        frequencies=(rng.uniform(0.1, 0.4), rng.uniform(0.3, 0.7), 0.0),
        resolution=0.1, course_length=10.0)
    state = rng.randn(s_dim) * 0.3
    if model == "rate_limited_steering":
        state[3] = np.clip(state[3], -0.4, 0.4)
    d["state"] = state
    d["noise"] = rng.randn(d["T"] - 1, d["K"], u_dim)
    d["u_prev"] = rng.randn(d["T"] - 1, u_dim) * 0.2
    return d


def jax_problem(d, np_dtype):
    """The JAX package's (cfg, sp, cp, path, model params) of a draw."""
    cfg = JaxSolverConfig(model=d["model"], num_samples=d["K"], horizon=d["T"])
    sp = make_solver_params(d["control_noise"], d["lam"], d["lo"], d["hi"], dtype=np_dtype)
    cp = make_cost_params(v_ref=d["v_ref"], path_weight=d["path_w"], v_weight=d["v_w"],
                          dtype=np_dtype, **d["fb_w"])
    path = JaxPathBuffer.from_points(d["course"], 0.1, dtype=np_dtype)
    # full_body: the constants the JAX step and the oracle take by default
    # (float32 values), given to the port as they are
    mp = jax_get_model("full_body").default_params if d["model"] == "full_body" else None
    return cfg, sp, cp, path, mp


def port_step(d, dtype, **kw):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    _, jsp, jcp, jpath, jmp = jax_problem(d, np_dtype)
    sp, cp, mp, u_prev, path = from_numpy(jsp, jcp, jmp, d["u_prev"], jpath, dtype=dtype)
    cfg = SolverConfig(model=d["model"], num_samples=d["K"], horizon=d["T"])
    state = torch.as_tensor(d["state"], dtype=dtype)
    dt = torch.tensor(d["dt"], dtype=dtype)
    return mppi_step(cfg, ControllerState(u_prev, 0, 0), state, path, dt, sp, cp,
                     model_params=mp, noise=torch.as_tensor(d["noise"], dtype=dtype),
                     **kw)[1]


@pytest.mark.parametrize("trial", TRIALS)
def test_randomized_config_matches_jax_and_the_oracle_f64(trial):
    d = draw(trial)
    cfg, sp, cp, path, _ = jax_problem(d, np.float64)
    ctrl = JaxControllerState(u_prev=jnp.asarray(d["u_prev"]), key=jax.random.PRNGKey(0),
                              step=jnp.zeros((), jnp.int32))
    _, jres = jax.jit(lambda c, s, n: jax_mppi_step(cfg, c, s, path, jnp.float64(d["dt"]),
                                                    sp, cp, noise=n))(
        ctrl, jnp.asarray(d["state"]), jnp.asarray(d["noise"]))
    kw = {}
    if d["model"] == "full_body":
        p = jax_get_model("full_body").default_params
        kw = dict(mass=float(p.mass), base2com=float(p.base2com),
                  inertia=np.asarray(p.inertia), gravity_z=float(p.gravity_z))
    ora = oracle_step(d["model"], d["u_prev"], d["state"], d["course"], 0.1, d["dt"],
                      d["noise"], control_noise=d["control_noise"], lam=d["lam"],
                      u_min=d["lo"], u_max=d["hi"], v_ref=d["v_ref"], path_weight=d["path_w"],
                      v_weight=d["v_w"], **d["fb_w"], **kw)
    res = port_step(d, torch.float64)
    msg = f"{d['model']} T={d['T']} K={d['K']} dt={d['dt']:.3f}"
    tol = dict(rtol=1e-8, atol=1e-11, err_msg=msg)
    np.testing.assert_allclose(res.u_opt.numpy(), np.asarray(jres.u_opt), **tol)
    np.testing.assert_allclose(res.u_opt.numpy(), ora["u_opt"], **tol)
    np.testing.assert_allclose(float(res.stats["min_cost"]), ora["costs"].min(), rtol=1e-8)
    np.testing.assert_allclose(float(res.stats["min_cost"]), float(jres.stats["min_cost"]),
                               rtol=1e-8)


@pytest.mark.parametrize("trial", TRIALS)
def test_randomized_config_kernel_arm_matches_the_eager_arm_f32(trial):
    d = draw(trial)
    before = fused_sample_rollout_cost.launches
    krn = port_step(d, torch.float32, use_kernel=True)
    eag = port_step(d, torch.float32)
    assert fused_sample_rollout_cost.launches == before  # CPU: plain version
    # the masked tail: the card's launch of this K has threads past the last sample
    shape = launch_shape(d["model"], d["K"], d["T"], d["T"])
    assert shape.blocks * shape.threads > d["K"]
    assert torch.isfinite(krn.u_opt).all()
    bound = 5e-4 * float(eag.u_opt.abs().max()) + 5e-5
    assert float((krn.u_opt - eag.u_opt).abs().max()) <= bound
    for name in ("min_cost", "mean_cost"):
        np.testing.assert_allclose(float(krn.stats[name]), float(eag.stats[name]),
                                   rtol=2e-5, err_msg=name)
