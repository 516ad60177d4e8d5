"""Cross-option fuzz of the port's control step, the twin of
tests/test_fuzz_options.py: random combinations of elite (two-pass and
stale), warm-start shift, adapt_sigma, colored noise, steer_off, delay and
refinement, each draw with one injected noise tensor, all four models.

- Without refinement: the kernel path (its plain version on the CPU)
  against the eager path at float32, rtol 2e-4 atol 2e-5 (tests/
  test_fuzz_options.py:95-98), sigma_suggest likewise.
- With refinement: the port's eager step against the JAX package's at
  float64, rtol 1e-7, since a Levenberg-Marquardt accept can flip on a
  float32 difference between the kernel and the eager costs.
- Lean equals full bit for bit on every path, refinement or not.

Seeds are fixed; a failure reproduces exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.core.config import (
    SolverConfig as JaxSolverConfig,
    make_cost_params,
    make_solver_params,
)
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.paths import sum_of_cosines_course
from ccv_mppi_path_tracker_tpu.solver import mppi_step as jax_mppi_step
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, SolverConfig
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

MODELS = {  # model -> (U, S)
    "unicycle": (2, 3),
    "steering_unicycle": (3, 3),
    "rate_limited_steering": (3, 4),
    "full_body": (5, 5),
}
K = 1000  # not a multiple of any block size: a masked tail
T = 10
F32 = dict(rtol=2e-4, atol=2e-5)
F64 = dict(rtol=1e-7, atol=1e-10)


def _draw(trial):
    rng = np.random.RandomState(7100 + trial)
    model = list(MODELS)[trial % len(MODELS)]
    u_dim, _ = MODELS[model]
    elite = rng.choice([None, 0.25, 0.6])
    opts = dict(
        elite_frac=None if elite is None else float(elite),
        shift_warm_start=bool(rng.randint(2)),
        adapt_sigma=bool(rng.randint(2)),
        delay=[None, 0.05][rng.randint(2)],
    )
    draw = dict(model=model, beta=float(rng.choice([0.0, 0.3])),
                steer_off=u_dim > 2 and bool(rng.randint(2)),
                stale=elite is not None and bool(rng.randint(2)),
                refine=[0, 0, 2][rng.randint(3)],
                method=["gradient", "gauss_newton"][rng.randint(2)],
                seed=rng.randint(2**31))
    return draw, opts


class _Inputs:
    """One draw's problem in both packages at ``dtype``."""

    def __init__(self, draw, np_dtype):
        model, rng = draw["model"], np.random.RandomState(draw["seed"])
        u_dim, s_dim = MODELS[model]
        self.dtype = torch.float64 if np_dtype == np.float64 else torch.float32
        self.jcfg = JaxSolverConfig(model=model, num_samples=K, horizon=T,
                                    steer_off=draw["steer_off"])
        self.cfg = SolverConfig(model=model, num_samples=K, horizon=T,
                                steer_off=draw["steer_off"])
        self.jsp = make_solver_params(0.6, 1.2, -np.ones(u_dim) * 1.5, np.ones(u_dim) * 1.5,
                                      noise_beta=draw["beta"], dtype=np_dtype)
        self.jcp = make_cost_params(v_ref=1.0, path_weight=8.0, v_weight=1.0,
                                    zmp_weight=2.0, roll_v_weight=0.5, back_weight=1.0,
                                    yaw_weight=1.0, dtype=np_dtype)
        course = sum_of_cosines_course(amplitudes=(1.0, 0.3, 0.0),
                                       frequencies=(0.2, 0.5, 0.0), resolution=0.1,
                                       course_length=10.0, dtype=np_dtype)
        self.jpath = JaxPathBuffer.from_points(course, 0.1, dtype=np_dtype)
        self.state = (rng.randn(s_dim) * 0.2).astype(np_dtype)
        if model == "rate_limited_steering":
            self.state[3] = np.clip(self.state[3], -0.4, 0.4)
        self.u_prev = (rng.randn(T - 1, u_dim) * 0.2).astype(np_dtype)
        self.noise = rng.randn(T - 1, K, u_dim).astype(np_dtype)
        self.jmp = jax_default_params(np_dtype) if model == "full_body" else None
        self.sp, self.cp, self.mp, self.tu, self.path = from_numpy(
            self.jsp, self.jcp, self.jmp, self.u_prev, self.jpath, dtype=self.dtype)

    def port(self, **kw):
        return mppi_step(self.cfg, ControllerState(self.tu, 0, 0), torch.as_tensor(self.state),
                         self.path, 0.1, self.sp, self.cp, model_params=self.mp,
                         noise=torch.as_tensor(self.noise), **kw)[1]

    def jax(self, **kw):
        if kw.get("elite_stale_thresh") is not None:
            kw["elite_stale_thresh"] = jnp.asarray(float(kw["elite_stale_thresh"]))
        ctrl = JaxControllerState(u_prev=jnp.asarray(self.u_prev), key=jax.random.PRNGKey(0),
                                  step=jnp.zeros((), jnp.int32))
        return jax.jit(lambda: jax_mppi_step(
            self.jcfg, ctrl, jnp.asarray(self.state), self.jpath, 0.1, self.jsp, self.jcp,
            model_params=self.jmp, noise=jnp.asarray(self.noise), **kw))()[1]


def _stale_threshold(inp, opts):
    """A threshold halfway between the eager costs ranked k and k+1 (k the
    elite count), so no float32 difference between the paths moves a sample
    across it."""
    k = max(1, int(round(opts["elite_frac"] * K)))
    kw = dict(opts, adapt_sigma=False)
    lo = inp.port(**dict(kw, elite_frac=k / K)).stats["elite_thresh"]
    hi = inp.port(**dict(kw, elite_frac=(k + 1) / K)).stats["elite_thresh"]
    return (lo + hi) / 2


@pytest.mark.parametrize("trial", range(16))
def test_option_combination(trial):
    draw, base = _draw(trial)
    msg = " ".join(f"{k}={v}" for k, v in dict(draw, **base).items())
    refine = dict(refine_steps=draw["refine"], refine_method=draw["method"])

    def options(inp):
        opts = dict(base, **refine)
        if draw["stale"]:
            opts["elite_stale_thresh"] = _stale_threshold(inp, base)
        return opts

    inp = _Inputs(draw, np.float32)  # the kernel takes float32 only
    opts = options(inp)
    eager, eager_lean = inp.port(**opts), inp.port(lean=True, **opts)
    kern, kern_lean = inp.port(use_kernel=True, **opts), inp.port(use_kernel=True, lean=True,
                                                                  **opts)
    # lean drops outputs and never changes the math
    assert torch.equal(eager_lean.u_opt, eager.u_opt), msg
    assert torch.equal(kern_lean.u_opt, kern.u_opt), msg
    assert eager_lean.ref is None and kern_lean.opt_states is None
    expect = {"sigma_suggest"} if base["adapt_sigma"] else set()
    if base["elite_frac"] is not None:
        expect.add("elite_thresh")
    assert set(kern_lean.stats) == set(eager_lean.stats) == expect, msg
    if draw["steer_off"]:
        assert bool((kern.u_opt[:, 2] == 0).all() and (eager.u_opt[:, 2] == 0).all()), msg
    if not draw["refine"]:
        np.testing.assert_allclose(kern.u_opt.numpy(), eager.u_opt.numpy(), err_msg=msg,
                                   **F32)
        if base["adapt_sigma"]:
            np.testing.assert_allclose(kern.stats["sigma_suggest"].numpy(),
                                       eager.stats["sigma_suggest"].numpy(), err_msg=msg,
                                       **F32)
        return
    inp = _Inputs(draw, np.float64)
    opts = options(inp)
    eager, ref = inp.port(**opts), inp.jax(**opts)
    np.testing.assert_allclose(eager.u_opt.numpy(), np.asarray(ref.u_opt), err_msg=msg, **F64)
    if base["adapt_sigma"]:
        np.testing.assert_allclose(eager.stats["sigma_suggest"].numpy(),
                                   np.asarray(ref.stats["sigma_suggest"]), err_msg=msg, **F64)
