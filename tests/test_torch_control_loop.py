"""The port's ControlLoop (host-driven serving loop) against the JAX one.

- ten cycles of both loops with the same injected noise and sigma_adapt=0.2
  on a fixed sequence of measured states, float32 as the JAX loop runs: u0
  and the adapted sigma each cycle within rtol 2e-5 atol 2e-6
  (tests/test_kernel.py's float32 tolerance; the two differ only in float32
  rounding of the same operations);
- the ports of tests/test_solver_options.py:143-165 (sigma adaptation stays
  bounded and tracks) and tests/test_runtime.py:210-242 (the stale elite
  threshold threaded between cycles), the set_path reset of that threshold,
  and the wall-clock dt.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.runtime.loop import ControlLoop as JaxControlLoop
from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import fused_sample_rollout_cost
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, sum_of_cosines_course
from ccv_mppi_path_tracker_tpu_torch.runtime import ControlLoop
from ccv_mppi_path_tracker_tpu_torch.runtime import loop as loop_module
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step
from test_torch_solver import Case

F32 = dict(rtol=2e-5, atol=2e-6)


def close(port, ref, tol=F32):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


@pytest.mark.parametrize(
    "model,opts",
    [("unicycle", {}), ("full_body", {}), ("steering_unicycle", {"elite_frac": 0.2}),
     ("unicycle", {"elite_frac": 0.2, "elite_stale": True})],
    ids=["unicycle", "full_body", "steering_elite", "unicycle_stale_elite"],
)
def test_control_loop_matches_jax_control_loop(model, opts):
    case = Case(256, f64=False, horizon=10, model=model)
    jloop = JaxControlLoop(cfg=case.jcfg, sp=case.jsp, cp=case.jcp, path=case.jpath,
                           model_params=case.jmp, sigma_adapt=0.2,
                           solver_options=dict(opts, noise=jnp.asarray(case.noise)))
    loop = ControlLoop(cfg=case.cfg, sp=case.sp, cp=case.cp, path=case.path,
                       model_params=case.mp, sigma_adapt=0.2,
                       solver_options=dict(opts, noise=torch.as_tensor(case.noise)))
    rng = np.random.RandomState(3)
    for cycle in range(10):
        state = (case.state + np.r_[0.12 * cycle, 0.02 * rng.randn(),
                                    [0.0] * (case.state.size - 2)]).astype(np.float32)
        jres = jloop.step(state, dt=0.1)
        res = loop.step(state, dt=0.1)
        close(res.u0, jres.u0)
        close(loop.sp.control_noise, jloop.sp.control_noise)
        assert loop.ctrl.step == cycle + 1
    assert not np.allclose(loop.sp.control_noise.numpy(), case.sp.control_noise.numpy())


@pytest.mark.parametrize("use_kernel", [False, True], ids=["eager", "kernel"])
def test_control_loop_sigma_adaptation_stays_bounded_and_tracks(use_kernel):
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=10, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path, sigma_adapt=0.2,
                       solver_options={"use_kernel": use_kernel})
    sigma0 = sp.control_noise.numpy().copy()
    model = get_model(cfg.model)
    state = torch.tensor([0.0, float(course[0, 1]), 0.0])
    before = fused_sample_rollout_cost.launches
    for _ in range(30):
        prev = loop.sp.control_noise.numpy()
        res = loop.step(state, dt=0.1)
        # the JAX loop's float32 NumPy update, bit for bit
        want = np.clip(np.float32(0.8) * prev + np.float32(0.2)
                       * res.stats["sigma_suggest"].numpy(),
                       np.float32(0.25) * sigma0, np.float32(4.0) * sigma0)
        np.testing.assert_array_equal(loop.sp.control_noise.numpy(), want)
        state = model.step(state, res.u0, 0.1)
    assert fused_sample_rollout_cost.launches == before  # CPU: plain version
    sig = loop.sp.control_noise.numpy()
    assert (sig >= 0.25 * sigma0 - 1e-7).all()
    assert (sig <= 4.0 * sigma0 + 1e-7).all()
    assert not np.allclose(sig, sigma0)  # it actually adapted
    err = abs(float(state[1]) - np.interp(float(state[0]), course[:, 0], course[:, 1]))
    assert err < 0.4


def _stale_loop():
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=8, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path,
                       solver_options={"elite_frac": 0.25, "elite_stale": True})
    state = torch.tensor([0.0, float(course[0, 1]), 0.0])
    return loop, state, (cfg, path, torch.tensor(0.1), sp, cp), course


def test_control_loop_elite_stale_threads_threshold():
    """Cycle 0 unmasked, cycle 1 masked at cycle 0's exact threshold, as a
    manual composition of mppi_step."""
    loop, state, (cfg, path, dt, sp, cp), _ = _stale_loop()
    r0 = loop.step(state, dt=0.1)
    r1 = loop.step(state, dt=0.1)
    ctrl0 = ControllerState.initial(0, 8, 2, device="cpu")
    ctrl, m0 = mppi_step(cfg, ctrl0, state, path, dt, sp, cp, elite_frac=0.25,
                         elite_stale_thresh=torch.tensor(float("inf")))
    _, m1 = mppi_step(cfg, ctrl, state, path, dt, sp, cp, elite_frac=0.25,
                      elite_stale_thresh=m0.stats["elite_thresh"])
    close(r0.u0, m0.u0, dict(rtol=1e-6, atol=1e-7))
    close(r1.u0, m1.u0, dict(rtol=1e-6, atol=1e-7))
    assert not torch.equal(r1.u0, mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                                            elite_frac=0.25)[1].u0)


def test_control_loop_set_path_resets_the_stale_threshold():
    loop, state, (cfg, _, dt, sp, cp), course = _stale_loop()
    loop.step(state, dt=0.1)
    loop.step(state, dt=0.1)
    course_b = sum_of_cosines_course(amplitudes=(0.5, 0, 0), frequencies=(0.2, 0, 0),
                                     deltas=(0, 0, 0), resolution=0.1,
                                     course_length=len(course) * 0.1)[: len(course)]
    path_b = PathBuffer.from_points(course_b, 0.1, device="cpu")
    ctrl = loop.ctrl
    loop.set_path(path_b)
    assert loop.path is path_b
    res = loop.step(state, dt=0.1)
    _, want = mppi_step(cfg, ctrl, state, path_b, dt, sp, cp, elite_frac=0.25,
                        elite_stale_thresh=torch.tensor(float("inf")))
    close(res.u0, want.u0, dict(rtol=1e-6, atol=1e-7))
    assert torch.isfinite(res.u0).all()
    with pytest.raises(ValueError):
        ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path_b,
                    solver_options={"elite_stale": True})


def test_control_loop_measures_wall_clock_dt(monkeypatch):
    cfg, sp, cp, course = diff_drive_launch(num_samples=64, horizon=8, device="cpu")
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=PathBuffer.from_points(course, 0.1, device="cpu"),
                       nominal_dt=0.05)
    clock = iter([10.0, 10.25, 10.4])
    monkeypatch.setattr(loop_module.time, "monotonic", lambda: next(clock))
    assert loop.measure_dt() == 0.05  # first cycle: the nominal period
    assert loop.measure_dt() == pytest.approx(0.25)
    res = loop.step(np.array([0.0, float(course[0, 1]), 0.0], np.float32))
    assert torch.isfinite(res.u0).all() and loop.ctrl.step == 1
    # sigma stays fixed without sigma_adapt (the reference)
    assert torch.equal(loop.sp.control_noise, sp.control_noise)
    assert "sigma_suggest" not in res.stats
    assert dataclasses.is_dataclass(loop) and loop.sigma_bounds == (0.25, 4.0)
