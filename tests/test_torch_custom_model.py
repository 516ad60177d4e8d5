"""A fifth, user-registered model in the port (examples/custom_model_torch.py,
the kinematic bicycle), the twin of tests/test_custom_model.py: it goes
through the single-device step (against the JAX package's bicycle at float32
rtol 2e-5 atol 2e-6, tests/test_kernel.py's tolerance), use_kernel="auto"
(eager for a user model and for CPU tensors), the sharded step over gloo
(two worker processes, rtol 1e-6 atol 1e-7 as tests/test_custom_model.py:72-74),
the closed loop, and refinement of its custom cost.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

import custom_model as jcm  # noqa: E402  (registers the JAX bicycle)
import custom_model_torch as cm  # noqa: E402  (registers the port's bicycle)

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState  # noqa: E402
from ccv_mppi_path_tracker_tpu.solver import mppi_step as jax_mppi_step  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, SolverConfig  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (  # noqa: E402
    should_use_kernel,
)
from ccv_mppi_path_tracker_tpu_torch.models import get_model  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.solver import MPPISolver, mppi_step  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-6)


def test_registration_and_config_resolution():
    assert get_model("kinematic_bicycle") is cm.BICYCLE
    cfg, *_ = cm.make_problem(num_samples=64, horizon=8, device="cpu")
    assert (cfg.num_states, cfg.num_controls) == (3, 2)


def test_auto_takes_the_eager_path_for_a_user_model_and_cpu_tensors():
    assert not should_use_kernel("kinematic_bicycle", "cuda")
    assert not should_use_kernel("full_body", "cpu")
    assert should_use_kernel("full_body", "cuda")
    assert should_use_kernel("unicycle", "cuda:0")
    cfg, *_ = cm.make_problem(num_samples=1 << 14, horizon=30, device="cpu")
    assert MPPISolver(cfg, use_kernel="auto", device="cpu").use_kernel is False
    assert MPPISolver(cfg, use_kernel="auto", device="cuda").use_kernel is False
    builtin = SolverConfig(model="full_body", num_samples=102400, horizon=30)
    assert MPPISolver(builtin, use_kernel="auto", device="cpu").use_kernel is False
    assert MPPISolver(builtin, use_kernel="auto").use_kernel is True  # the card's default


def _step_inputs(k=256, t=10):
    cfg, sp, cp, course, path = cm.make_problem(num_samples=k, horizon=t, device="cpu")
    noise = np.random.RandomState(3).randn(t - 1, k, 2).astype(np.float32)
    state = np.array([0.0, float(course[0, 1]), 0.0], np.float32)
    return cfg, sp, cp, course, path, noise, state


def _port_step(cfg, sp, cp, path, noise, state, **kw):
    ctrl = ControllerState.initial(0, cfg.horizon, 2, device="cpu")
    return mppi_step(cfg, ctrl, torch.as_tensor(state), path, 0.1, sp, cp,
                     noise=torch.as_tensor(noise), **kw)[1]


def _jax_step(k, t, noise, state, model="kinematic_bicycle", **kw):
    jcfg, jsp, jcp, _, jpath = jcm.make_problem(num_samples=k, horizon=t)
    if model != jcfg.model:
        from ccv_mppi_path_tracker_tpu.core import SolverConfig as JaxSolverConfig

        jcfg = JaxSolverConfig(model=model, num_samples=k, horizon=t)
    ctrl = JaxControllerState.initial(jax.random.PRNGKey(0), t, 2)
    return jax_mppi_step(jcfg, ctrl, jnp.asarray(state), jpath, jnp.float32(0.1), jsp, jcp,
                         noise=jnp.asarray(noise), **kw)[1]


def test_single_device_step_matches_jax():
    cfg, sp, cp, course, path, noise, state = _step_inputs()
    res = _port_step(cfg, sp, cp, path, noise, state)
    jres = _jax_step(256, 10, noise, state)
    assert res.u_opt.shape == (9, 2) and torch.isfinite(res.u_opt).all()
    np.testing.assert_allclose(res.u_opt.numpy(), np.asarray(jres.u_opt), **F32)
    np.testing.assert_allclose(float(res.stats["min_cost"]), float(jres.stats["min_cost"]),
                               rtol=2e-5)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The worker's custom mode over two gloo processes."""
    tmp = tmp_path_factory.mktemp("custom_mp")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    worker = os.path.join(REPO, "scripts", "torch_multiprocess_worker.py")
    outs = [str(tmp / f"r{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, worker, "--mode", "custom", "--coordinator", f"localhost:{port}",
         "--world-size", "2", "--rank", str(r), "--out", outs[r], "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    return [dict(np.load(o)) for o in outs]


def test_sharded_step_matches_single_device(sharded):
    cfg, sp, cp, course, path, noise, state = _step_inputs()
    res = _port_step(cfg, sp, cp, path, noise, state)
    for r in sharded:
        np.testing.assert_allclose(r["custom/u_opt"], res.u_opt.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(sharded[0]["custom/u_opt"], sharded[1]["custom/u_opt"])
    assert float(sharded[0]["custom/rmse"]) < 0.15


def test_sharded_eager_rng_step_draws_the_unsharded_samples(sharded):
    # over two gloo processes, each shard draws samples rank*K/2 ... of the
    # unsharded eager draw (ops/sampling.py draw_standard_normals at its
    # first_sample), so the sharded step in RNG mode is the unsharded one up
    # to the order of the final sums (rtol 1e-6 atol 1e-7, as above)
    cfg, sp, cp, course, path, _, state = _step_inputs()
    ctrl = ControllerState.initial(0, cfg.horizon, 2, device="cpu")
    _, res = mppi_step(cfg, ctrl, torch.as_tensor(state), path, 0.1, sp, cp)
    for r in sharded:
        np.testing.assert_allclose(r["custom/rng_u_opt"], res.u_opt.numpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(sharded[0]["custom/rng_u_opt"],
                                  sharded[1]["custom/rng_u_opt"])


def test_closed_loop_tracks():
    m = cm.closed_loop_rmse(steps=100, num_samples=1024, horizon=16, device="cpu")
    assert m["rmse"] < 0.15, m
    assert m["max_error"] < 0.35, m


def test_custom_cost_fn_changes_objective():
    """The effort variant's objective is tracking + effort on the same
    rollouts, its update differs from the plain bicycle's, it matches the
    JAX package's effort bicycle, and refinement lowers its cost."""
    from ccv_mppi_path_tracker_tpu_torch.diff.gradients import make_trajectory_cost
    from ccv_mppi_path_tracker_tpu_torch.ops.costs import tracking_cost
    from ccv_mppi_path_tracker_tpu_torch.ops.rollout import rollout
    from ccv_mppi_path_tracker_tpu_torch.ops.sampling import sample_controls

    k, t = 512, 12
    cfg_a, sp, cp, course, path, noise, state = _step_inputs(k, t)
    state[1] += 0.4  # off the path, so tracking asks for steering
    cfg_b = SolverConfig(model="kinematic_bicycle_effort", num_samples=k, horizon=t)
    ra = _port_step(cfg_a, sp, cp, path, noise, state)
    rb = _port_step(cfg_b, sp, cp, path, noise, state)
    u = sample_controls(torch.zeros(t - 1, 2), sp, k, noise=torch.as_tensor(noise))
    states = rollout(cm.bicycle_step, torch.as_tensor(state).expand(k, 3), u, 0.1)
    base = tracking_cost(states, u, rb.ref, cp)
    effort = 2.0 * torch.sum(u[..., 1] ** 2, dim=0)
    np.testing.assert_allclose(float(rb.stats["min_cost"]), float(torch.min(base + effort)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ra.stats["min_cost"]), float(torch.min(base)), rtol=1e-6)
    assert float(torch.max(torch.abs(ra.u_opt - rb.u_opt))) > 1e-3
    jb = _jax_step(k, t, noise, state, model="kinematic_bicycle_effort")
    np.testing.assert_allclose(rb.u_opt.numpy(), np.asarray(jb.u_opt), **F32)

    rr = _port_step(cfg_b, sp, cp, path, noise, state, refine_steps=3, refine_step_size=0.01)
    assert torch.isfinite(rr.u_opt).all()
    cost_fn = make_trajectory_cost(cfg_b)
    st = torch.as_tensor(state)
    c0 = float(cost_fn(rb.u_opt, st, rb.ref, 0.1, cp))
    c1 = float(cost_fn(rr.u_opt, st, rr.ref, 0.1, cp))
    assert c1 <= c0 + 1e-6, (c0, c1)


def test_example_main_runs_its_four_stages(capsys):
    m = cm.main(["--device", "cpu", "--steps", "60", "--num-samples", "512",
                 "--horizon", "12"])
    out = capsys.readouterr().out
    assert "solver path: eager (auto) on cpu" in out
    assert "sharded step over 1 process(es)" in out
    assert m["rmse"] < 0.15
    assert not dist.is_initialized()  # the example's own group is gone
