"""The port's sample-sharded solver over torch.distributed (parallel/,
the ``group`` collectives of ops/softmax_update.py, solver/mppi.py and
diff/system_id.py) against the JAX package, on the CPU over gloo.

One module-scoped launch of scripts/torch_multiprocess_worker.py, four
processes at float64 (K=64, T=10), the twin of tests/test_multiprocess.py:

- each model's sharded eager step under injected noise against JAX's
  single-device ``mppi_step`` fed the whole noise: u_opt rtol 1e-12 atol
  1e-14, min_cost rtol 1e-12, ess rtol 1e-9 (tests/test_sharding.py:57-65);
  elite (the threshold bit-equal to the unsharded port's), stale elite and
  adapt_sigma;
- the kernel's plain version in RNG mode, each rank at its ``first_sample``:
  per-sample costs bit-equal to one unsharded draw; the sharded kernel-path
  update within the kernel gate max|d| <= 5e-4 max|u| + 5e-5 at float32;
- an 80-cycle sharded closed loop (RMSE < 0.15 m, tests/test_sharding.py:79-93),
  the divisibility error;
- the system-ID gradient (num_chunks 1, 4, 8; each chunk all-reduced
  asynchronously) against JAX's single-process value at rtol 1e-12
  (tests/test_multiprocess.py:135-168), and the group fits against the
  one-process fits.

In this process: world size 1 bit-equal to ``mppi_step``; ``philox_normals``
at ``first_sample``; ``initialize_multihost`` without a launch and with one
that cannot join.
"""

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ccv_mppi_path_tracker_tpu.diff.system_id import ControlGains as JaxControlGains
from ccv_mppi_path_tracker_tpu.diff.system_id import (
    rollout_prediction_value_and_grad as jax_value_and_grad,
)
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
from ccv_mppi_path_tracker_tpu_torch.diff import fit_control_gains, fit_full_body_params
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost,
    pack_scalars,
)
from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams, zmp_chain
from ccv_mppi_path_tracker_tpu_torch.parallel import (
    build_sharded_step,
    initialize_multihost,
    samples_group,
)
from ccv_mppi_path_tracker_tpu_torch.paths import resample_reference
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step
from test_torch_solver import Case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_multiprocess_worker.py")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_multiprocess_worker as worker  # noqa: E402

N, K, T = 4, 64, 10
MODELS = worker.MODELS
U_OPT = dict(rtol=1e-12, atol=1e-14)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(mode, world_size, tmp, extra=()):
    """Run the worker in ``world_size`` processes; their npz results."""
    port = free_port()
    outs = [str(tmp / f"{mode}{r}.npz") for r in range(world_size)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--mode", mode, "--coordinator", f"localhost:{port}",
         "--world-size", str(world_size), "--rank", str(r), "--out", outs[r],
         "--device", "cpu", *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world_size)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    return [dict(np.load(o)) for o in outs]


def cases():
    return {m: Case(K, horizon=T, model=m) for m in MODELS}


def write_problem(path, by_model):
    """The worker's inputs: each model's JAX parameters, warm start, state
    and noise as arrays, and the course."""
    arrays = {}
    for m, c in by_model.items():
        for prefix, obj, cls in (("sp", c.jsp, SolverParams), ("cp", c.jcp, CostParams),
                                 ("mp", c.jmp, FullBodyParams)):
            if obj is None:
                continue
            for f in dataclasses.fields(cls):
                arrays[f"{m}/{prefix}/{f.name}"] = np.asarray(getattr(obj, f.name))
        arrays[f"{m}/u_prev"], arrays[f"{m}/state"] = c.u_prev, c.state
        arrays[f"{m}/noise"] = c.noise
    jpath = c.jpath
    arrays.update({"path/xy": np.asarray(jpath.xy),
                   "path/num_valid": np.asarray(jpath.num_valid),
                   "path/resolution": np.asarray(jpath.resolution)})
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def problem_cases():
    return cases()


@pytest.fixture(scope="module")
def ranks(problem_cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mp")
    write_problem(tmp / "problem.npz", problem_cases)
    out = launch("parity", N, tmp, ["--problem", str(tmp / "problem.npz")])
    assert [int(r["rank"]) for r in out] == list(range(N))
    assert all(int(r["world_size"]) == N for r in out)
    return out


def replicated(ranks, key):
    """The value every rank holds for ``key`` (asserted equal)."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


@pytest.mark.parametrize("model", MODELS)
def test_sharded_step_matches_jax_single_device(ranks, problem_cases, model):
    _, jres = problem_cases[model].jax()
    close(replicated(ranks, f"{model}/u_opt"), jres.u_opt, **U_OPT)
    close(replicated(ranks, f"{model}/min_cost"), jres.stats["min_cost"], rtol=1e-12)
    close(replicated(ranks, f"{model}/mean_cost"), jres.stats["mean_cost"], rtol=1e-12)
    close(replicated(ranks, f"{model}/ess"), jres.stats["ess"], rtol=1e-9)


@pytest.mark.parametrize("tag,opts", [
    ("elite", {"elite_frac": 0.25}),
    ("stale", {"elite_frac": 0.25, "elite_stale_thresh": 40.0}),
])
def test_sharded_elite_ranks_every_shard(ranks, problem_cases, tag, opts):
    case = problem_cases["full_body"]
    _, jres = case.jax(**opts)
    port_opts = dict(opts)
    if "elite_stale_thresh" in opts:
        port_opts["elite_stale_thresh"] = torch.tensor(opts["elite_stale_thresh"],
                                                       dtype=torch.float64)
    _, pres = case.port(**port_opts)
    close(replicated(ranks, f"{tag}/u_opt"), jres.u_opt, **U_OPT)
    # the same sort of the same costs: the threshold is the unsharded one's
    thresh = replicated(ranks, f"{tag}/elite_thresh")
    assert thresh == pres.stats["elite_thresh"].numpy()
    close(thresh, jres.stats["elite_thresh"], rtol=1e-12)


@pytest.mark.parametrize("tag,opts", [("sigma", {"adapt_sigma": True}),
                                      ("elite_sigma", {"adapt_sigma": True,
                                                       "elite_frac": 0.25})])
def test_sharded_adapt_sigma_matches_jax(ranks, problem_cases, tag, opts):
    _, jres = problem_cases["full_body"].jax(**opts)
    close(replicated(ranks, f"{tag}/u_opt"), jres.u_opt, **U_OPT)
    close(replicated(ranks, f"{tag}/sigma_suggest"), jres.stats["sigma_suggest"], rtol=1e-9,
          atol=1e-12)


def _kernel_inputs():
    """(kernel leading arguments, scal, ctrl) of the float32 full_body case."""
    c32 = Case(K, f64=False, horizon=T)
    state = torch.as_tensor(c32.state)
    ref = resample_reference(c32.path, state[:2], c32.cp.v_ref, 0.1, T)
    scal = pack_scalars(torch.tensor(0.1), c32.cp, ref.yaw[0], c32.mp, c32.sp.noise_beta,
                        c32.sp.lam)
    kargs = (c32.tu, c32.sp.control_noise, c32.sp.u_min, c32.sp.u_max, ref.xy, state, scal)
    return c32, kargs


def test_sharded_kernel_draws_the_unsharded_samples(ranks):
    """Each rank's RNG-mode costs at its first_sample are its slice of one
    unsharded draw, bit for bit."""
    _, kargs = _kernel_inputs()
    whole = fused_sample_rollout_cost(*kargs, seed=11, step=3, num_samples=K,
                                      model="full_body")[0]
    got = np.concatenate([r["kernel/costs"] for r in ranks])
    np.testing.assert_array_equal(got, whole.numpy())


@pytest.mark.parametrize("tag,opts", [("kernel", {}), ("kernel_elite", {"elite_frac": 0.25})])
def test_sharded_kernel_update_within_the_kernel_gate(ranks, tag, opts):
    c32, _ = _kernel_inputs()
    ctrl = ControllerState(u_prev=c32.tu, seed=11, step=3)
    _, res = mppi_step(c32.cfg, ctrl, torch.as_tensor(c32.state), c32.path, 0.1, c32.sp,
                       c32.cp, model_params=c32.mp, use_kernel=True, **opts)
    u = replicated(ranks, f"{tag}/u_opt")
    bound = 5e-4 * float(res.u_opt.abs().max()) + 5e-5
    assert np.abs(u - res.u_opt.numpy()).max() <= bound
    assert replicated(ranks, f"{tag}/min_cost") == res.stats["min_cost"].numpy()
    if opts:
        assert replicated(ranks, f"{tag}/elite_thresh") == res.stats["elite_thresh"].numpy()


@contextlib.contextmanager
def one_process_group():
    """A gloo group of this process alone, destroyed on exit."""
    assert initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="gloo",
                                timeout_s=30)
    try:
        yield samples_group(device="cpu")[0]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["eager_noise", "eager_rng", "kernel_rng"])
def test_world_size_one_is_bit_equal_to_mppi_step(problem_cases, kind):
    case = problem_cases["full_body"] if kind == "eager_noise" else Case(K, f64=False,
                                                                         horizon=T)
    noise = torch.as_tensor(case.noise) if kind == "eager_noise" else None
    ctrl = ControllerState(u_prev=case.tu, seed=5, step=2)
    state = torch.as_tensor(case.state)
    use_kernel = kind == "kernel_rng"
    option_sets = ({}, {"elite_frac": 0.25}, {"adapt_sigma": True},
                   {"elite_frac": 0.25, "elite_stale_thresh": torch.tensor(40.0,
                                                                          dtype=state.dtype)})
    with one_process_group() as group:
        for opts in option_sets:
            for lean in (False, True):
                step = build_sharded_step(case.cfg, group, use_kernel=use_kernel,
                                          solver_options=dict(opts, lean=lean))
                c1, a = step(ctrl, state, case.path, 0.1, case.sp, case.cp,
                             model_params=case.mp, noise=noise)
                c2, b = mppi_step(case.cfg, ctrl, state, case.path, 0.1, case.sp, case.cp,
                                  model_params=case.mp, noise=noise, use_kernel=use_kernel,
                                  lean=lean, **opts)
                assert torch.equal(a.u_opt, b.u_opt), (opts, lean)
                assert a.stats.keys() == b.stats.keys()
                for name in a.stats:
                    assert torch.equal(a.stats[name], b.stats[name]), (opts, lean, name)
                assert (c1.seed, c1.step) == (c2.seed, c2.step)


def test_sharded_closed_loop_tracks(ranks):
    states = replicated(ranks, "loop/state")
    assert states.shape == (worker.LOOP_STEPS, 3)
    assert int(ranks[0]["loop/steps"]) == worker.LOOP_STEPS
    m = tracking_metrics(states[:, :2], ranks[0]["loop/course"])
    assert m["rmse"] < 0.15, m


def test_divisibility_error(ranks):
    for r in ranks:
        assert "not divisible" in str(r["divisibility_error"])


@pytest.mark.parametrize("num_chunks", [1, 4, 8])
def test_sharded_sysid_gradient_matches_jax(ranks, num_chunks):
    (state0, controls, observed), _, _ = worker.grad_data()
    jl, jg = jax_value_and_grad("unicycle", JaxControlGains(gains=jnp.asarray([1.1, 0.9])),
                                jnp.asarray(state0), jnp.asarray(controls),
                                jnp.asarray(observed), 0.1)
    close(replicated(ranks, f"grad_loss_{num_chunks}"), jl, rtol=1e-12)
    close(replicated(ranks, f"grad_gains_{num_chunks}"), jg.gains, rtol=1e-12)


def test_group_fits_equal_the_one_process_fits(ranks):
    _, (states, u), (zs, zc) = worker.grad_data()
    f64 = torch.float64
    states, u = torch.as_tensor(states), torch.as_tensor(u)
    nxt = get_model("unicycle").step(states, u * torch.tensor([0.9, 1.2], dtype=f64), 0.1)
    fitted, losses = fit_control_gains("unicycle", states, u, nxt, 0.1,
                                       num_steps=worker.FIT_STEPS)
    close(replicated(ranks, "fit/gains"), fitted.gains, rtol=1e-10)
    close(replicated(ranks, "fit/losses"), losses, rtol=1e-9, atol=1e-20)
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params

    true = default_params(device="cpu", dtype=f64)
    zs, zc = torch.as_tensor(zs), torch.as_tensor(zc)
    init = dataclasses.replace(true, base2com=torch.full((), 0.6, dtype=f64))
    fit, zlosses = fit_full_body_params(zs, zc, zmp_chain(zs, zc, 0.1, true)[..., 1], 0.1,
                                        init, num_steps=worker.FIT_STEPS)
    close(replicated(ranks, "zmp_fit/base2com"), fit.base2com, rtol=1e-10)
    close(replicated(ranks, "zmp_fit/mass"), fit.mass, rtol=1e-10)
    close(replicated(ranks, "zmp_fit/losses"), zlosses, rtol=1e-9, atol=1e-20)


@pytest.mark.parametrize("robot", [0, 3])
@pytest.mark.parametrize("u_dim", [2, 3, 5])
def test_philox_first_sample_slices_one_draw(robot, u_dim):
    whole = philox_normals(9, 4, 96, 7, u_dim, robot=robot)
    for first, k in ((0, 32), (32, 32), (40, 56), (95, 1)):
        part = philox_normals(9, 4, k, 7, u_dim, robot=robot, first_sample=first)
        assert torch.equal(part, whole[:, first:first + k])
    fleet = philox_normals(9, 4, 16, 7, u_dim, robot=torch.tensor([robot, robot + 1]),
                           first_sample=40)
    assert torch.equal(fleet[0], whole[:, 40:56])


def test_samples_group_defaults_to_the_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    with one_process_group():
        assert samples_group()[1] == torch.device("cuda", 3)


def test_worker_card_mode_refuses_the_cpu(tmp_path):
    out = tmp_path / "card0.npz"
    p = subprocess.run(
        [sys.executable, WORKER, "--mode", "card", "--coordinator", f"localhost:{free_port()}",
         "--world-size", "1", "--rank", "0", "--out", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "--mode card runs on a CUDA device" in p.stderr
    assert not out.exists()


def test_initialize_multihost_without_a_launch(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_multihost() is False
    assert not dist.is_initialized()


def test_initialize_multihost_raises_when_the_join_fails(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    # rank 1 of 2 looks for rank 0's store on a port where nothing listens
    with pytest.raises(RuntimeError, match="refusing to run as one process"):
        initialize_multihost(f"localhost:{free_port()}", 2, 1, backend="gloo", timeout_s=2)
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")  # configured, but no address
    with pytest.raises(RuntimeError):
        initialize_multihost(backend="gloo", timeout_s=2)
