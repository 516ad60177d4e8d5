"""The sample-sharded programs compiled (solver/mppi.py compile_step with a
group, parallel/sharded.py, runtime/loop.py simulate, diff/system_id.py, the
capture rule and the group's graphs in utils/cuda_graph.py) and
scripts/torch_multihost_demo.py, on the CPU over gloo.

A CUDA graph of NCCL collectives is made and replayed on the card only
(chip_smoke.py phase 34). Here:

- ``compile_step(group=...)`` over a gloo group of one is ``mppi_step(group=
  ...)`` and matches JAX's single-device ``mppi_step`` (f64, u_opt rtol 1e-12
  atol 1e-14 and min_cost rtol 1e-12, as tests/test_torch_parallel.py);
- the capture rule says yes for NCCL (a stand-in for the backend's name), no
  for gloo and for no group; the group keys the graph by identity;
- the sharded loop at world size 1 equals the unsharded loop bit for bit,
  the fits and the chunked gradient with a group of one equal those
  without (rtol 1e-12);
- the graphs of a group are forgotten before it goes, and a replay after it
  went raises; ``initialize_multihost`` binds an NCCL rank to its card
  (tests/test_torch_compiled.py holds the refusal of gloo on the card);
- the demo twin at a tiny K, alone and as two launched gloo ranks: the JAX
  demo's lines, no jax imported.
"""

import contextlib
import dataclasses
import os
import re
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
from ccv_mppi_path_tracker_tpu_torch.diff import (
    ControlGains,
    fit_control_gains,
    fit_full_body_params,
    rollout_prediction_value_and_grad,
)
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params, zmp_chain
from ccv_mppi_path_tracker_tpu_torch.parallel import (
    build_sharded_simulate,
    build_sharded_step,
    initialize_multihost,
    multihost,
    samples_group,
    shutdown_multihost,
)
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.runtime import simulate
from ccv_mppi_path_tracker_tpu_torch.solver import compile_step, mppi_step
from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph
from test_torch_solver import Case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "scripts", "torch_multihost_demo.py")
JAX_DEMO = os.path.join(REPO, "scripts", "multihost_demo.py")
K, T = 64, 10
U_OPT = dict(rtol=1e-12, atol=1e-14)
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_process_group():
    """A gloo group of this process alone, left on exit."""
    assert initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="gloo",
                                timeout_s=30)
    try:
        yield samples_group(device="cpu")[0]
    finally:
        shutdown_multihost()


# --- the compiled sharded step ----------------------------------------------------

@pytest.mark.parametrize("opts", [{}, {"elite_frac": 0.25}, {"adapt_sigma": True}],
                         ids=["vanilla", "elite", "adapt_sigma"])
def test_compiled_step_over_gloo_on_the_cpu_is_mppi_step_and_matches_jax(opts):
    """On the CPU the compiled step with a group runs ``mppi_step(group=...)``:
    bit-equal to it, and against JAX's single-device step on the same noise
    at f64 (u_opt rtol 1e-12 atol 1e-14, min_cost rtol 1e-12)."""
    case = Case(K, horizon=T)
    noise = torch.as_tensor(case.noise)
    ctrl = ControllerState(u_prev=case.tu, seed=0, step=0)
    state = torch.as_tensor(case.state)
    _, jres = case.jax(**opts)
    with one_process_group() as group:
        step = compile_step(case.cfg, group=group, **opts)
        _, a = step(ctrl, state, case.path, 0.1, case.sp, case.cp, model_params=case.mp,
                    noise=noise)
        _, b = mppi_step(case.cfg, ctrl, state, case.path, 0.1, case.sp, case.cp,
                         model_params=case.mp, noise=noise, group=group, **opts)
    assert torch.equal(a.u_opt, b.u_opt)
    assert a.stats.keys() == b.stats.keys()
    assert all(torch.equal(a.stats[n], b.stats[n]) for n in a.stats)
    np.testing.assert_allclose(a.u_opt.numpy(), np.asarray(jres.u_opt), **U_OPT)
    np.testing.assert_allclose(a.stats["min_cost"].numpy(), np.asarray(jres.stats["min_cost"]),
                               rtol=1e-12)


def test_the_capture_rule(monkeypatch):
    """NCCL's collectives can be captured, gloo's cannot, and no group has
    none to capture. The NCCL group is a stand-in: this machine has none."""
    assert not cuda_graph.collectives_capturable(None)
    with one_process_group() as group:
        assert not cuda_graph.collectives_capturable(group)
        assert not build_sharded_step(Case(K, horizon=T).cfg, group).compiled
    stand_in = types.SimpleNamespace(backend="nccl")
    monkeypatch.setattr(dist, "get_backend", lambda g: g.backend)
    assert cuda_graph.collectives_capturable(stand_in)
    assert cuda_graph.collectives_capturable(types.SimpleNamespace(backend="cpu:gloo,cuda:nccl"))
    assert not cuda_graph.collectives_capturable(types.SimpleNamespace(backend="gloo"))


def test_the_group_keys_the_graph_by_identity():
    """Two groups of one size and backend are two graphs; the same group is
    one; the graph's groups are found among the key's constants."""
    case = Case(K, horizon=T)
    ctrl = ControllerState(u_prev=case.tu, seed=0, step=0)
    args = (ctrl, torch.as_tensor(case.state), case.path, 0.1, case.sp, case.cp)
    with one_process_group():
        g1, g2 = dist.new_group([0]), dist.new_group([0])
        keys = [compile_step(case.cfg, group=g).cache_key(*args) for g in (g1, g2, g1)]
        assert keys[0] != keys[1]
        assert keys[0] == keys[2]
        assert cuda_graph._groups_in(keys[0]) == (g1,)
        assert cuda_graph._groups_in(compile_step(case.cfg).cache_key(*args)) == ()


def test_graphs_of_a_group_are_forgotten_and_a_dead_group_refuses_its_replay():
    """forget_group_graphs drops the graphs that hold a group (only those of
    the group named, or of any group); after the group went a replay
    raises before it launches anything."""
    graphed = cuda_graph.Graphed(lambda x: x)
    with one_process_group():
        g1, g2 = dist.new_group([0]), dist.new_group([0])
        graphed.graphs.update(a=types.SimpleNamespace(groups=(g1,)),
                              b=types.SimpleNamespace(groups=(g2,)),
                              c=types.SimpleNamespace(groups=()))
        assert cuda_graph.forget_group_graphs(g1) == 1
        assert set(graphed.graphs) == {"b", "c"}
        assert not cuda_graph._destroyed(g2)
    assert set(graphed.graphs) == {"c"}  # shutdown_multihost forgot g2's graph
    assert cuda_graph._destroyed(g2)
    dead = types.SimpleNamespace(groups=(g2,), graph=None, captured=[])
    with pytest.raises(RuntimeError, match="destroyed"):
        cuda_graph._Graph.replay(dead)


# --- the sharded loop and fits ------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "eager"])
def test_sharded_loop_of_one_equals_the_unsharded_loop(use_kernel):
    """build_sharded_simulate and simulate with the group among the options,
    at world size 1: the unsharded loop's logs and state, bit for bit."""
    cfg, sp, cp, course = PRESETS["full_body"](num_samples=96, horizon=10, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    start = torch.tensor([0.0, float(course[0, 1]), 0.0, 0.0, 0.0])
    dt = torch.tensor(0.1)
    ctrl0 = ControllerState.initial(3, cfg.horizon, 5, device="cpu")
    run = dict(num_steps=6, use_kernel=use_kernel)
    last, logs = simulate(cfg, ctrl0, start, path, dt, sp, cp, **run)
    with one_process_group() as group:
        sim = build_sharded_simulate(cfg, group, **run)
        assert not sim.compiled
        s_last, s_logs = sim(ctrl0, start, path, dt, sp, cp)
        o_last, o_logs = simulate(cfg, ctrl0, start, path, dt, sp, cp, **run,
                                  solver_options={"group": group})
    for other, other_last in ((s_logs, s_last), (o_logs, o_last)):
        assert other.keys() == logs.keys()
        for name in logs:
            assert torch.equal(other[name], logs[name]), name
        assert torch.equal(other_last.u_prev, last.u_prev)
        assert (other_last.seed, other_last.step) == (last.seed, last.step)


def _fit_data():
    """The unicycle transitions and full_body rollouts of the fits, f64."""
    f64 = torch.float64
    rng = np.random.RandomState(7)
    states = torch.as_tensor(rng.randn(64, 3))
    u = torch.as_tensor(rng.randn(64, 2))
    nxt = get_model("unicycle").step(states, u * torch.tensor([0.9, 1.2], dtype=f64), 0.1)
    zs = torch.as_tensor(rng.randn(8, 16, 5) * 0.1)
    zc = torch.as_tensor(rng.randn(7, 16, 5) * 0.1)
    return (states, u, nxt), (zs, zc)


def test_fits_with_a_group_of_one_equal_the_fits_without():
    """fit_control_gains, fit_full_body_params and the chunked gradient
    (num_chunks 1, 4, 8) with a gloo group of one against no group (rtol
    1e-12)."""
    (states, u, nxt), (zs, zc) = _fit_data()
    f64 = torch.float64
    true = default_params(device="cpu", dtype=f64)
    init = dataclasses.replace(true, base2com=torch.full((), 0.6, dtype=f64))
    observed = zmp_chain(zs, zc, 0.1, true)[..., 1]
    rng = np.random.RandomState(8)
    s0, ctl = torch.as_tensor(rng.randn(32, 3)), torch.as_tensor(rng.randn(6, 32, 2))
    obs = torch.as_tensor(rng.randn(6, 32, 3))
    gains = ControlGains(gains=torch.tensor([1.1, 0.9], dtype=f64))

    def run(group):
        g, gl = fit_control_gains("unicycle", states, u, nxt, 0.1, num_steps=20, group=group)
        z, zl = fit_full_body_params(zs, zc, observed, 0.1, init, num_steps=20, group=group)
        grads = [rollout_prediction_value_and_grad("unicycle", gains, s0, ctl, obs, 0.1,
                                                   num_chunks=c, group=group)
                 for c in (1, 4, 8)]
        return [g.gains, gl, z.mass, z.base2com, zl] + [t for lg in grads
                                                       for t in (lg[0], lg[1].gains)]

    alone = run(None)
    with one_process_group() as group:
        grouped = run(group)
    for a, b in zip(grouped, alone):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-300)


def test_an_nccl_rank_is_bound_to_its_card(monkeypatch):
    """Over NCCL initialize_multihost makes cuda:LOCAL_RANK (else cuda: the
    rank) the current device and hands it to init_process_group, which makes
    the communicator there; gloo binds nothing."""
    calls = []
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, device_id=None, **kw: calls.append(("init", device_id)))
    assert initialize_multihost("localhost:1", 4, 3, backend="nccl")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert initialize_multihost("localhost:1", 4, 3, backend="nccl")
    assert initialize_multihost("localhost:1", 4, 3, backend="gloo")
    cuda = torch.device
    assert calls == [("set", cuda("cuda", 3)), ("init", cuda("cuda", 3)),
                     ("set", cuda("cuda", 1)), ("init", cuda("cuda", 1)), ("init", None)]
    assert multihost.shutdown_multihost() is None  # no group up: nothing to leave


# --- the demo twin ------------------------------------------------------------------

def _demo(extra_env=None, rank_args=()):
    """The demo twin in a subprocess at a tiny size, on the CPU; it asserts,
    on its way out, that nothing imported jax."""
    code = ("import importlib.util, sys; "
            "spec = importlib.util.spec_from_file_location('demo', sys.argv[1]); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            "rc = m.main(sys.argv[2:]); "
            "assert not [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', "
            "'ccv_mppi_path_tracker_tpu.')) or n == 'ccv_mppi_path_tracker_tpu'], 'jax'; "
            "sys.exit(rc)")
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="1", **(extra_env or {}))
    return subprocess.Popen(
        [sys.executable, "-c", code, DEMO, "--device", "cpu", "--num-samples", "128",
         "--horizon", "10", "--steps", "4", *rank_args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)


def _jax_demo_patterns():
    """The JAX demo's two printed lines as regular expressions."""
    src = open(JAX_DEMO).read()
    assert 'f"distributed={distributed} processes={jax.process_count()} "' in src
    assert 'f"devices={len(devices)}"' in src
    assert '(incl. compile): RMSE={m[\'rmse\']:.3f} final={final[:2]}"' in src
    return (re.compile(r"^distributed=(True|False) processes=\d+ devices=\d+$", re.M),
            re.compile(r"^\d+ cycles at K=\d+ over \d+ devices in [\d.]+s \(incl\. "
                       r"compile\): RMSE=([\d.]+) final=\[.*\]$", re.M))


def test_demo_twin_alone_prints_the_jax_demos_lines():
    head, run = _jax_demo_patterns()
    proc = _demo()
    out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, out
    assert head.search(out).group(0) == "distributed=False processes=1 devices=1"
    m = run.search(out)
    assert m.group(0).startswith("4 cycles at K=128 over 1 devices")
    assert float(m.group(1)) < 0.15
    assert "compiled=False (gloo on cpu); captures a rank [0]" in out


def test_demo_twin_joins_a_launch_of_two_ranks():
    """Two ranks launched as torchrun launches them (the environment), over
    gloo on the CPU: rank 0 prints the lines, the K split in two."""
    head, run = _jax_demo_patterns()
    port = free_port()
    procs = [_demo({"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "2",
                    "RANK": str(r), "LOCAL_RANK": str(r)}) for r in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert head.search(outs[0]).group(0) == "distributed=True processes=2 devices=2"
    assert run.search(outs[0]).group(0).startswith("4 cycles at K=128 over 2 devices")
    assert not run.search(outs[1])
