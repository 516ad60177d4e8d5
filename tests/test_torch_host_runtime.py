"""The port's host runtime against the JAX package's: the input gate, the
CSV recorder's file, the native library (built with g++ under build/, never
in native/), its scheduler, ring and recorder, and the C++ oracle, which
the port's eager control step matches at float64.

Tolerances: the recorder's file and native_oracle_step are identical to the
JAX package's; the eager step against the C++ oracle at rtol 1e-9 atol 1e-12
(the port's tolerance against the NumPy oracle, tests/test_torch_solver.py).
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import config as jax_config
from ccv_mppi_path_tracker_tpu.metrics import recorder as jax_recorder
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.runtime import native as jax_native
from ccv_mppi_path_tracker_tpu.solver.command import WheelSteerCommand as JaxCommand
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, SolverConfig
from ccv_mppi_path_tracker_tpu_torch.metrics import recorder
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, sum_of_cosines_course
from ccv_mppi_path_tracker_tpu_torch.runtime import native
from ccv_mppi_path_tracker_tpu_torch.runtime.gating import InputGate
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step
from ccv_mppi_path_tracker_tpu_torch.solver.command import WheelSteerCommand
from test_torch_realtime import _overloaded

ROOT = Path(__file__).resolve().parents[1]
F64 = dict(rtol=1e-9, atol=1e-12)

# model -> (JAX config of its node, start state)
MODELS = {
    "unicycle": (jax_config.diff_drive_config, [0.0, -0.1, 0.15]),
    "steering_unicycle": (jax_config.steering_diff_drive_config, [0.0, -0.1, 0.15]),
    "rate_limited_steering": (jax_config.rate_limited_steering_config,
                              [0.0, -0.1, 0.15, 0.1]),
    "full_body": (jax_config.full_body_config, [0.0, -0.1, 0.15, 0.02, -0.03]),
}


def test_input_gate_readiness_and_staleness():
    g = InputGate(stale_policy="hold")
    g.add_channel("path", max_age=1.0)
    g.add_channel("pose", max_age=0.1)
    assert not g.ready()
    g.update("path", "P", stamp=100.0)
    g.update("pose", torch.tensor([1.0, 2.0]), stamp=100.0)
    assert g.ready()
    assert g.stale(now=100.05) == {}
    stale = g.stale(now=100.5)
    assert "pose" in stale and "path" not in stale
    assert torch.equal(g.get("pose"), torch.tensor([1.0, 2.0]))
    with pytest.raises(ValueError):
        InputGate(stale_policy="coast")


def _command(value):
    return WheelSteerCommand(*(torch.full((), value + i) for i in range(7)))


@pytest.mark.parametrize("policy", ["hold", "zero"])
def test_input_gate_stale_policies(policy):
    g = InputGate(stale_policy=policy)
    g.add_channel("pose", max_age=0.1)
    g.update("pose", 1.0, stamp=0.0)
    fresh, last = _command(1.0), _command(0.5)
    assert g.resolve_command(fresh, last, now=0.05) is fresh
    assert g.stale_cycles == 0
    got = g.resolve_command(fresh, last, now=5.0)
    assert g.stale_cycles == 1
    if policy == "hold":
        assert got is last
    else:
        assert isinstance(got, WheelSteerCommand)
        assert all(float(getattr(got, f)) == 0.0 for f in vars(got))
        np.testing.assert_array_equal(
            g.resolve_command(np.ones(2), np.array([0.5, 0.5]), now=5.0), np.zeros(2))
        assert torch.equal(g.resolve_command(torch.ones(3), torch.ones(3), now=5.0),
                           torch.zeros(3))


def _rows(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [(0.1 * i, rng.randn(5), rng.randn(7), rng.randn()) for i in range(n)]


def test_recorder_file_matches_jax(tmp_path):
    """The same cycles through both recorders give the same file (but for
    the time-stamped name), and read_log reads it back the same."""
    course = sum_of_cosines_course(course_length=2.0)
    files = []
    for rec_mod, cmd_cls, to in ((jax_recorder, JaxCommand, np.asarray),
                                 (recorder, WheelSteerCommand, torch.as_tensor)):
        rec = rec_mod.Recorder(str(tmp_path / cmd_cls.__module__), method="mppi",
                               stamp="run")
        for t, state, c, zmp in _rows():
            cmd = cmd_cls(*(to(x) for x in c))
            rec.write_cycle(t, to(state), cmd, true_zmp=zmp, zmp_y=-zmp)
            rec.write_cycle(t, to(state), cmd, true_v=float(c[0]) * 2)
        rec.write_row([1.5] + [2.5, ""] * 7 + [3.5])
        rec.close(course)
        files.append(Path(rec.path))
    assert files[1].name == "run.csv" and files[1].parent.name == "mppi"
    assert files[0].read_text() == files[1].read_text()
    assert recorder.COLUMNS == jax_recorder.COLUMNS
    assert recorder.DEBUG_COLUMNS == jax_recorder.DEBUG_COLUMNS
    assert recorder.FULL_BODY_DEBUG_COLUMNS == jax_recorder.FULL_BODY_DEBUG_COLUMNS
    got, ref = recorder.read_log(str(files[1])), jax_recorder.read_log(str(files[0]))
    assert got["header"] == ref["header"] == recorder.COLUMNS[:14]
    np.testing.assert_array_equal(got["data"], ref["data"])
    np.testing.assert_array_equal(got["course"], ref["course"])
    assert got["data"].shape == (15, 14)
    np.testing.assert_allclose(got["course"], course)


def test_recorder_read_log_without_course(tmp_path):
    rec = recorder.Recorder(str(tmp_path), stamp="short")
    rec.write_cycle(0.0, torch.zeros(3), _command(0.0))
    rec.close()
    log = recorder.read_log(rec.path)
    assert log["course"] is None and log["data"].shape == (1, 14)


def _native_listing():
    """native/'s files and mtimes, but for the JAX package's own library,
    which the JAX package's tests build there."""
    return {p.name: p.stat().st_mtime_ns for p in (ROOT / "native").iterdir()
            if p.name != "libccv_runtime.so"}


def test_library_builds_under_build_and_never_in_native(tmp_path):
    before = _native_listing()
    path, seconds = native.build(tmp_path / "fresh")
    assert seconds > 0.0 and path.exists() and path.parent == tmp_path / "fresh"
    assert path == native.library_path(tmp_path / "fresh")
    assert native.build(tmp_path / "fresh") == (path, 0.0)  # reused, not rebuilt
    default = native.library_path()
    assert default.parent == ROOT / "build" / "host_runtime"
    assert default.name.startswith("libccv_runtime_") and default.suffix == ".so"
    assert native.SOURCE == ROOT / "ccv_mppi_path_tracker_tpu_torch" / "csrc" / "ccv_runtime.cpp"
    assert native.load_library() is native.load_library()
    assert _native_listing() == before
    assert not [p for p in (ROOT / "native").iterdir() if p.name.startswith("libccv_runtime_")]


def test_rate_executor_accounting_is_self_consistent():
    r = native.RateExecutor(200.0)  # 5 ms period
    t0 = time.perf_counter()
    dts = [r.sleep() for _ in range(50)]
    wall = time.perf_counter() - t0
    s = r.stats()
    assert s["cycles"] == 50
    assert all(dt >= 0.0 for dt in dts)
    np.testing.assert_allclose(s["mean_dt"] * 50, wall, rtol=0.2)
    assert s["mean_dt"] >= 0.005 * 0.99  # never faster than the period


def test_rate_executor_holds_rate_or_accounts_for_misses():
    """tests/test_native.py's contract: the mean period is held, or the
    deviation is explained by counted deadline misses."""
    for _ in range(4):
        r = native.RateExecutor(200.0)
        [r.sleep() for _ in range(50)]
        s = r.stats()
        assert s["cycles"] == 50 and s["mean_dt"] >= 0.005 * 0.99, s
        held = abs(s["mean_dt"] - 0.005) < 0.001
        assert held or s["deadline_misses"] > 0, f"drift without accounted misses: {s}"
        if held or _overloaded():
            return
    raise AssertionError(f"rate not held on a quiet box: {s}")


def test_spsc_ring_latest_wins():
    q = native.SpscRing(capacity=4, record_len=3)
    assert q.latest() == (None, None)
    assert q.pop() is None
    for i in range(10):
        q.push([i, i * 2.0, i * 3.0])
    seq, rec = q.latest()
    assert seq == 9
    np.testing.assert_array_equal(rec, [9, 18, 27])
    first = q.pop()  # the oldest record the capacity kept
    assert first is not None and first[0] == 6.0
    assert len(q) == 3
    with pytest.raises(ValueError):
        q.push([1.0, 2.0])


def test_native_csv_recorder(tmp_path):
    p = tmp_path / "out.csv"
    rec = native.NativeCsvRecorder(str(p), ["a", "b", "c"])
    for i in range(100):
        rec.row([i, i * 0.5, np.nan])
    rec.close()
    rec.close()  # a second close does nothing
    lines = p.read_text().strip().split("\n")
    assert lines[0] == "a,b,c"
    assert len(lines) == 101
    assert lines[1] == "0,0,"  # NaN -> empty cell
    assert lines[100].startswith("99,49.5,")
    with pytest.raises(OSError):
        native.NativeCsvRecorder(str(tmp_path / "missing" / "x.csv"), ["a"])


def _oracle_case(model, seed=0, k=32, t=10):
    """A control-step problem in both packages: the JAX config at float64
    and its port parameters."""
    config, state = MODELS[model]
    rng = np.random.RandomState(seed)
    jcfg, jsp, jcp = config(num_samples=k, horizon=t, dtype=np.float64)
    u_dim = np.asarray(jsp.u_min).shape[0]
    course = sum_of_cosines_course(amplitudes=(1.0, 0.3, 0.0), frequencies=(0.25, 0.5, 0.0),
                                   course_length=12.0)
    jmp = jax_default_params(np.float64) if model == "full_body" else None
    return dict(jcfg=jcfg, jsp=jsp, jcp=jcp, jmp=jmp, course=course,
                u_prev=rng.randn(t - 1, u_dim) * 0.1, state=np.array(state),
                noise=rng.randn(t - 1, k, u_dim))


def _oracle(mod, c, cp, mp, steer_off=False):
    return mod.native_oracle_step(
        c["jcfg"].model, c["u_prev"], c["state"], c["course"], 0.1, 0.1, c["noise"],
        control_noise=0.5, lam=1.0, u_min=np.asarray(c["jsp"].u_min),
        u_max=np.asarray(c["jsp"].u_max), v_ref=float(np.asarray(c["jcp"].v_ref)), cp=cp,
        model_params=mp, steer_off=steer_off)


@pytest.mark.parametrize("model", list(MODELS))
def test_native_oracle_step_equals_jax_bit_for_bit(model):
    c = _oracle_case(model)
    sp, cp, mp, _, _ = from_numpy(c["jsp"], c["jcp"], c["jmp"], c["u_prev"],
                                  {"xy": c["course"], "num_valid": len(c["course"]),
                                   "resolution": 0.1}, dtype=torch.float64)
    for steer_off in (False, True):
        got = _oracle(native, c, cp, mp, steer_off)
        ref = _oracle(jax_native, c, c["jcp"], c["jmp"], steer_off)
        np.testing.assert_array_equal(got["costs"], ref["costs"])
        np.testing.assert_array_equal(got["u_opt"], ref["u_opt"])


@pytest.mark.parametrize("model", list(MODELS))
def test_eager_step_matches_cpp_oracle(model):
    """tests/test_native.py holds the C++ oracle to the NumPy oracle; here the
    port's eager mppi_step, float64 with the same injected noise."""
    c = _oracle_case(model, seed=3)
    ora = _oracle(native, c, c["jcp"], c["jmp"])
    path = PathBuffer.from_points(c["course"], 0.1, dtype=torch.float64, device="cpu")
    sp, cp, mp, u_prev, _ = from_numpy(c["jsp"], c["jcp"], c["jmp"], c["u_prev"],
                                       {"xy": c["course"], "num_valid": len(c["course"]),
                                        "resolution": 0.1}, dtype=torch.float64)
    cfg = SolverConfig(model=model, num_samples=32, horizon=10)
    _, res = mppi_step(cfg, ControllerState(u_prev, 0, 0), torch.as_tensor(c["state"]),
                       path, 0.1, sp, cp, model_params=mp, noise=torch.as_tensor(c["noise"]))
    np.testing.assert_allclose(res.u_opt.numpy(), ora["u_opt"], **F64)
    np.testing.assert_allclose(res.stats["min_cost"].numpy(), ora["costs"].min(), **F64)


def test_cpp_oracle_bench_runs():
    rng = np.random.RandomState(1)
    t, k = 15, 256
    ns = native.native_oracle_bench_ns(
        "unicycle", np.zeros((t - 1, 2)), np.zeros(3), sum_of_cosines_course(), 0.1, 0.1,
        rng.randn(t - 1, k, 2), 0.5, 1.0, [-1.2, -2.0], [1.2, 2.0], 0.8, iters=3)
    assert ns > 0
