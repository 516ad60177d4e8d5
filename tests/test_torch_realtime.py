"""The port's serving loops (runtime/realtime.py) on the CPU: the host plant
against the JAX package's bit for bit, the paced loop with its recorder and
rate contract (tests/test_native.py's, with its tolerance of load), and the
pipelined loop's lag compensation and update count. On CPU tensors the
control update runs the kernel's plain version."""

import os

import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.runtime.realtime import _plant_step_np as jax_plant_step_np
from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import fused_sample_rollout_cost
from ccv_mppi_path_tracker_tpu_torch.runtime import realtime

STATES = {"unicycle": 3, "steering_unicycle": 3, "full_body": 5,
          "rate_limited_steering": 4}
CONTROLS = {"unicycle": 2, "steering_unicycle": 3, "full_body": 5,
            "rate_limited_steering": 3}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The paced loops hold wall-clock deadlines. Under the suite's parallel
    workers, torch's intra-op threads (one per core in every worker)
    oversubscribe the cores and stall single cycles by seconds; one thread a
    worker keeps the small CPU updates on time. The other serving-path test
    files import it for their small closed loops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _overloaded(threshold: float = 1.5) -> bool:
    """True when the box is too loaded for a wall-clock bound to mean
    anything (1-min load average per core above ``threshold``), as in
    tests/test_native.py."""
    try:
        return os.getloadavg()[0] / (os.cpu_count() or 1) > threshold
    except OSError:
        return False


@pytest.mark.parametrize("model", list(STATES))
def test_plant_step_np_equals_jax(model):
    rng = np.random.RandomState(3)
    s = rng.randn(STATES[model]) * 0.3
    for _ in range(20):
        u = rng.randn(CONTROLS[model]).astype(np.float32)
        dt = float(rng.uniform(0.01, 0.1))
        got = realtime._plant_step_np(model, s, u, dt)
        np.testing.assert_array_equal(got, jax_plant_step_np(model, s, u, dt))
        s = got


def test_plant_step_np_refuses_an_unknown_model():
    with pytest.raises(ValueError, match="built-in model families"):
        realtime._plant_step_np("my_custom_model", np.zeros(3), np.zeros(2), 0.1)


def test_realtime_experiment_holds_rate_and_tracks(tmp_path):
    """RateExecutor + InputGate + the update + the native CSV recorder at
    50 Hz, with the rate contract of tests/test_native.py."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=128, device="cpu")
    rec = tmp_path / "rt.csv"
    before = fused_sample_rollout_cost.launches
    out = realtime.run_realtime_experiment(cfg, sp, cp, course, hz=50.0, num_cycles=60,
                                           record_path=str(rec), use_kernel=True)
    assert fused_sample_rollout_cost.launches == before  # CPU: the plain version
    lines = rec.read_text().strip().split("\n")
    assert len(lines) == 61 and lines[0].startswith("time,x,y,omega")
    row = np.array(lines[-1].split(",")[:12], np.float64)
    np.testing.assert_allclose(row[[1, 2]], out["logs"]["state"][-1, :2], rtol=1e-6)
    assert out["logs"]["state"].shape == (61, 3)
    rs = out["rate_stats"]
    assert rs["cycles"] == 60
    assert out["metrics"]["rmse"] < 0.5
    assert out["stale_cycles"] <= 3, out["stale_cycles"]
    assert out["invalid_steer_cycles"] == 0  # the unicycle never steers
    assert rs["mean_dt"] >= 0.02 * 0.99  # never faster than the period
    for _ in range(3):
        held = abs(rs["mean_dt"] - 0.02) < 0.006
        assert held or rs["deadline_misses"] > 0, f"drift without accounted misses: {rs}"
        if held or _overloaded():
            return
        rs = realtime.run_realtime_experiment(cfg, sp, cp, course, hz=50.0,
                                              num_cycles=60)["rate_stats"]
    assert abs(rs["mean_dt"] - 0.02) < 0.006, rs


def test_pipelined_micro_batch_compensation_beats_uncompensated():
    """micro_batch=8: predicting the plant across the 8-cycle window beats
    dispatching the next window from the window-start state. At 25 Hz the
    window is 0.32 s, whose lag the compensation removes by a margin that
    the sampling noise of K=512 does not reach (at 50 Hz and K=256 some
    seeds invert it)."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=512, device="cpu")
    out = {comp: realtime.run_pipelined_experiment(
        cfg, sp, cp, course, hz=25.0, num_cycles=40, micro_batch=8,
        delay_compensation=comp) for comp in (True, False)}
    assert out[True]["rate_stats"]["cycles"] == 40
    assert out[True]["feedback_latency_cycles"] == 8
    assert out[True]["metrics"]["rmse"] < 0.5
    assert out[True]["metrics"]["rmse"] < out[False]["metrics"]["rmse"], (
        out[True]["metrics"]["rmse"], out[False]["metrics"]["rmse"])
    for key in ("fetch_ms", "dispatch_ms"):
        ms = out[True][key]
        assert sorted(ms) == ["max", "mean", "p95"] and 0 <= ms["mean"] <= ms["max"]
    assert out[True]["logs"]["state"].shape == (41, 3)


@pytest.mark.parametrize("micro_batch", [1, 4])
def test_pipelined_runs_the_cycles_plus_the_warm_up_window(micro_batch, monkeypatch):
    """One update a cycle and the warm-up window's, none dispatched after the
    last window; micro_batch=1 plans with the one-period delay."""
    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("delay"))
        return step(*args, **kw)

    step = realtime.mppi_step
    monkeypatch.setattr(realtime, "mppi_step", counted)
    cfg, sp, cp, course = diff_drive_launch(num_samples=64, device="cpu")
    out = realtime.run_pipelined_experiment(cfg, sp, cp, course, hz=100.0, num_cycles=18,
                                            micro_batch=micro_batch)
    cycles = (18 // micro_batch) * micro_batch
    assert out["rate_stats"]["cycles"] == cycles
    assert len(calls) == cycles + micro_batch
    assert set(calls) == ({0.01} if micro_batch == 1 else {None})
    assert out["metrics"]["rmse"] < 0.5
    with pytest.raises(ValueError):
        realtime.run_pipelined_experiment(cfg, sp, cp, course, micro_batch=0)


def test_pipelined_fetch_copies_once_into_a_host_buffer():
    fetch = realtime._Fetch((2, 3), torch.device("cpu"))
    assert not fetch.cuda and fetch.event is None
    u = torch.arange(6.0).view(2, 3)
    fetch.start(u)
    got = fetch.wait()
    u += 1.0  # the fetched window is the host's own copy
    np.testing.assert_array_equal(got, np.arange(6.0).reshape(2, 3))
