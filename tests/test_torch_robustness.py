"""Endurance and robustness of the port on the CPU, the twins of
``tests/test_robustness.py``: a 500-cycle run, wall-clock dt jitter through
ControlLoop with one compiled graph key, the course end, the dkan corridor."""

import numpy as np
import torch

from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, sum_of_cosines_course
from ccv_mppi_path_tracker_tpu_torch.paths.courses import dkan_course
from ccv_mppi_path_tracker_tpu_torch.paths.spline import spline_resample_course
from ccv_mppi_path_tracker_tpu_torch.runtime import ControlLoop, run_tracking_experiment
from test_torch_realtime import one_torch_thread  # noqa: F401  (autouse)


def _launch():
    return diff_drive_launch(num_samples=256, device="cpu")


def test_long_run_stays_bounded():
    """500 cycles: no NaN drift, the box held, tracking kept, most of the
    course covered."""
    cfg, sp, cp, _ = _launch()
    long_course = sum_of_cosines_course(
        amplitudes=(1.0, 0, 0), frequencies=(0.25, 0, 0), deltas=(0, 0, 0),
        resolution=0.1, course_length=60.0, dtype=np.float32,
    )
    out = run_tracking_experiment(cfg, sp, cp, long_course, num_steps=500)
    logs = out["logs"]
    assert np.isfinite(logs["state"]).all()
    assert np.isfinite(logs["u0"]).all()
    assert np.abs(logs["u0"][:, 0]).max() <= float(sp.u_max[0]) + 1e-5
    assert out["metrics"]["rmse"] < 0.15, out["metrics"]
    assert logs["state"][-1, 0] > 30.0


class _KeySpy:
    """A compiled step that records the graph key of every call."""

    def __init__(self, step):
        self.step, self.keys = step, []

    def __call__(self, *args, **kwargs):
        self.keys.append(self.step.cache_key(*args, **kwargs))
        return self.step(*args, **kwargs)


def test_dt_jitter_keeps_one_graph_key_and_tracks():
    """Wall-clock dt jitter (src/diff_drive_mppi.cpp:346-348) reaches the
    compiled step as a tensor input: one graph key for every dt, so on the
    card one capture; and the loop tracks."""
    cfg, sp, cp, course = _launch()
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path)
    loop.compiled = spy = _KeySpy(loop.compiled)
    plant = get_model(cfg.model)
    rng = np.random.RandomState(0)
    state = torch.tensor([course[0, 0], course[0, 1], 0.0])
    traj = [state.numpy()]
    dts = []
    for _ in range(80):
        dt = float(rng.uniform(0.08, 0.12))
        dts.append(dt)
        res = loop.step(state, dt=dt)
        state = plant.step(state, res.u0, torch.tensor(dt))
        traj.append(state.numpy())
    assert len(set(dts)) == 80 and len(spy.keys) == 80
    assert len(set(spy.keys)) == 1
    m = tracking_metrics(np.stack(traj)[:, :2], course)
    assert m["rmse"] < 0.2, m


def test_course_end_behavior():
    """Past the course end the reference window collapses to the last
    point: the controller slows toward it rather than diverging."""
    cfg, sp, cp, course = _launch()
    short = course[:40]  # 4 m course
    out = run_tracking_experiment(cfg, sp, cp, short, num_steps=120)
    logs = out["logs"]
    assert np.isfinite(logs["state"]).all()
    final_dist = np.hypot(*(logs["state"][-1, :2] - short[-1]))
    assert final_dist < 1.0, final_dist


def test_dkan_corridor_tracking():
    """The building corridor (launch/dkan_diff_drive_mppi.launch), raw with
    its 90-degree corners and smoothed by the cubic spline."""
    cfg, sp, cp, _ = _launch()
    course = dkan_course(resolution=0.1).astype(np.float32)
    out = run_tracking_experiment(cfg, sp, cp, course, num_steps=200)
    assert out["metrics"]["max_error"] < 0.6, out["metrics"]
    assert out["logs"]["state"][-1, 0] > 15.0

    smooth = spline_resample_course(
        [[0.0, 0.0], [8.0, 0.0], [17.7, 0.0], [17.7, 4.0], [17.7, 8.0],
         [9.0, 8.0], [0.0, 8.0]], resolution=0.1,
    ).astype(np.float32)
    out2 = run_tracking_experiment(cfg, sp, cp, smooth, num_steps=200)
    assert out2["metrics"]["rmse"] < 0.2, out2["metrics"]
