"""Checkpoint/resume, the resume and course arguments of
run_tracking_experiment, the course generators and spline, the pure-pursuit
baseline and the command line of the port, on the CPU; and the entry
points' default device (the card: a call that names no device raises where
there is no CUDA).

- resume is bit-exact (tests/test_resume.py's 12 cycles split at 5);
- the courses and the spline equal the JAX package's exactly (the same
  NumPy code); pure pursuit matches JAX at float64 rtol 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu import paths as jax_paths
from ccv_mppi_path_tracker_tpu.runtime import loop as jax_loop
from ccv_mppi_path_tracker_tpu.runtime import pure_pursuit as jax_pp
from ccv_mppi_path_tracker_tpu_torch import cli, paths
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState, config, presets
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params
from ccv_mppi_path_tracker_tpu_torch.runtime import (
    load_checkpoint,
    loop,
    pure_pursuit,
    run_tracking_experiment,
    save_checkpoint,
)
from ccv_mppi_path_tracker_tpu_torch.runtime.sim_sensors import run_full_stack_experiment
from ccv_mppi_path_tracker_tpu_torch.solver import MPPISolver, init_fleet
from test_torch_realtime import one_torch_thread  # noqa: F401  (autouse: paced commands)

DT = 0.1
F64 = dict(rtol=1e-9, atol=1e-12)


def _run(solver, ctrl, state, path, sp, cp, n):
    model = get_model(solver.cfg.model)
    states = []
    for _ in range(n):
        ctrl, res = solver.step(ctrl, state, path, DT, sp, cp)
        state = model.step(state, res.u0, DT)
        states.append(state)
    return ctrl, state, torch.stack(states)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["eager", "kernel_plain"])
def test_resume_reproduces_the_uninterrupted_run(tmp_path, use_kernel):
    cfg, sp, cp, course = presets.diff_drive_launch(num_samples=128, horizon=10,
                                                    device="cpu")
    path = paths.PathBuffer.from_points(course, 0.1, device="cpu")
    state0 = torch.tensor([course[0, 0], course[0, 1], 0.0])
    solver = MPPISolver(cfg, use_kernel=use_kernel)
    _, _, full = _run(solver, solver.init(seed=7, device="cpu"), state0, path, sp, cp, 12)

    ctrl_a, state_a, first = _run(solver, solver.init(seed=7, device="cpu"), state0, path,
                                  sp, cp, 5)
    ck = tmp_path / "ck.npz"
    save_checkpoint(str(ck), cfg, ctrl_a, sp=sp, cp=cp)
    cfg_b, ctrl_b, params = load_checkpoint(str(ck), device="cpu")
    assert cfg_b == cfg and ctrl_b.seed == 7 and ctrl_b.step == 5
    _, _, rest = _run(MPPISolver(cfg_b, use_kernel=use_kernel), ctrl_b, state_a, path,
                      params["sp"], params["cp"], 7)
    np.testing.assert_array_equal(torch.cat([first, rest]).numpy(), full.numpy())


def test_checkpoint_round_trips_every_field(tmp_path):
    cfg, sp, cp = config.full_body_config(num_samples=64, horizon=6, steer_off=True,
                                          dtype=torch.float64, device="cpu")
    mp = default_params(device="cpu", dtype=torch.float64)
    ctrl = ControllerState(u_prev=torch.randn(5, 5, dtype=torch.float64), seed=3, step=41)
    ck = tmp_path / "ck.npz"
    save_checkpoint(str(ck), cfg, ctrl, sp=sp, cp=cp, mp=mp)
    cfg2, ctrl2, params = load_checkpoint(str(ck), device="cpu")
    assert cfg2 == cfg and (ctrl2.seed, ctrl2.step) == (3, 41)
    assert torch.equal(ctrl2.u_prev, ctrl.u_prev)
    for name, obj in (("sp", sp), ("cp", cp), ("mp", mp)):
        got = params[name]
        assert type(got) is type(obj)
        for f in dataclasses.fields(obj):
            a, b = getattr(got, f.name), getattr(obj, f.name)
            assert a.dtype == b.dtype and a.device.type == "cpu" and torch.equal(a, b)
    with pytest.raises(TypeError):
        save_checkpoint(str(ck), cfg, ctrl, course=np.zeros(3))


def test_checkpoint_refuses_a_jax_checkpoint(tmp_path):
    """A JAX package checkpoint carries a JAX PRNG key: not this port's."""
    from ccv_mppi_path_tracker_tpu.core import presets as jax_presets
    from ccv_mppi_path_tracker_tpu.runtime import save_checkpoint as jax_save
    from ccv_mppi_path_tracker_tpu.solver import MPPISolver as JaxSolver

    jcfg, jsp, jcp, _ = jax_presets.diff_drive_launch(num_samples=16, horizon=5)
    ck = tmp_path / "jax.npz"
    jax_save(str(ck), jcfg, JaxSolver(jcfg).init(0), sp=jsp, cp=jcp)
    with pytest.raises(ValueError, match="not a checkpoint of this port"):
        load_checkpoint(str(ck), device="cpu")


def test_run_tracking_experiment_resumes_from_ctrl_and_state0():
    cfg, sp, cp, course = presets.diff_drive_launch(num_samples=64, horizon=10,
                                                    device="cpu")
    full = run_tracking_experiment(cfg, sp, cp, course, num_steps=10, seed=2)
    a = run_tracking_experiment(cfg, sp, cp, course, num_steps=4, seed=2)
    b = run_tracking_experiment(cfg, sp, cp, course, num_steps=6, ctrl=a["ctrl"],
                                state0=a["logs"]["state"][-1])
    for key in ("state", "u0"):
        np.testing.assert_array_equal(np.concatenate([a["logs"][key], b["logs"][key]]),
                                      full["logs"][key])
    assert b["ctrl"].step == full["ctrl"].step == 10


def test_run_tracking_experiment_infers_the_resolution():
    cfg, sp, cp, _ = presets.diff_drive_launch(num_samples=64, horizon=10, device="cpu")
    course = paths.spline_resample_course(paths.dkan_course(resolution=0.5), 0.07)
    res = loop._infer_resolution(course)
    assert res == jax_loop._infer_resolution(course)
    np.testing.assert_allclose(res, 0.07, rtol=1e-3)
    inferred = run_tracking_experiment(cfg, sp, cp, course, num_steps=8, resolution=None)
    given = run_tracking_experiment(cfg, sp, cp, course, num_steps=8, resolution=res)
    np.testing.assert_array_equal(inferred["logs"]["state"], given["logs"]["state"])
    origin = run_tracking_experiment(cfg, sp, cp, course, num_steps=2,
                                     start_on_course=False)
    np.testing.assert_array_equal(origin["state0"], np.zeros(3))


_COURSES = {
    "sum_of_cosines": lambda m: m.sum_of_cosines_course(
        amplitudes=(1.0, 0.3, 0.1), frequencies=(0.25, 0.5, 0.05), resolution=0.1,
        course_length=12.0, init_x=1.0, init_y=-2.0),
    "circle": lambda m: m.circle_course(radius=5.0, resolution=0.2, init_x=1.0, turns=1.5),
    "circle_legacy_step": lambda m: m.circle_course(radius=0.7, resolution=0.1,
                                                    legacy_step=True),
    "waypoints": lambda m: m.waypoint_course(
        np.random.RandomState(0).uniform(-5.0, 5.0, (6, 2)), resolution=0.15),
    "dkan": lambda m: m.dkan_course(),
    "dkan_float32": lambda m: m.dkan_course(resolution=0.5, dtype=np.float32),
    "filtered_square": lambda m: m.filtered_square_course(length=5.0, amplitude=1.5),
    "spline_dkan": lambda m: m.spline_resample_course(m.dkan_course(resolution=0.5), 0.1),
    "spline_random": lambda m: m.spline_resample_course(
        np.cumsum(np.random.RandomState(1).uniform(0.2, 1.0, (9, 2)), axis=0), 0.05,
        dtype=np.float32),
}


@pytest.mark.parametrize("name", list(_COURSES))
def test_course_generators_equal_jax(name):
    got, ref = _COURSES[name](paths), _COURSES[name](jax_paths)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_cubic_spline_equals_jax():
    rng = np.random.RandomState(2)
    x = np.cumsum(rng.uniform(0.1, 1.0, 12))
    y = rng.randn(12)
    t = np.linspace(x[0] - 0.5, x[-1] + 0.5, 301)
    np.testing.assert_array_equal(paths.CubicSpline(x, y)(t),
                                  jax_paths.CubicSpline(x, y)(t))
    np.testing.assert_array_equal(paths.CubicSpline(x[:2], y[:2])(t),
                                  jax_paths.CubicSpline(x[:2], y[:2])(t))
    with pytest.raises(ValueError):
        paths.CubicSpline(x[::-1], y)


def _pp_course():
    return paths.sum_of_cosines_course(amplitudes=(1.0, 0, 0), frequencies=(0.25, 0, 0),
                                       deltas=(0, 0, 0), course_length=10.0)


def test_pure_pursuit_step_matches_jax():
    course = _pp_course()
    rng = np.random.RandomState(4)
    path = paths.PathBuffer.from_points(course, 0.1, dtype=torch.float64, device="cpu")
    jpath = jax_paths.PathBuffer.from_points(course, 0.1, dtype=np.float64)
    cfg, jcfg = pure_pursuit.PurePursuitConfig(), jax_pp.PurePursuitConfig()
    for i in range(12):
        state = np.array([rng.uniform(0, 10), rng.uniform(-2.5, 0.5), rng.uniform(-1, 1)])
        if i == 0:
            state[:2] = course[-1]  # nothing ahead: the last valid point
        got = pure_pursuit.pure_pursuit_step(cfg, torch.as_tensor(state), path)
        ref = jax_pp.pure_pursuit_step(jcfg, jnp.asarray(state), jpath)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)


def test_run_pure_pursuit_experiment_matches_jax():
    course = _pp_course()
    got = pure_pursuit.run_pure_pursuit_experiment(course, num_steps=60,
                                                   dtype=torch.float64, device="cpu")
    ref = jax_pp.run_pure_pursuit_experiment(course, num_steps=60, dtype=jnp.float64)
    for key in ("state", "u0"):
        np.testing.assert_allclose(got["logs"][key], ref["logs"][key], **F64)
    np.testing.assert_allclose(got["metrics"]["rmse"], ref["metrics"]["rmse"], **F64)
    assert got["metrics"]["rmse"] < 0.3


def _cli(argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out.splitlines()


def test_cli_realtime_prints_metrics_and_rate(tmp_path, capsys):
    rc, out = _cli(["realtime", "--device", "cpu", "--hz", "50", "--steps", "10",
                    "--num-samples", "64", "--record", str(tmp_path)], capsys)
    assert rc == 0
    assert [line.split(":")[0] for line in out[1:4]] == ["Time", "Max Error", "RMSE Error"]
    assert out[4].startswith("rate: 10 cycles, ") and "mean dt" in out[4]
    csv = tmp_path / "diff_drive_realtime.csv"
    assert out[5] == f"recorded: {csv}"
    assert len(csv.read_text().strip().split("\n")) == 11


def test_cli_realtime_pipelined(capsys):
    rc, out = _cli(["realtime", "--device", "cpu", "--hz", "100", "--steps", "12",
                    "--num-samples", "64", "--pipelined", "--micro-batch", "4"], capsys)
    assert rc == 0
    assert out[1].startswith("pipelined: micro_batch=4 fetch p95 ")
    assert out[-1].startswith("rate: 12 cycles, ")
    assert float(out[-2].split(": ")[1]) < 0.5


def test_cli_compare_prints_both_rmse_lines(capsys):
    rc, out = _cli(["compare", "--device", "cpu", "--steps", "40", "--num-samples", "128"],
                   capsys)
    assert rc == 0
    assert out[0].startswith("mppi: RMSE=") and out[1].startswith("pure_pursuit: RMSE=")
    assert all(float(line.split("RMSE=")[1].split()[0]) < 0.5 for line in out)


@pytest.mark.parametrize("kind", ["sin", "circle", "dkan", "square"])
def test_cli_course_writes_the_csv(kind, tmp_path, capsys):
    out_csv = tmp_path / "course.csv"
    rc, out = _cli(["course", "--kind", kind, "--out", str(out_csv), "--length", "5"],
                   capsys)
    pts = np.loadtxt(out_csv, delimiter=",", skiprows=1)
    assert rc == 0 and out == [f"{kind} course: {len(pts)} points -> {out_csv}"]
    assert out_csv.read_text().startswith("x,y\n") and pts.shape[1] == 2


def test_cli_run_records_saves_and_resumes(tmp_path, capsys):
    ck = tmp_path / "ck.npz"
    rc, out = _cli(["run", "--device", "cpu", "--steps", "12", "--num-samples", "128",
                    "--course", "dkan", "--record", str(tmp_path / "log"), "--save-ckpt",
                    str(ck)], capsys)
    assert rc == 0 and out[1] == f"checkpoint: {ck}"
    assert out[-1].startswith("recorded: ") and out[-2].startswith("RMSE Error: ")
    log = cli_log = out[-1].split(": ", 1)[1]
    from ccv_mppi_path_tracker_tpu_torch.metrics import read_log

    rows = read_log(log)
    assert rows["data"].shape == (12, 14)
    np.testing.assert_allclose(rows["course"], cli._course("dkan"), rtol=1e-6)
    assert cli_log.startswith(str(tmp_path / "log" / "diff_drive"))
    rc, out = _cli(["run", "--device", "cpu", "--steps", "5", "--num-samples", "128",
                    "--resume-ckpt", str(ck)], capsys)
    assert rc == 0 and out[0] == f"resumed from {ck} (cycle 12)"
    assert float(out[-1].split(": ")[1]) < 0.5
    rc, _ = _cli(["run", "--device", "cpu", "--steps", "1", "--preset", "full_body",
                  "--resume-ckpt", str(ck)], capsys)
    assert rc == 2


def _device_of(made):
    """The device of the first tensor in what a constructor made."""
    if isinstance(made, torch.Tensor):
        return made.device
    if isinstance(made, tuple):
        return _device_of(made[1])
    if isinstance(made, dict):
        return torch.device(made["device"])
    if dataclasses.is_dataclass(made):
        return _device_of(getattr(made, dataclasses.fields(made)[0].name))
    raise TypeError(type(made))


_CONSTRUCTORS = {
    **{name: (lambda fn: lambda **kw: fn(num_samples=8, horizon=4, **kw))(fn)
       for name, fn in presets.PRESETS.items()},
    **{name: (lambda fn: lambda **kw: fn(num_samples=8, horizon=4, **kw))(getattr(config, name))
       for name in ("diff_drive_config", "steering_diff_drive_config",
                    "rate_limited_steering_config", "full_body_config")},
    "make_solver_params": lambda **kw: config.make_solver_params(0.5, 1.0, [-1, -1], [1, 1],
                                                                 **kw),
    "make_cost_params": lambda **kw: config.make_cost_params(**kw),
    "PathBuffer.from_points": lambda **kw: paths.PathBuffer.from_points(_pp_course(), 0.1,
                                                                        **kw),
    "ControllerState.initial": lambda **kw: ControllerState.initial(0, 5, 2, **kw),
    "MPPISolver.init": lambda **kw: MPPISolver(config.SolverConfig(horizon=5)).init(0, **kw),
    "init_fleet": lambda **kw: init_fleet(config.SolverConfig(horizon=5), 3, **kw),
    "default_params": lambda **kw: default_params(**kw),
    "run_pure_pursuit_experiment": lambda **kw: {
        "device": pure_pursuit.run_pure_pursuit_experiment(_pp_course(), num_steps=1, **kw)
        and kw.get("device", "cuda")},
    "run_full_stack_experiment": lambda **kw: {
        "device": run_full_stack_experiment(cycles=1, num_samples=8, horizon=4, **kw)
        and kw.get("device", "cuda")},
}


@pytest.mark.parametrize("name", list(_CONSTRUCTORS))
def test_entry_points_default_to_the_card(name):
    """Asked for nothing, an entry point runs on the card: where there is no
    CUDA it raises torch's own error, and never falls back to the CPU."""
    make = _CONSTRUCTORS[name]
    assert _device_of(make(device="cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert _device_of(make()).type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    cfg, sp, cp = config.diff_drive_config(num_samples=8, horizon=4, device="cpu")
    ck = tmp_path / "ck.npz"
    save_checkpoint(str(ck), cfg, ControllerState.initial(0, 4, 2, device="cpu"), sp=sp)
    assert load_checkpoint(str(ck), device="cpu")[1].u_prev.device.type == "cpu"
    if torch.cuda.is_available():
        assert load_checkpoint(str(ck))[2]["sp"].lam.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            load_checkpoint(str(ck))
