"""The port's figures and animation (metrics/plots.py, metrics/animate.py),
what feeds them (``mppi_step(debug_candidates=M)``, ``simulate(with_paths=True)``)
and the command-line flags that draw them, against the JAX package:

- candidates, planned paths and reference windows at float64 under injected
  noise, rtol 1e-9 atol 1e-12 (tests/test_solver_parity.py's);
- ``path_yaw``, ``feasible_region_points`` and ``curvature`` equal to JAX's;
- the twins of tests/test_cli_and_plots.py:20, :87-155, :223-275: the files
  are written.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.metrics import plots as jplots
from ccv_mppi_path_tracker_tpu.metrics.tracking import curvature as jax_curvature
from ccv_mppi_path_tracker_tpu.runtime.loop import build_simulate_scan
from ccv_mppi_path_tracker_tpu_torch import cli
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
from ccv_mppi_path_tracker_tpu_torch.core.presets import (
    diff_drive_launch,
    full_body_launch,
    steering_launch,
)
from ccv_mppi_path_tracker_tpu_torch.metrics import plots
from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import curvature
from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment, simulate
from test_torch_solver import Case

F64 = dict(rtol=1e-9, atol=1e-12)


def close(port, ref, tol=F64):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


@pytest.mark.parametrize("model", ["full_body", "unicycle"])
def test_debug_candidates_match_jax(model):
    case = Case(64, model=model)
    _, jres = case.jax(debug_candidates=16)
    _, res = case.port(debug_candidates=16)
    assert res.stats["candidates"].shape == (16, case.horizon, 2)
    close(res.stats["candidates"], jres.stats["candidates"])
    with pytest.raises(ValueError, match="lean"):
        case.port(debug_candidates=4, lean=True)


@pytest.mark.parametrize("model", ["full_body", "unicycle"])
def test_with_paths_matches_jax(model):
    """Five closed-loop cycles under the same injected noise: the states,
    the planned paths, the reference windows and the candidates."""
    case = Case(64, model=model, horizon=10)
    n = 5
    jsim = build_simulate_scan(
        case.jcfg, num_steps=n, with_paths=True,
        solver_options={"noise": jnp.asarray(case.noise), "debug_candidates": 8})
    jctrl = JaxControllerState(u_prev=jnp.asarray(case.u_prev), key=jax.random.PRNGKey(0),
                               step=jnp.zeros((), jnp.int32))
    _, jlogs = jsim(jctrl, jnp.asarray(case.state), case.jpath, jnp.float64(0.1), case.jsp,
                    case.jcp, case.jmp)
    _, logs = simulate(
        case.cfg, ControllerState(u_prev=case.tu, seed=0, step=0),
        torch.as_tensor(case.state), case.path, torch.tensor(0.1, dtype=torch.float64),
        case.sp, case.cp, model_params=case.mp, num_steps=n, with_paths=True,
        solver_options={"noise": torch.as_tensor(case.noise), "debug_candidates": 8})
    assert logs["opt_xy"].shape == (n, 10, 2) and logs["candidates"].shape == (n, 8, 10, 2)
    for key in ("state", "u0", "opt_xy", "ref_xy", "candidates", "min_cost"):
        close(logs[key], jlogs[key])


def test_cli_run_records_and_plots(tmp_path, capsys):
    rec_dir = str(tmp_path / "log")
    fig = str(tmp_path / "fig.png")
    rc = cli.main(["run", "--device", "cpu", "--preset", "diff_drive", "--steps", "40",
                   "--num-samples", "128", "--record", rec_dir, "--plot", fig])
    assert rc == 0
    out = capsys.readouterr().out
    assert "RMSE Error:" in out and "Max Error:" in out and f"figure: {fig}" in out
    assert os.path.getsize(fig) > 1000
    csvs = [os.path.join(dp, f) for dp, _, fs in os.walk(rec_dir) for f in fs
            if f.endswith(".csv")]
    assert len(csvs) == 1
    assert open(csvs[0]).readline().strip().split(",")[:3] == ["time", "x", "y"]


def test_cli_path_selection(capsys):
    """auto by default (eager for CPU tensors), --kernel and --no-kernel
    force, both together are a usage error."""
    argv = ["run", "--device", "cpu", "--steps", "2", "--num-samples", "128"]
    assert cli.main(argv) == 0
    assert "solver path: eager (auto) on cpu" in capsys.readouterr().out
    assert cli.main(argv + ["--kernel"]) == 0
    assert "solver path: fused kernel on cpu\n" in capsys.readouterr().out
    assert cli.main(argv + ["--no-kernel"]) == 0
    assert "solver path: eager on cpu\n" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(argv + ["--kernel", "--no-kernel"])


def test_feasible_region_geometry_matches_jax():
    no_steer, steer = plots.feasible_region_points(n=15)
    j_no, j_steer = jplots.feasible_region_points(n=15)
    np.testing.assert_array_equal(no_steer, j_no)
    np.testing.assert_array_equal(steer, j_steer)
    assert np.max(np.abs(no_steer[:, 1])) <= 2 * 3.0 / 0.5 + 1e-9
    assert np.max(np.abs(steer[:, 1])) > np.max(np.abs(no_steer[:, 1]))


def test_plot_feasible_region_renders(tmp_path):
    out = str(tmp_path / "region.png")
    plots.plot_feasible_region(out=out, n=10)
    assert os.path.getsize(out) > 1000


def test_plot_square_analysis_and_solver_debug(tmp_path):
    out1 = str(tmp_path / "sq.png")
    plots.plot_filtered_square_analysis(out=out1)
    assert os.path.getsize(out1) > 1000
    case = Case(64, f64=False, horizon=10, model="unicycle")
    _, res = case.port(debug_candidates=16)
    out2 = str(tmp_path / "dbg.png")
    plots.plot_solver_debug(res, course=case.course, out=out2)
    assert os.path.getsize(out2) > 1000


def test_path_yaw_matches_graph3_loop_and_jax():
    rng = np.random.RandomState(0)
    c = np.cumsum(rng.rand(20, 2) * 0.3 + 0.05, axis=0)
    expected = []
    for i in range(len(c)):
        j0, j1 = max(i - 1, 0), min(i + 1, len(c) - 1)
        expected.append(np.arctan2(c[j1, 1] - c[j0, 1], c[j1, 0] - c[j0, 0]))
    np.testing.assert_allclose(plots.path_yaw(c), expected, rtol=1e-12)
    np.testing.assert_array_equal(plots.path_yaw(c), jplots.path_yaw(c))


def test_curvature_matches_jax(tmp_path):
    case = Case(8, horizon=4)
    np.testing.assert_array_equal(curvature(case.course), jax_curvature(case.course))
    out = str(tmp_path / "curv.png")
    plots.plot_course_curvature(case.course, out=out)
    assert os.path.getsize(out) > 1000


def test_cli_plot_yaw(tmp_path):
    fig = str(tmp_path / "yaw.png")
    rc = cli.main(["run", "--device", "cpu", "--preset", "diff_drive", "--steps", "30",
                   "--num-samples", "64", "--plot-yaw", fig])
    assert rc == 0
    assert os.path.getsize(fig) > 1000


def test_cli_run_animate(tmp_path, capsys):
    out = str(tmp_path / "run.html")
    rc = cli.main(["run", "--device", "cpu", "--preset", "diff_drive", "--steps", "12",
                   "--num-samples", "64", "--animate", out, "--animate-candidates", "6"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "solver path: eager (auto) on cpu" in text and "(12 frames)" in text
    html = open(out).read()
    assert "animation" in html.lower() and len(html) > 10_000


def test_compare_plot(tmp_path, capsys):
    fig = str(tmp_path / "cmp.png")
    rc = cli.main(["compare", "--device", "cpu", "--steps", "30", "--num-samples", "64",
                   "--plot", fig])
    assert rc == 0
    assert f"wrote comparison figure {fig}" in capsys.readouterr().out
    assert os.path.getsize(fig) > 1000


def test_comparison_overlay_plots(tmp_path):
    """Two-run overlays (the reference's graph2.py:37-41 / zmp_graph2.py):
    steered and unsteered runs of different lengths, controlled and
    uncontrolled full-body runs."""
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params

    scfg, ssp, scp, course = steering_launch(num_samples=64, horizon=8, device="cpu")
    steered = run_tracking_experiment(scfg, ssp, scp, course, num_steps=25)
    dcfg, dsp, dcp, _ = diff_drive_launch(num_samples=64, horizon=8, device="cpu")
    unsteered = run_tracking_experiment(dcfg, dsp, dcp, course, num_steps=30)
    f1 = plots.plot_tracking_comparison(
        {"With Steering Robot": steered, "Without Steering Robot": unsteered},
        out=str(tmp_path / "cmp.png"))
    assert (tmp_path / "cmp.png").exists() and len(f1.axes) == 3
    f0 = plots.plot_tracking(steered, out=str(tmp_path / "steered.png"))
    assert (tmp_path / "steered.png").exists() and len(f0.axes) == 3

    fcfg, fsp, fcp, fcourse = full_body_launch(num_samples=64, horizon=8, roll_off=False,
                                               device="cpu")
    a = run_tracking_experiment(fcfg, fsp, fcp, fcourse, num_steps=25)
    ucfg, usp, ucp, _ = full_body_launch(num_samples=64, horizon=8, roll_off=True,
                                         device="cpu")
    b = run_tracking_experiment(ucfg, usp, ucp, fcourse, num_steps=30)
    f2 = plots.plot_zmp_comparison({"Controlled": a, "Not Controlled": b},
                                   default_params(device="cpu"),
                                   out=str(tmp_path / "zmp_cmp.png"))
    assert (tmp_path / "zmp_cmp.png").exists() and len(f2.axes) == 2
    t = np.arange(10) * 0.1
    f3 = plots.plot_zmp(t, 0.01 * np.sin(t), v=np.ones(10), roll=0.1 * t,
                        out=str(tmp_path / "zmp.png"))
    assert (tmp_path / "zmp.png").exists() and len(f3.axes) == 3


def test_matplotlib_is_not_imported_with_the_package():
    """The card's machine has no matplotlib: importing the port, the plots
    module included, must not import it."""
    import subprocess
    import sys

    code = ("import sys, ccv_mppi_path_tracker_tpu_torch.cli, "
            "ccv_mppi_path_tracker_tpu_torch.metrics.plots, "
            "ccv_mppi_path_tracker_tpu_torch.metrics.animate; "
            "print('matplotlib' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
