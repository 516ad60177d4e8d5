"""scripts/torch_make_figures.py, the twin of scripts/make_figures.py, on the
CPU: ``--quick`` (K=64, 10 cycles) writes exactly the ten figures of
examples/figures/ and keeps its runs in an npz that draws them again
(``--draw-from``); it imports no jax; without matplotlib it draws nothing
and says how to."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_make_figures.py")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_make_figures as twin  # noqa: E402

# run the script's main in a fresh interpreter; fail if jax was imported
RUN = ("import importlib.util, sys; "
       "spec = importlib.util.spec_from_file_location('twin', sys.argv[1]); "
       "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
       "rc = m.main(sys.argv[2:]); "
       "assert not [n for n in sys.modules if n == 'jax' or n.startswith('jax.') "
       "or n.split('.')[0] == 'ccv_mppi_path_tracker_tpu'], 'jax imported'; "
       "sys.exit(rc)")
# the same, with matplotlib made unimportable first
NO_MATPLOTLIB = ("import sys; sys.modules['matplotlib'] = None; " + RUN)


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", code, SCRIPT, *args], capture_output=True,
                          text=True, timeout=300, cwd=REPO,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("figures")
    proc = _run(RUN, "--quick", "--device", "cpu", "--out", str(tmp / "png"),
                "--runs", str(tmp / "runs.npz"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return tmp, proc.stdout


def test_the_ten_figures_of_make_figures(quick):
    tmp, _ = quick
    expected = sorted(os.listdir(os.path.join(REPO, "examples", "figures")))
    assert sorted(f"{name}.png" for name in twin.FIGURES) == expected
    assert sorted(os.listdir(tmp / "png")) == expected
    for name in expected:
        with open(tmp / "png" / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_rmse_lines_as_make_figures_prints_them(quick):
    _, out = quick
    src = open(os.path.join(REPO, "scripts", "make_figures.py")).read()
    for label in ("diff_drive RMSE:", "full_body RMSE:", "full-stack (controlled) RMSE:",
                  "steered RMSE:"):
        assert f'"{label}"' in src
        line = next(x for x in out.splitlines() if x.startswith(label))
        assert float(line.split()[-1]) < 0.15, line


def test_runs_round_trip_and_draw_again(quick, tmp_path):
    tmp, _ = quick
    runs = twin.load_runs(tmp / "runs.npz")
    assert set(runs) == {"diff_drive", "full_body", "full_stack", "steered", "unsteered",
                         "controlled", "uncontrolled", "solver_debug"}
    assert runs["solver_debug"]["candidates"].shape == (48, 12, 2)
    assert runs["diff_drive"]["logs"]["state"].shape == (twin.QUICK_STEPS, 3)
    assert isinstance(runs["diff_drive"]["metrics"]["rmse"], float)
    twin.save_runs(runs, tmp_path / "again.npz")
    with np.load(tmp / "runs.npz") as a, np.load(tmp_path / "again.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_without_matplotlib_nothing_is_drawn(quick, tmp_path):
    tmp, _ = quick
    proc = _run(NO_MATPLOTLIB, "--draw-from", str(tmp / "runs.npz"), "--out",
                str(tmp_path / "png"))
    assert proc.returncode == 1
    assert "matplotlib is not installed" in proc.stderr
    assert not (tmp_path / "png").exists()
