"""Packaging contracts of the PyTorch port: it runs without jax, converts the
JAX package's parameters, drives its CLI, and its kernel wrapper counts and
checks what it launches."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core.config import full_body_config as jax_full_body_config
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu_torch import cli
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.kernels import build
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    NSCAL,
    fused_sample_rollout_cost,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ccv_mppi_path_tracker_tpu_torch"

RUN_ONE_STEP = """
import sys
import torch
from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.solver import MPPISolver
cfg, sp, cp, course = full_body_launch(num_samples=256, horizon=10, device="cpu")
path = PathBuffer.from_points(course, 0.1, device="cpu")
for use_kernel in (False, True):
    solver = MPPISolver(cfg, use_kernel=use_kernel)
    _, res = solver.step(solver.init(0, device="cpu"), torch.zeros(5), path, 0.1, sp, cp)
    assert torch.isfinite(res.u_opt).all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ccv_mppi_path_tracker_tpu"))
print("loaded:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", RUN_ONE_STEP], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "scripts").glob("torch_*.py"))
                         + sorted((ROOT / "bench_torch").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "ccv_mppi_path_tracker_tpu"), (
                f"{path} imports {name}")


def test_version_is_the_jax_package_s():
    import ccv_mppi_path_tracker_tpu
    import ccv_mppi_path_tracker_tpu_torch
    from ccv_mppi_path_tracker_tpu_torch.version import __version__

    assert ccv_mppi_path_tracker_tpu_torch.__version__ == __version__
    assert __version__ == ccv_mppi_path_tracker_tpu.__version__ == "0.5.0"
    assert ccv_mppi_path_tracker_tpu_torch.__all__ == ["__version__"]


@pytest.mark.parametrize("as_dicts", [False, True])
def test_from_numpy_round_trips(as_dicts):
    _, jsp, jcp = jax_full_body_config(dtype=np.float64)
    jmp = jax_default_params(np.float64)
    jpath = JaxPathBuffer.from_points(np.random.RandomState(0).randn(20, 2), 0.1,
                                      capacity=24, dtype=np.float64)
    u_prev = np.random.RandomState(1).randn(14, 5)
    objs = (jsp, jcp, jmp)
    if as_dicts:
        objs = tuple({k: np.asarray(v) for k, v in vars(o).items()} for o in objs)
    sp, cp, mp, u, path = from_numpy(*objs, u_prev, jpath, dtype=torch.float64)
    for jobj, tobj in zip((jsp, jcp, jmp), (sp, cp, mp)):
        for f in dataclasses.fields(tobj):
            got = getattr(tobj, f.name)
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jobj, f.name)))
    np.testing.assert_array_equal(u.numpy(), u_prev)
    np.testing.assert_array_equal(path.xy.numpy(), np.asarray(jpath.xy))
    assert path.num_valid == 20
    assert float(path.resolution) == 0.1
    sp32 = from_numpy(jsp, jcp, None, u_prev, jpath)[0]
    assert sp32.lam.dtype == torch.float32


@pytest.mark.parametrize("extra", [["--kernel"], ["--no-kernel"]],
                         ids=["kernel", "eager"])
def test_cli_run_prints_the_metric_lines(extra, capsys):
    before = fused_sample_rollout_cost.launches
    rc = cli.main(["run", "--device", "cpu", "--steps", "3", "--num-samples", "256",
                   *extra])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[-3].startswith("Time: ")
    assert out[-2].startswith("Max Error: ")
    assert out[-1].startswith("RMSE Error: ")
    assert float(out[-1].split(": ")[1]) < 0.15
    assert fused_sample_rollout_cost.launches == before  # CPU: never launched


def test_cli_refuses_a_missing_cuda_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["run", "--steps", "1"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def _kernel_args(**over):
    args = dict(
        u_prev=torch.zeros(9, 5), sigma=torch.full((5,), 0.5),
        u_min=-torch.ones(5), u_max=torch.ones(5),
        ref_xy=torch.rand(10, 2), state0=torch.zeros(5),
        scal=torch.ones(NSCAL), model="full_body",
    )
    args.update(over)
    return args


@pytest.mark.parametrize(
    "over,error",
    [
        ({"u_prev": torch.zeros(9, 5, dtype=torch.float64)}, TypeError),
        ({"u_prev": torch.zeros(9, 3)}, ValueError),
        ({"scal": torch.ones(NSCAL + 1)}, ValueError),
        ({"ref_xy": torch.rand(10, 3)}, ValueError),
        ({"u_prev": torch.zeros(5, 9).t()}, ValueError),
        ({"noise": torch.zeros(9, 7, 5)}, ValueError),
        ({"model": "no_such_model"}, ValueError),
        ({"model": "unicycle"}, ValueError),
        ({"costs_in": torch.zeros(8), "accumulate": False}, ValueError),
        ({"costs_in": torch.zeros(7)}, ValueError),
        ({"costs_in": torch.zeros(8, dtype=torch.float64)}, TypeError),
    ],
    ids=["float64", "u_dim", "scal_len", "ref_cols", "non_contiguous", "noise_shape",
         "unknown_model", "model_dims", "costs_in_without_update", "costs_in_shape",
         "costs_in_float64"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(over, error):
    with pytest.raises(error):
        fused_sample_rollout_cost(**_kernel_args(**over), seed=0, step=0,
                                  num_samples=8)


def test_kernel_wrapper_on_cpu_uses_the_plain_version_and_counts_nothing():
    before = fused_sample_rollout_cost.launches
    costs, u_num, norm = fused_sample_rollout_cost(**_kernel_args(), seed=0, step=0,
                                                   num_samples=300)
    assert costs.shape == (300,) and u_num.shape == (9, 5) and norm.shape == ()
    assert fused_sample_rollout_cost.launches == before


def test_every_native_source_is_package_data():
    """An installed wheel carries every file the port builds at first use
    (csrc/rollout_cost.cu by nvcc, csrc/ccv_runtime.cpp by g++)."""
    import fnmatch
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][PORT.name]
    sources = sorted((PORT / "csrc").iterdir())
    assert {p.suffix for p in sources} >= {".cu", ".cpp"}
    for p in sources:
        rel = str(p.relative_to(PORT))
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), f"{rel} is not package data"


def test_build_library_name_follows_the_source():
    path = build.library_path("rollout_cost")
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.name.startswith("librollout_cost_") and path.suffix == ".so"
    assert path == build.library_path("rollout_cost")
