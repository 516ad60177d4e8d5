"""The port's exported control step (runtime/export.py, the ``export``
command), the twin of tests/test_export.py: the round trip equals the eager
``mppi_step`` fed the kernel's Philox normals of the same seed and step
(float32 rtol 1e-6), weights retuned through the artifact change its output,
and the command writes a file that loads and runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu_torch import cli
from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch, full_body_launch
from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.runtime.export import (
    export_control_step,
    load_control_step,
)
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

K, T = 64, 10
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The diff_drive step exported by the command, and its preset."""
    out = tmp_path_factory.mktemp("export") / "step.pt2"
    assert cli.main(["export", "--device", "cpu", "--num-samples", str(K), "--horizon",
                     str(T), "--out", str(out)]) == 0
    cfg, sp, cp, course = diff_drive_launch(num_samples=K, horizon=T, device="cpu")
    return out, (cfg, sp, cp, course)


def _inputs(cfg, course, seed=3, step=5):
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    ctrl = ControllerState(u_prev=torch.zeros(T - 1, cfg.num_controls), seed=seed, step=step)
    state = torch.zeros(cfg.num_states)
    state[1] = float(course[0, 1]) + 0.05
    return path, ctrl, state


def _eager(cfg, ctrl, state, path, sp, cp, **kw):
    noise = philox_normals(ctrl.seed, ctrl.step, K, T - 1, cfg.num_controls)
    return mppi_step(cfg, ctrl, state, path, 0.1, sp, cp, noise=noise, **kw)


def _check(call, cfg, sp, cp, course, **kw):
    path, ctrl, state = _inputs(cfg, course)
    c1, a = call(ctrl, state, path, 0.1, sp, cp, **kw)
    c2, b = _eager(cfg, ctrl, state, path, sp, cp, **kw)
    for x, y in ((a.u_opt, b.u_opt), (a.u0, b.u0), (a.ref.xy, b.ref.xy),
                 (a.opt_states, b.opt_states)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
    for name in ("min_cost", "mean_cost", "ess"):
        np.testing.assert_allclose(a.stats[name].numpy(), b.stats[name].numpy(), **TOL)
    assert (c1.seed, c1.step) == (c2.seed, c2.step) == (3, 6)
    np.testing.assert_array_equal(c1.u_prev.numpy(), a.u_opt.numpy())
    return a


def test_export_command_writes_a_loadable_step(exported):
    out, (cfg, sp, cp, course) = exported
    call = load_control_step(out.read_bytes())
    assert call.cfg == cfg
    a = _check(call, cfg, sp, cp, course)
    assert torch.isfinite(a.u_opt).all()
    # another seed and step draw other noise through the same program
    path, ctrl, state = _inputs(cfg, course, seed=4, step=0)
    _, other = call(ctrl, state, path, 0.1, sp, cp)
    assert not torch.equal(other.u_opt, a.u_opt)


def test_retuning_weights_through_the_artifact(exported):
    out, (cfg, sp, cp, course) = exported
    call = load_control_step(out.read_bytes())
    path, ctrl, state = _inputs(cfg, course)
    _, a = call(ctrl, state, path, 0.1, sp, cp)
    cp2 = dataclasses.replace(cp, path_weight=torch.tensor(20.0))
    _, c = call(ctrl, state, path, 0.1, sp, cp2)
    assert not np.allclose(c.u_opt.numpy(), a.u_opt.numpy())
    _, want = _eager(cfg, ctrl, state, path, sp, cp2)
    np.testing.assert_allclose(c.u_opt.numpy(), want.u_opt.numpy(), **TOL)


def test_full_body_export_takes_its_parameters_as_inputs():
    # roll_off=False: the ZMP term, which reads the mass, is in the cost
    cfg, sp, cp, course = full_body_launch(num_samples=K, horizon=T, roll_off=False,
                                           device="cpu")
    blob = export_control_step(cfg, path_capacity=len(course), sp=sp, cp=cp, device="cpu")
    assert isinstance(blob, bytes) and len(blob) > 1000
    call = load_control_step(blob)
    _check(call, cfg, sp, cp, course)
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params

    heavy = dataclasses.replace(default_params(device="cpu"), mass=torch.tensor(90.0))
    a = _check(call, cfg, sp, cp, course, model_params=heavy)
    path, ctrl, state = _inputs(cfg, course)
    _, light = call(ctrl, state, path, 0.1, sp, cp)
    assert not torch.equal(a.stats["min_cost"], light.stats["min_cost"])
