"""The frozen reference (``benchmark/reference.py``) against the port's plain
versions at small sizes, and the frozen work count against known numbers.

The reference is written from the reference nodes' equations and imports
nothing of the port; these tests hold the two together, so that a reference
that drifted from the system it judges is seen here and not on the card."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import reference, work
from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams
from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch, full_body_launch
from ccv_mppi_path_tracker_tpu_torch.core.random import philox4x32, philox_normals
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost_reference,
    pack_scalars,
    rollout_cost_work,
)
from ccv_mppi_path_tracker_tpu_torch.models import full_body
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step
from ccv_mppi_path_tracker_tpu_torch.solver.command import command_from_solution, steering_mode

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {"full_body-K102400-T30": full_body_launch, "diff_drive-K1000-T15": diff_drive_launch}
SEEDS = [0, 7, 2**31 + 12345, 2**33 + 5]


def config(name, k=256, t=10):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        return dict(json.load(f), num_samples=k, horizon=t)


def inputs(name, k=256, t=10, offset=(0.3, -0.2)):
    conf = config(name, k, t)
    cfg, sp, cp, _ = CONFIGS[name](num_samples=k, horizon=t, device="cpu")
    course = reference.course(conf["course"], offset)
    pose = np.zeros(reference.NUM_STATES[conf["model"]], np.float32)
    pose[:3] = course[4, 0] + 0.05, course[4, 1] - 0.04, 0.1
    return conf, cfg, sp, cp, course, torch.from_numpy(pose)


@pytest.mark.parametrize("seed", SEEDS)
def test_philox_words_equal_the_port_s(seed):
    g = torch.Generator().manual_seed(seed % 1000)
    c = [torch.randint(0, 2**32, (64,), generator=g, dtype=torch.int64) for _ in range(4)]
    key = (seed, seed // 3 + 11)
    assert all(torch.equal(a, b) for a, b in zip(reference.philox4x32(c, key),
                                                philox4x32(c, key)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("u_dim", [2, 5])
def test_normals_equal_the_port_s(seed, u_dim):
    ours = reference.normals(seed, 9, [0, 3], 6, 5, 37, u_dim, "cpu")
    theirs = philox_normals(seed, 9, 32, 6, u_dim, robot=torch.tensor([0, 3]), device="cpu",
                            first_sample=5)
    assert torch.equal(ours, theirs)


def test_course_is_the_preset_s():
    for name, preset in CONFIGS.items():
        ours = reference.course(config(name)["course"])
        np.testing.assert_allclose(ours, preset(device="cpu")[3], atol=2e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("offset", [(0.0, 0.0), (0.7, -0.9)])
def test_window_equals_the_port_s(name, offset):
    conf, cfg, sp, cp, course, pose = inputs(name, offset=offset)
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    dt = torch.tensor(0.1)
    for shift in (0.0, 0.8, -1.5):
        p = pose.clone()
        p[:2] += shift
        ref = resample_reference(path, p[:2], cp.v_ref, dt, cfg.horizon)
        x = reference.Inputs(conf, course, p[None], None)
        assert torch.equal(x.ref_xy[0], ref.xy)
        assert torch.equal(x.ref_yaw[0], ref.yaw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_costs_match_the_plain_kernel(name, seed):
    """The reference's costs against the kernel's plain version on the same
    draw: rtol 2e-5, the kernel gate's (float32 rounding in another order;
    the reference's distance is the direct |p - r|^2)."""
    conf, cfg, sp, cp, course, pose = inputs(name)
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    dt = torch.tensor(0.1)
    ref = resample_reference(path, pose[:2], cp.v_ref, dt, cfg.horizon)
    mp = full_body.default_params(device="cpu") if cfg.model == "full_body" else None
    u_prev = 0.3 * torch.randn(cfg.horizon - 1, cfg.num_controls,
                               generator=torch.Generator().manual_seed(seed % 97))
    scal = pack_scalars(dt, cp, ref.yaw[0], mp, sp.noise_beta, sp.lam)
    costs, _, _ = fused_sample_rollout_cost_reference(
        u_prev, sp.control_noise, sp.u_min, sp.u_max, ref.xy, pose, scal, seed=seed, step=3,
        num_samples=cfg.num_samples, model=cfg.model)
    x = reference.Inputs(conf, course, pose[None], u_prev[None])
    _, ours = reference.rollouts(x, seed, 3, [0], 0, cfg.num_samples)
    torch.testing.assert_close(ours[0], costs, rtol=2e-5, atol=1e-5)


def test_live_zmp_terms_match_the_plain_kernel():
    """With the ZMP and roll-rate weights on (roll_off false), the terms the
    launch setting zeroes still agree."""
    conf, cfg, sp, _, course, pose = inputs("full_body-K102400-T30")
    conf["cost"] = dict(conf["cost"], zmp_weight=10.0, roll_v_weight=0.5, roll_off=False)
    cp = CostParams(**{k: torch.tensor(float(conf["cost"][k])) for k in
                       ("v_ref", "path_weight", "v_weight", "zmp_weight", "roll_v_weight",
                        "back_weight", "yaw_weight")})
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    dt = torch.tensor(0.1)
    ref = resample_reference(path, pose[:2], cp.v_ref, dt, cfg.horizon)
    scal = pack_scalars(dt, cp, ref.yaw[0], full_body.default_params(device="cpu"),
                        sp.noise_beta, sp.lam)
    u_prev = torch.zeros(cfg.horizon - 1, 5)
    costs, _, _ = fused_sample_rollout_cost_reference(
        u_prev, sp.control_noise, sp.u_min, sp.u_max, ref.xy, pose, scal, seed=5, step=0,
        num_samples=cfg.num_samples, model="full_body")
    _, ours = reference.rollouts(reference.Inputs(conf, course, pose[None], None), 5, 0, [0],
                                 0, cfg.num_samples)
    torch.testing.assert_close(ours[0], costs, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("use_kernel", [True, False])
def test_update_matches_the_port(name, use_kernel):
    """u_opt of two chained updates of the port (its kernel's plain version,
    or its eager path) against the reference from the port's warm start:
    within 1e-5 of the box width, far under the card's limits."""
    conf, cfg, sp, cp, course, pose = inputs(name)
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    box = torch.tensor(conf["solver"]["u_max"]) - torch.tensor(conf["solver"]["u_min"])
    ctrl = ControllerState.initial(2**31 + 77, cfg.horizon, cfg.num_controls, device="cpu")
    for step in range(2):
        nxt, res = mppi_step(cfg, ctrl, pose, path, torch.tensor(0.1), sp, cp,
                             use_kernel=use_kernel, lean=True)
        ours = reference.update(conf, course, pose[None], None if step == 0 else
                                ctrl.u_prev[None], ctrl.seed, step)[0]
        assert ((res.u_opt - ours).abs() / box).max() < 1e-5
        ctrl = nxt


def test_update_blocks_and_robots():
    """Blocks of samples give the update of one block; robot b of a fleet is
    robot b alone."""
    conf, *_, course, pose = inputs("diff_drive-K1000-T15", k=300)
    poses = torch.stack([pose, pose + torch.tensor([0.1, -0.1, 0.05])])
    whole = reference.update(conf, course, poses, None, 11, 4)
    torch.testing.assert_close(reference.update(conf, course, poses, None, 11, 4, block=64),
                               whole, rtol=1e-5, atol=1e-6)
    one = reference.update(conf, course, poses[1:], None, 11, 4, robots=[1])
    torch.testing.assert_close(one[0], whole[1], rtol=1e-6, atol=1e-7)


U0S = [(1.2, 0.4, 0.2, 0.1, 0.0), (0.5, -0.7, -0.3, -0.2, 0.1), (1.0, 0.0, 0.1, 0.0, 0.0),
       (0.0, 0.0, 0.2, 0.0, 0.0), (0.05, 0.9, 0.01, 6.0, 0.0), (-0.4, 0.3, 0.0, -6.0, 0.0)]


@pytest.mark.parametrize("u0", U0S)
@pytest.mark.parametrize("model", ["full_body", "unicycle"])
def test_command_equals_the_port_s(u0, model):
    spec = config("full_body-K102400-T30")["command"]
    u = torch.tensor(u0 if model == "full_body" else u0[:2], dtype=torch.float32)
    theirs = command_from_solution(model, u, 0.1)
    ours = reference.command(model, u.numpy(), 0.1, spec)
    for name, v in ours.items():
        t = float(getattr(theirs, name))
        assert (math.isnan(t) and math.isnan(v)) or t == v, name
    mode = reference.steering_mode(float(theirs.steer_r), float(theirs.steer_l))
    assert mode is None or mode == int(steering_mode(theirs.steer_r, theirs.steer_l))


@pytest.mark.parametrize("angles", [(0.1, -0.1), (0.0, 0.0), (0.2, 0.2), (0.2, 0.3),
                                    (0.0011, 0.0), (-0.3, -0.1)])
def test_steering_mode_equals_the_port_s(angles):
    sr, sl = angles
    theirs = int(steering_mode(torch.tensor(sr), torch.tensor(sl)))
    assert reference.steering_mode(sr, sl) == theirs


def test_steering_mode_leaves_the_threshold_undecided():
    assert reference.steering_mode(0.3, 0.3 - reference.MODE_EPS) is None


def test_work_counts():
    """Known counts of the frozen work.py (bench_torch/work.py, PR 8): the
    flagship's bound 0.0165 ms by the integer peak (PERF.md)."""
    assert work.PHILOX_CALL == 62 and work.BOX_MULLER_PAIR == 11
    assert work.per_sample("full_body", 30, 30) == {
        "philox": 5394, "box_muller": 957, "sample": 1000, "rollout": 378, "cost": 5389,
        "update": 297}
    assert work.per_sample("unicycle", 15, 15) == {
        "philox": 868, "box_muller": 154, "sample": 190, "rollout": 126, "cost": 1305,
        "update": 63}
    flagship = work.update_work("full_body", 102_400, 30)
    assert flagship == {"flops": 821_350_400, "int_ops": 552_345_600, "bytes": 411_156}
    ms, by = work.bound_ms(flagship)
    assert by == "operations" and ms == pytest.approx(0.0164879, rel=1e-5)
    fleet = work.update_work("unicycle", 1000, 15, num_robots=256)
    assert fleet["int_ops"] == 256 * work.update_work("unicycle", 1000, 15)["int_ops"]
    assert work.bound_ms(fleet)[0] == pytest.approx(0.0070228, rel=1e-4)


@pytest.mark.parametrize("model,k,t", [("full_body", 102_400, 30), ("unicycle", 1000, 15)])
def test_work_count_beside_the_port_s(model, k, t):
    """The integer work agrees with the port's count from its kernel source;
    the float work within 10 % (the two count Box-Muller, the update and the
    scalars differently, PERF.md)."""
    ours = work.update_work(model, k, t)
    theirs = rollout_cost_work(model, k, t, t)
    assert ours["int_ops"] == theirs["int_ops"]
    assert abs(ours["flops"] / theirs["flops"] - 1) < 0.1


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import benchmark.reference, benchmark.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"ccv_mppi_path_tracker_tpu_torch", "ccv_mppi_path_tracker_tpu",
                       "jax", "jaxlib", "bench_torch"}
