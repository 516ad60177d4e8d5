"""The port's sustained serving session (``scripts/torch_realtime_session.py``)
on the CPU: the device arm's cycle against ``simulate`` where the plant's dt
is the solver's (bit-equal at float64), a tiny device arm that tracks, and
the committed H100 artifact's keys against the TPU artifact's."""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_realtime_session as rs  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.models import get_model  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.paths.courses import circle_course  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.runtime import simulate  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import scan  # noqa: E402
from test_torch_realtime import one_torch_thread  # noqa: E402,F401  (autouse)

ARTIFACT = ROOT / "artifacts" / "realtime_torch.json"
TPU_ARTIFACT = ROOT / "artifacts" / "realtime_tpu.json"
# keys of the TPU artifact that scripts/realtime_session.py's twin does not
# write: the relay caveat (no relay here) and arms added to that file by hand
NOT_WRITTEN = {"environment_note", "pipelined_K1M_arms"}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_device_cycle_equals_simulate_when_the_dts_agree(use_kernel):
    """With dt_ctrl == dt_solve the session's cycle is simulate's: the same
    positions bit for bit (float64 on the eager path; the kernel's plain
    version is float32)."""
    dtype = torch.float32 if use_kernel else torch.float64
    cfg, sp, cp, _ = full_body_launch(num_samples=64, horizon=8, dtype=dtype, device="cpu")
    course = circle_course(radius=10.0, resolution=0.1, turns=1.0,
                           dtype=np.float32 if use_kernel else np.float64)
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device="cpu")
    model = get_model(cfg.model)
    mp = model.default_params(device="cpu", dtype=dtype)
    dt = torch.full((), 0.1, dtype=dtype)
    state0 = torch.tensor([course[0, 0], course[0, 1], np.pi / 2, 0.0, 0.0], dtype=dtype)
    ctrl0 = ControllerState.initial(3, cfg.horizon, model.num_controls, dtype=dtype,
                                    device="cpu")
    opts = {"use_kernel": use_kernel, "lean": True}
    (ctrl, state), xy = scan(rs.session_cycle, (ctrl0.with_key(), state0), path, dt, dt,
                             sp, cp, mp, cfg, opts, length=20)
    ref_ctrl, logs = simulate(cfg, ctrl0, state0, path, dt, sp, cp, model_params=mp,
                              num_steps=20, use_kernel=use_kernel, with_stats=False)
    assert torch.equal(xy, logs["state"][:, :2])
    assert torch.equal(state, logs["state"][-1])
    assert torch.equal(ctrl.u_prev, ref_ctrl.u_prev) and ctrl.step == ref_ctrl.step


def test_tiny_device_arm_tracks():
    out = rs.device_arm(hz=100.0, seconds=0.5, num_samples=256, horizon=10, device="cpu")
    assert out["cycles"] == 50 and out["sim_seconds"] == 0.5
    assert out["kernel"] and out["lean"]
    # on the CPU the kernel wrapper runs its plain version: nothing captured,
    # nothing launched
    assert out["captures"] == 0 and out["kernel_launches"] == 0
    assert np.isfinite(out["tracking"]["rmse"]) and out["tracking"]["rmse"] < 0.1, out
    assert out["sustained_hz"] > 0 and out["per_cycle_ms"] > 0


def test_main_writes_the_arms_it_ran(tmp_path, monkeypatch):
    # the device arm at a CPU size (the script's own is the flagship)
    monkeypatch.setattr(rs, "device_arm", functools.partial(rs.device_arm, num_samples=64,
                                                            horizon=8))
    out = tmp_path / "rt.json"
    assert rs.main(["--device", "cpu", "--hz", "50", "--seconds", "0.2", "--skip-host",
                    "--skip-pipelined", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["device"] == "cpu" and got["power_limit"] is None
    dev = got["device_resident_session"]
    assert dev["cycles"] == 10 and (dev["num_samples"], dev["horizon"]) == (64, 8)
    assert got["pipelined_host_ladder"] == [] and got["host_rate_ladder_synchronous"] == []


def test_committed_artifact_has_the_tpu_keys():
    ours, tpu = json.loads(ARTIFACT.read_text()), json.loads(TPU_ARTIFACT.read_text())
    assert set(ours) == (set(tpu) - NOT_WRITTEN) | {"power_limit"}
    dev, tdev = ours["device_resident_session"], tpu["device_resident_session"]
    assert set(dev) == set(tdev) | {"captures", "kernel_launches"}
    assert set(dev["tracking"]) == set(tdev["tracking"])
    assert dev["cycles"] == 30_000 and dev["captures"] == 1
    assert dev["kernel_launches"] == dev["cycles"]
    assert [(r["target_hz"], r["micro_batch"]) for r in ours["pipelined_host_ladder"]] == [
        (r["target_hz"], r["micro_batch"]) for r in tpu["pipelined_host_ladder"]]
    for row, trow in zip(ours["pipelined_host_ladder"], tpu["pipelined_host_ladder"]):
        assert set(row) == set(trow) and set(row["fetch_ms"]) == set(trow["fetch_ms"])
    assert set(ours["delay_compensation_closed_loop"]) == set(
        tpu["delay_compensation_closed_loop"])
    assert [r["target_hz"] for r in ours["host_rate_ladder_synchronous"]] == [
        r["target_hz"] for r in tpu["host_rate_ladder_synchronous"]]
    for row, trow in zip(ours["host_rate_ladder_synchronous"],
                         tpu["host_rate_ladder_synchronous"]):
        assert set(row) == set(trow)
    assert "NVIDIA" in ours["device"] and ours["power_limit"].startswith(ours["device"])
