"""The port's tracking-quality matrix (``scripts/torch_quality_matrix.py``)
against the JAX package's (``scripts/quality_matrix.py``): the courses, the
controller configurations, the step budget, the completion cut and the
summary equal to JAX's on the same inputs; the pure-pursuit baseline at
float32 within rtol 1e-5; the three gated cells of
``tests/test_quality_matrix.py`` at ``--quick`` on the CPU with the same
gates; and the committed H100 artifact in the TPU artifact's schema."""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import quality_matrix as qm  # noqa: E402
import torch_quality_matrix as tqm  # noqa: E402
from ccv_mppi_path_tracker_tpu.metrics.tracking import tracking_metrics as jax_tracking  # noqa: E402
from ccv_mppi_path_tracker_tpu.runtime import pure_pursuit as jax_pp  # noqa: E402
from ccv_mppi_path_tracker_tpu_torch.runtime import pure_pursuit  # noqa: E402
from test_torch_realtime import one_torch_thread  # noqa: E402,F401  (autouse)

COURSES = tuple(qm.courses())
ARTIFACT = ROOT / "artifacts" / "quality_matrix_torch.json"
TPU_ARTIFACT = ROOT / "artifacts" / "quality_matrix.json"


@pytest.mark.parametrize("name", COURSES)
def test_courses_equal_jax(name):
    ours, ref = tqm.courses()[name], qm.courses()[name]
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("v_ref", tqm.V_REFS)
def test_controller_configs_match_jax(v_ref, quick):
    ours = tqm.controller_configs(v_ref, quick=quick, device="cpu")
    ref = qm.controller_configs(v_ref, quick=quick)
    assert list(ours) == list(ref)
    for name, (cfg, sp, cp) in ours.items():
        jcfg, jsp, jcp = ref[name]
        assert (cfg.model, cfg.num_samples, cfg.horizon, cfg.steer_off) == (
            jcfg.model, jcfg.num_samples, jcfg.horizon, jcfg.steer_off), name
        for ours_p, ref_p in ((sp, jsp), (cp, jcp)):
            for f in dataclasses.fields(ours_p):
                np.testing.assert_array_equal(
                    getattr(ours_p, f.name).numpy(), np.asarray(getattr(ref_p, f.name)),
                    err_msg=f"{name}.{f.name}")
    assert float(ours["full_body"][2].v_ref) == np.float32(v_ref)
    roll = tqm.controller_configs(v_ref, quick=quick, roll_off=True, device="cpu")
    jroll = qm.controller_configs(v_ref, quick=quick, roll_off=True)
    for f in ("zmp_weight", "roll_v_weight"):
        assert float(getattr(roll["full_body"][2], f)) == float(getattr(jroll["full_body"][2], f))


def test_num_steps_for_equals_jax():
    for course in (*qm.courses().values(), np.zeros((2, 2)) + [[0, 0], [1e4, 0]]):
        for v_ref in (0.1, *tqm.V_REFS, 3.3):
            for quick in (False, True):
                assert tqm.num_steps_for(course, v_ref, quick) == qm.num_steps_for(
                    course, v_ref, quick)
                assert tqm.course_length(course) == qm.course_length(course)


def _line_cases():
    course = np.stack([np.linspace(0, 10, 101), np.zeros(101)], axis=-1)
    xy = np.stack([np.linspace(0, 12, 121), np.zeros(121)], axis=-1)
    fwd = np.stack([np.linspace(0, 5, 51), np.zeros(51)], axis=-1)
    back = np.stack([np.linspace(5, 0.0, 50), np.full(50, 0.3)], axis=-1)
    loop = np.concatenate([fwd, back])
    return {"line": (xy, course), "line_short": (xy[:50], course),
            "out_and_back": (loop, loop)}


@pytest.mark.parametrize("case", ["line", "line_short", "out_and_back"])
def test_truncate_at_completion_equals_jax(case):
    xy, course = _line_cases()[case]
    got = tqm.truncate_at_completion(xy, course)
    assert got == qm.truncate_at_completion(xy, course)
    assert got == {"line": (101, True), "line_short": (50, False),
                   "out_and_back": (len(xy), True)}[case]


@pytest.mark.parametrize("seed", range(4))
def test_truncate_at_completion_equals_jax_on_random_inputs(seed):
    rng = np.random.RandomState(seed)
    course = np.cumsum(rng.uniform(-0.1, 0.2, (80, 2)), axis=0)
    # a noisy walk along the course that completes, and a random cloud
    walk = course[np.minimum(np.arange(120) * 80 // 100, 79)] + rng.normal(0, 0.05, (120, 2))
    cloud = rng.uniform(course.min(0) - 1, course.max(0) + 1, (60, 2))
    for xy in (walk, cloud):
        assert tqm.truncate_at_completion(xy, course) == qm.truncate_at_completion(xy, course)
    assert tqm.truncate_at_completion(walk, course)[1]


def _synthetic_cells(seed):
    rng = np.random.RandomState(seed)
    cells = []
    for course in COURSES:
        for v in tqm.V_REFS:
            for ctrl in ("diff_drive", "steering", "full_body"):
                cells.append({
                    "controller": ctrl, "course": course, "v_ref": v,
                    "completed": bool(rng.rand() < 0.9),
                    "mppi_refined": {"completed": bool(rng.rand() < 0.9)},
                    "mppi_beats_pp": bool(rng.rand() < 0.8),
                    "framework_beats_pp": bool(rng.rand() < 0.9)})
        cells.append({"controller": "full_body", "course": course, "v_ref": 2.0,
                      "experiment": "zmp_controlled_vs_uncontrolled",
                      "zmp_reduction_pct": float(rng.uniform(-20, 50)),
                      "zmp_rms_reduction_pct": float(rng.uniform(-5, 50)),
                      "zmp_band_held": bool(rng.rand() < 0.8)})
    return cells


@pytest.mark.parametrize("seed", range(3))
def test_summarize_equals_jax(seed):
    cells = _synthetic_cells(seed)
    assert tqm.summarize(cells) == qm.summarize(cells)


@pytest.mark.parametrize("course_name,v_ref", [("cosine_A1.0_f0.25", 1.2),
                                               ("cosine_A1.5_f0.127", 2.0),
                                               ("dkan", 0.4), ("filtered_square", 1.2)])
def test_eval_pure_pursuit_matches_jax(course_name, v_ref):
    """float32, at --quick's step budget: the unrounded metrics of the same
    cut within rtol 1e-5, and eval_pure_pursuit's cell within one unit of
    its 4-decimal rounding."""
    course = qm.courses()[course_name]
    steps = tqm.num_steps_for(course, v_ref, quick=True)
    cfg = pure_pursuit.PurePursuitConfig(lookahead=max(0.8, 0.65 * v_ref), v_ref=v_ref,
                                         w_max=2.0)
    jcfg = jax_pp.PurePursuitConfig(lookahead=cfg.lookahead, v_ref=v_ref, w_max=2.0)
    got = pure_pursuit.run_pure_pursuit_experiment(course, num_steps=steps, dt=tqm.DT,
                                                   cfg=cfg, device="cpu")
    ref = jax_pp.run_pure_pursuit_experiment(course, num_steps=steps, dt=qm.DT, cfg=jcfg)
    raw = []
    for out, trunc in ((got, tqm.truncate_at_completion), (ref, qm.truncate_at_completion)):
        xy = np.concatenate([np.asarray(course[:1], np.float64), out["logs"]["state"][:, :2]])
        n, done = trunc(xy, course)
        raw.append((n, done, jax_tracking(xy[:n], course, dt=qm.DT)))
    assert raw[0][:2] == raw[1][:2]
    for key in ("rmse", "max_error"):
        np.testing.assert_allclose(raw[0][2][key], raw[1][2][key], rtol=1e-5, err_msg=key)
    cell = tqm.eval_pure_pursuit(course, v_ref, quick=True, device="cpu")
    jcell = qm.eval_pure_pursuit(course, v_ref, quick=True)
    assert set(cell) == set(jcell)
    for key, value in cell.items():
        if key in ("rmse_m", "max_error_m"):
            assert abs(value - jcell[key]) <= 1e-4 + 1e-12, (key, value, jcell[key])
        else:
            assert value == jcell[key], key


def _cell(ctrl_name, course_name, v_ref, quick=True):
    course = tqm.courses()[course_name]
    cfg, sp, cp = tqm.controller_configs(v_ref, quick=quick, device="cpu")[ctrl_name]
    cell = tqm.eval_mppi(cfg, sp, cp, course, v_ref, quick=quick)
    pp = tqm.eval_pure_pursuit(course, v_ref, quick=quick, device="cpu")
    return cell, pp


def test_diff_drive_beats_pure_pursuit_on_launch_course():
    cell, pp = _cell("diff_drive", "cosine_A1.0_f0.25", 1.2)
    assert cell["completed"], cell
    assert cell["rmse_m"] <= pp["rmse_m"], (cell, pp)
    assert cell["rmse_m"] < 0.15, cell


def test_steering_beats_pure_pursuit_on_filtered_square():
    cell, pp = _cell("steering", "filtered_square", 1.2)
    assert cell["rmse_m"] <= pp["rmse_m"], (cell, pp)
    assert cell["max_error_m"] < pp["max_error_m"], (cell, pp)


def test_full_body_tracks_at_v2_with_zmp_cost():
    cell, pp = _cell("full_body", "cosine_A1.5_f0.127", 2.0)
    assert cell["completed"], cell
    assert cell["rmse_m"] <= max(pp["rmse_m"], 0.12), (cell, pp)


def test_eval_mppi_logs_the_zmp_fields():
    """A full_body cell with ZMP params carries the lateral ZMP's peak and
    RMS after the start transient."""
    course = tqm.courses()["cosine_A1.0_f0.25"]
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params

    cfg, sp, cp = tqm.controller_configs(2.0, quick=True, device="cpu")["full_body"]
    cell = tqm.eval_mppi(cfg, sp, cp, course, 2.0, quick=True,
                         zmp_params=default_params(device="cpu"))
    assert 0 < cell["zmp_y_rms_m"] <= cell["zmp_y_max_m"], cell
    assert np.isfinite(cell["zmp_y_max_m"]) and cell["completed"], cell


def _keys(cell):
    return set(cell) - {"controlled_max_note"}


def test_committed_artifact_has_the_tpu_schema():
    ours, tpu = json.loads(ARTIFACT.read_text()), json.loads(TPU_ARTIFACT.read_text())
    assert set(ours) == set(tpu) | {"power_limit"}
    assert set(ours["summary"]) == set(tpu["summary"])
    track = [c for c in ours["cells"] if "experiment" not in c]
    zmp = [c for c in ours["cells"] if "experiment" in c]
    assert len(track) == 36 and len(zmp) == 4
    assert ours["summary"]["tracking_cells"] == 36 and ours["summary"]["zmp_experiments"] == 4
    tpu_track = [c for c in tpu["cells"] if "experiment" not in c]
    tpu_zmp = [c for c in tpu["cells"] if "experiment" in c]
    assert {frozenset(_keys(c)) for c in track} == {frozenset(_keys(c)) for c in tpu_track}
    assert {frozenset(_keys(c)) for c in zmp} == {frozenset(_keys(c)) for c in tpu_zmp}
    assert [(c["course"], c["v_ref"], c["controller"]) for c in track] == [
        (c["course"], c["v_ref"], c["controller"]) for c in tpu_track]
    for c, t in zip(track, tpu_track):
        assert set(c) == set(t)
        assert set(c["mppi_refined"]) == set(t["mppi_refined"])
        assert set(c["pure_pursuit"]) == set(t["pure_pursuit"])
        assert c["solver_path"] in ("kernel", "eager") and len(c["rmse_per_seed"]) == 3
    for c, t in zip(zmp, tpu_zmp):
        assert _keys(c) == _keys(t) and c["course"] == t["course"]
        assert set(c["controlled"]) == set(t["controlled"])
    assert ours["backend"] == "cuda" and not ours["quick"]
    assert "NVIDIA" in ours["device_kind"]
    assert ours["power_limit"].startswith(ours["device_kind"]) and "W" in ours["power_limit"]
    assert ours["summary"] == tqm.summarize(ours["cells"])


def test_device_defaults_to_the_card():
    """Asked for no device, the matrix's runs go to the card: without one,
    torch's own error, never the CPU."""
    course = tqm.courses()["cosine_A1.0_f0.25"]
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises((AssertionError, RuntimeError)):
        tqm.controller_configs(1.2, quick=True)
    with pytest.raises((AssertionError, RuntimeError)):
        tqm.eval_pure_pursuit(course, 1.2, quick=True)


def test_main_quick_on_the_cpu_writes_the_schema(tmp_path, monkeypatch):
    """``main --quick --device cpu`` over one course (the others dropped):
    the artifact's top-level keys and its summary."""
    one = {"cosine_A1.0_f0.25": tqm.courses()["cosine_A1.0_f0.25"]}
    monkeypatch.setattr(tqm, "courses", lambda dtype=np.float32: one)
    monkeypatch.setattr(tqm, "V_REFS", (2.0,))
    monkeypatch.setattr(tqm, "REFINE_OPTS", {"refine_steps": 1,
                                             "refine_method": "gauss_newton"})
    out = tmp_path / "qm.json"
    assert tqm.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    tpu = json.loads(TPU_ARTIFACT.read_text())
    assert set(got) == set(tpu) | {"power_limit"}
    assert got["backend"] == "cpu" and got["power_limit"] is None and got["quick"]
    assert got["summary"]["tracking_cells"] == 3 and got["summary"]["zmp_experiments"] == 1
    assert {c["solver_path"] for c in got["cells"] if "experiment" not in c} == {"eager"}
    assert os.path.getsize(out) > 0
