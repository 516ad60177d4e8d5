"""The benchmark's frozen copies (``benchmark/work.py``, ``timing.py``,
``trace.py``) held on the CPU: the work count against the package's own, the
nearest-rank percentile the readers use, the trace reduction on synthetic
events, and that importing the harness loads nothing it forbids. The
benchmark's own tests are ``benchmark/tests/`` (``python -m pytest
benchmark/tests`` in a process without JAX)."""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import timing, trace, work
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    _per_sample_work,
    rollout_cost_work,
)

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("unicycle", "steering_unicycle", "rate_limited_steering", "full_body")


# --- the work count ---------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("horizon", [15, 30])
@pytest.mark.parametrize("mode", [{}, {"second_moment": True}, {"accumulate": False},
                                  {"costs_in": True}])
def test_work_count_against_the_package_s(model, horizon, mode):
    """work.py counts from the algorithm, the package from its kernel
    source; where the two differ, PERF.md §6 says why: Box-Muller counts its
    integer-to-float conversions apart from their scalings (11 a pair
    against 10), the update its mask's select (+1), the tracking models carry
    7 scalar parameters (the kernel's vector 18), and the rollout and cost
    come from the model equations (within 5 % of the kernel's instruction
    count). Philox's integer instructions agree: 62 a call."""
    m2, acc, cin = (mode.get("second_moment", False), mode.get("accumulate", True),
                    mode.get("costs_in", False))
    ours = work.per_sample(model, horizon, horizon, **mode)
    pkg = _per_sample_work(model, horizon, horizon, m2, True, acc, cin)
    assert ours["philox"] == pkg["philox"]
    assert ours["box_muller"] * 10 == pkg["box_muller"] * 11
    assert ours["sample"] == pkg["sample"]
    assert ours["update"] == pkg["update"] + (1 if acc else 0)
    body, kernel = ours["rollout"] + ours["cost"], pkg["scan"] + pkg["step"]
    assert body == kernel == 0 if cin else abs(body / kernel - 1) < 0.05
    a = work.kernel_work(model, 102_400, horizon, **mode)
    b = rollout_cost_work(model, 102_400, horizon, horizon, **mode)
    assert a["bytes"] == b["bytes"] - (0 if model == "full_body" else 4 * 11)
    assert a["int_ops"] == b["int_ops"]


def test_bound_and_the_elite_update():
    w = work.kernel_work("full_body", 102_400, 30)
    ms, by = work.bound_ms(w)
    assert by == "operations" and ms == pytest.approx(w["int_ops"] / work.INT32_PEAK * 1e3)
    assert work.bound_ms({"flops": 0, "int_ops": 0, "bytes": 3.35e9})[1] == "bytes"
    elite = work.update_work("full_body", 102_400, 30, elite=True)
    one = work.kernel_work("full_body", 102_400, 30, accumulate=False)
    two = work.kernel_work("full_body", 102_400, 30, costs_in=True)
    assert elite == {k: one[k] + two[k] for k in one}
    fleet = work.update_work("unicycle", 1024, 15, num_robots=256)
    assert fleet["int_ops"] == 256 * work.kernel_work("unicycle", 1024, 15)["int_ops"]


# --- the percentile ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [10, 20, 200, 1000])
def test_percentile_is_the_nearest_rank(n):
    """At each p the value is the smallest sample with p % of the samples at
    or below it, whatever order the samples came in."""
    samples = [float(x) for x in range(n)]
    random.Random(n).shuffle(samples)
    for p in (1.0, 50.0, 95.0, 99.0, 100.0):
        want = min(x for x in samples if 100 * sum(s <= x for s in samples) >= p * n)
        assert timing.percentile(samples, p) == want, p


# --- the trace reduction ----------------------------------------------------------------

def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


MARK = "benchmark.unit"
EVENTS = [
    _ev("user_annotation", MARK, 0, 100),
    _ev("user_annotation", MARK, 100, 100),
    _ev("gpu_user_annotation", MARK, 10, 190),   # the device's copy: not a unit, not work
    _ev("cpu_op", "aten::sort", 20, 40),
    _ev("cpu_op", "aten::empty", 25, 2),
    _ev("cuda_runtime", "cudaGraphLaunch", 5, 3, corr=8),
    _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=7),
    _ev("gpu_memset", "Memset (Device)", -20, 5),   # before the window
    _ev("kernel", "rollout_cost_kernel<full_body>", 10, 10),
    _ev("kernel", "sort_kernel", 60, 20),
    _ev("gpu_memcpy", "Memcpy DtoH", 85, 5),
    _ev("kernel", "rollout_cost_kernel<full_body>", 110, 10, corr=8),   # launched in unit 0
    _ev("kernel", "sort_kernel", 160, 30, corr=7),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
]


def test_breakdown_of_a_synthetic_trace():
    bd = trace.breakdown(EVENTS, MARK, top=3)
    # busy [10,20] [60,80] [85,90] [110,120] [160,190] in the window [0, 200]
    assert bd["units"] == 2 and bd["window_us"] == 200
    assert bd["busy_us"] / bd["units"] == 37.5
    assert bd["device_idle_share"] == pytest.approx(1 - 75 / 200)
    assert bd["inside_idle_share"] == pytest.approx(1 - 75 / 200)
    assert bd["kernel_ms"] == pytest.approx(10e-3)
    assert bd["top_device_ops"] == [{"name": "sort_kernel", "us": 50},
                                    {"name": "rollout_cost_kernel<full_body>", "us": 20},
                                    {"name": "Memcpy DtoH", "us": 5}]
    # gaps 10, 40, 5, 20, 40, 10: the three longest, each named by the host
    # operation that overlapped it the most
    assert bd["longest_idle_gaps"] == [{"us": 40, "at_us": 20, "host_op": "aten::sort"},
                                       {"us": 40, "at_us": 120, "host_op": "cudaLaunchKernel"},
                                       {"us": 20, "at_us": 90, "host_op": "python"}]
    with pytest.raises(ValueError):
        trace.breakdown(EVENTS[2:], MARK)


def test_unit_ops_of_a_synthetic_trace():
    """Each device operation goes to the unit whose range its launch lies in,
    else to the last unit that started before it; one before every unit, or
    launched after its unit's range ended, is dropped."""
    late = [_ev("cuda_runtime", "cudaMemsetAsync", 210, 2, corr=9),
            _ev("gpu_memset", "Memset (Device)", 215, 3, corr=9)]
    u = trace.unit_ops(EVENTS + late, MARK)
    assert u["names"] == ["rollout_cost_kernel<full_body>", "sort_kernel", "Memcpy DtoH"]
    np.testing.assert_array_equal(u["unit_us"], [100, 100])
    np.testing.assert_array_equal(u["unit"], [0, 0, 0, 0, 1])
    np.testing.assert_array_equal(u["name"], [0, 1, 2, 0, 1])
    np.testing.assert_array_equal(u["start_us"], [10, 60, 85, 110, 60])
    np.testing.assert_array_equal(u["dur_us"], [10, 20, 5, 10, 30])
    per_unit = np.bincount(u["unit"], weights=u["dur_us"])
    np.testing.assert_array_equal(per_unit, [45, 30])
    assert per_unit.sum() == trace.breakdown(EVENTS, MARK)["busy_us"]


# --- nothing forbidden ------------------------------------------------------------------

IMPORT_ALL = """
import sys
import benchmark.harness, benchmark.timing, benchmark.trace, benchmark.work
import benchmark.work_refine, benchmark.reference, benchmark.reference_gn
bad = sorted(m for m in sys.modules if m.split(".")[0] in benchmark.harness.FORBIDDEN)
print("loaded:", bad)
sys.exit(1 if bad else 0)
"""


def test_importing_the_harness_loads_nothing_forbidden():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
