"""The port's profiling utilities (utils/profiling.py) and the ``profile``
command on the CPU, the twins of tests/test_gating_profiling.py:39-49 and
tests/test_cli_and_plots.py:179-191."""

import json
import os

import torch

from ccv_mppi_path_tracker_tpu_torch import cli
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import fused_sample_rollout_cost
from ccv_mppi_path_tracker_tpu_torch.utils.profiling import PhaseTimer, device_trace


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b", block_on=[torch.ones(2), {"x": torch.zeros(1)}]):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0
    assert s["a"]["mean_ms"] == 1e3 * s["a"]["total_s"] / 2


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "tr")) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert any(a.key == "aten::mm" for a in prof.key_averages())


def test_profile_command_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "trace")
    before = fused_sample_rollout_cost.launches
    rc = cli.main(["profile", "--device", "cpu", "--preset", "diff_drive", "--steps", "5",
                   "--num-samples", "128", "--kernel", "--out", out])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "solver path: fused kernel on cpu"
    summary = json.loads(lines[-2])
    assert summary["control_cycle"]["count"] == 5 and summary["warm_step"]["count"] == 1
    # the registry's spans: the phases, and the compiled call's wrap-in (the
    # caller's and the graph's), recorded inside the trace only; the CPU
    # replays no graph, so it copies nothing in
    spans = summary["spans"]
    assert spans["control_cycle"] == {k: summary["control_cycle"][k]
                                      for k in ("count", "total_s")}
    assert spans["warm_step"]["count"] == 1 and spans["compiled.wrap_in"]["count"] == 10
    assert summary["counters"] == {}
    assert lines[-1].startswith(f"trace: {os.path.join(out, 'trace.json')}")
    assert os.path.isfile(os.path.join(out, "trace.json"))
    assert fused_sample_rollout_cost.launches == before  # the CPU runs the plain version
