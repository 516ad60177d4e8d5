"""scripts/torch_eager_breakdown.py, the twin of scripts/xla_breakdown.py,
on the CPU: its stages are the JAX script's, its triangular-product
rollout equals the closed form (float64, rtol 1e-12), and without a card it
refuses and prints no result. The card runs the stages as CUDA graphs:
chip_smoke.py phase 35 (``--quick``)."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu_torch.ops.rollout import rollout_closed_form

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_eager_breakdown as twin  # noqa: E402


def test_the_stages_are_the_jax_script_s():
    jax_script = (ROOT / "scripts" / "xla_breakdown.py").read_text()
    names = set(re.findall(r'results\["(\w+)"\] = timed\(', jax_script))
    assert names == set(twin.STAGES) | {"rollout_trimatmul"}


@pytest.mark.parametrize("k,horizon", [(7, 5), (64, 30)])
def test_the_triangular_product_rollout_is_the_closed_form(k, horizon):
    rng = np.random.RandomState(horizon)
    u = torch.tensor(rng.randn(horizon - 1, k, 5) * 0.5)
    state0 = torch.tensor(rng.randn(5) * 0.3)
    dt = torch.tensor(0.1, dtype=torch.float64)
    got = twin.trimatmul_rollout(state0, u, dt)
    want = rollout_closed_form("full_body", state0.expand(k, -1), u, dt)
    assert got.shape == want.shape == (horizon, k, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_without_a_card_it_refuses_and_prints_no_result(tmp_path):
    out = tmp_path / "breakdown.json"
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_eager_breakdown.py"),
                           "--quick", "--out", str(out)], capture_output=True, text=True,
                          timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1 and proc.stdout == "" and not out.exists()
    assert "NVIDIA card" in proc.stderr


def test_the_committed_breakdown_is_a_flagship_card_run():
    rec = json.loads((ROOT / "artifacts" / "eager_breakdown_torch.json").read_text())
    assert not rec["quick"] and (rec["num_samples"], rec["horizon"]) == (102_400, 30)
    assert "H100" in rec["card"] and " W" in rec["card"]
    assert list(rec["stages"]) == ["sample", "rollout_cumsum", "rollout_trimatmul", "zmp",
                                   "cost", "softmax_update", "whole"]
    stages = rec["stages"]
    assert rec["sum_of_stages_ms"] == pytest.approx(sum(stages[n]["ms"] for n in twin.STAGES))
    assert rec["whole_ms"] == stages["whole"]["ms"]
    for row in stages.values():
        assert row["share_of_whole"] == pytest.approx(row["ms"] / rec["whole_ms"])
        assert row["launches"] >= 1
