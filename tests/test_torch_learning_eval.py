"""The port's learned-method claims (``scripts/torch_learning_eval.py``)
against the JAX package's script (``scripts/learning_eval.py``): ``--quick``
on the CPU writes the JAX artifact's keys, key for key, plus the device, its
power limit and each study's wall seconds, every value finite; ``_wilson_ci``
equals the JAX script's; the claims' directions read from the JAX artifact;
and the committed H100 artifact's schema."""

import json
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import learning_eval as jle  # noqa: E402  (its top level imports no jax)
import torch_learning_eval as tle  # noqa: E402
from test_torch_realtime import one_torch_thread  # noqa: E402,F401  (autouse)

JAX_ARTIFACT = ROOT / "artifacts" / "learning_eval.json"
ARTIFACT = ROOT / "artifacts" / "learning_eval_torch.json"
STUDIES = ("learned_sampler", "learned_optimizer", "learned_sampler_closed_loop",
           "learned_optimizer_closed_loop")


def _keys(obj, prefix=()):
    """The key paths of a JSON object, lists as leaves."""
    if isinstance(obj, dict):
        return {p for k, v in obj.items() for p in _keys(v, prefix + (k,))} | {prefix}
    return {prefix}


def _numbers(obj):
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _numbers(v)]
    if isinstance(obj, list):
        return [x for v in obj for x in _numbers(v)]
    return [obj] if isinstance(obj, (int, float)) and not isinstance(obj, bool) else []


def _schema(out):
    """The port's output has the JAX artifact's keys, key for key, and adds
    only the device, its power limit and each study's wall seconds."""
    ref = json.loads(JAX_ARTIFACT.read_text())
    added = {("device",), ("power_limit",)} | {(s, "wall_seconds") for s in STUDIES}
    assert _keys(out) == _keys(ref) | added
    for study in STUDIES:
        assert list(out[study])[:-1] == list(ref[study])


def test_quick_on_the_cpu_has_the_jax_artifact_s_keys(tmp_path):
    out_path = tmp_path / "quick.json"
    assert tle.main(["--quick", "--device", "cpu", "--out", str(out_path)]) == 0
    out = json.loads(out_path.read_text())
    _schema(out)
    assert out["device"] == "cpu" and out["power_limit"] is None
    numbers = _numbers({k: v for k, v in out.items() if k != "power_limit"})
    assert numbers and all(math.isfinite(x) for x in numbers)
    sizes = tle.QUICK
    assert out["learned_sampler"]["trials"] == sizes["trials"]
    assert out["learned_sampler_closed_loop"]["trials"] == sizes["closed_trials"]
    assert len(out["learned_sampler_closed_loop"]["per_trial_rmse"]["cold"]) == (
        sizes["closed_trials"])
    assert out["learned_optimizer_closed_loop"]["num_steps"] == sizes["l2o_steps"]


@pytest.mark.parametrize("n", [0, 1, 6, 24, 40])
def test_wilson_ci_equals_the_jax_script_s(n):
    for wins in range(n + 1):
        assert tle._wilson_ci(wins, n) == jle._wilson_ci(wins, n)


def test_the_full_sizes_are_the_jax_script_s():
    """scripts/learning_eval.py:44-51, :103-106, :135, :227, :308."""
    assert tle.FULL == {"trials": 24, "imitation_states": 96, "fit_steps": 300,
                        "meta_steps": 120, "closed_trials": 40, "cycles": 50,
                        "l2o_steps": 150}


def test_every_claim_of_the_jax_artifact_points_its_own_way():
    directions = tle.directions(json.loads(JAX_ARTIFACT.read_text()))
    assert len(directions) == 4
    assert all(held for held, _ in directions.values()), directions


def test_the_committed_artifact_comes_from_the_card_and_points_the_jax_way():
    out = json.loads(ARTIFACT.read_text())
    _schema(out)
    assert out["device"].startswith("NVIDIA") and out["power_limit"].endswith("W")
    assert out["learned_sampler"]["trials"] == 24
    assert out["learned_sampler_closed_loop"]["trials"] == 40
    assert out["learned_optimizer_closed_loop"]["num_steps"] == 150
    assert all(math.isfinite(x) for x in _numbers(out))
    directions = tle.directions(out)
    assert all(held for held, _ in directions.values()), directions
