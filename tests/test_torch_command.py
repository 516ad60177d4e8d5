"""The port's command geometry (solver/command.py) against the JAX package's,
on the same inputs made from a seed with NumPy: wheel_steer_angles,
wheel_speeds, command_from_solution for the four models and steering_mode.

Tolerance: rtol 1e-12 at float64, rtol 1e-6 at float32 (the port computes
the steering angles in float64 and rounds them; JAX computes them in
float32). The IEEE quirks are held exactly: the NaN positions are equal,
and w=0 gives pi/4 for both wheels.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.solver import command as jax_command
from ccv_mppi_path_tracker_tpu_torch.solver import command

TREAD = 0.501
TOL = {np.float64: dict(rtol=1e-12, atol=0.0), np.float32: dict(rtol=1e-6, atol=0.0)}
DTYPES = {np.float64: torch.float64, np.float32: torch.float32}
MODELS = {"unicycle": 2, "steering_unicycle": 3, "rate_limited_steering": 3,
          "full_body": 5}


def _u0s(u_dim, dtype, n=24, seed=0):
    """n random commands and the quirk rows: w=0 with direction +, - and 0,
    and v=w=0."""
    rng = np.random.RandomState(seed)
    u = np.stack([rng.uniform(-2.0, 2.0, n), rng.uniform(-1.0, 1.0, n)]
                 + [rng.uniform(-0.5, 0.5, n) for _ in range(u_dim - 2)], axis=-1)
    quirks = np.zeros((4, u_dim))
    quirks[:3, 0] = 1.0
    if u_dim > 2:
        quirks[:3, 2] = (0.2, -0.2, 0.0)
    return np.concatenate([u, quirks]).astype(dtype)


def _same(port, ref, tol):
    """Equal NaN positions; the finite entries within tol."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_allclose(port, ref, equal_nan=True, **tol)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_wheel_steer_angles_match_jax(np_dtype):
    u = _u0s(3, np_dtype, n=200)
    v, w, d = u[:, 0], u[:, 1], u[:, 2]
    sl, sr = command.wheel_steer_angles(*(torch.as_tensor(x) for x in (v, w, d)), TREAD)
    jsl, jsr = jax_command.wheel_steer_angles(*(jnp.asarray(x) for x in (v, w, d)), TREAD)
    _same(sl, jsl, TOL[np_dtype])
    _same(sr, jsr, TOL[np_dtype])
    # w = 0: R = inf and atan2(+-inf, inf) = +-pi/4 for both wheels; v = w = 0: NaN
    quarter = np_dtype(math.pi / 4)
    assert sl[-4] == sr[-4] == quarter and sl[-3] == sr[-3] == -quarter
    assert torch.isnan(sl[-2]) and torch.isnan(sl[-1]) and torch.isnan(sr[-1])


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_wheel_speeds_match_jax(np_dtype):
    u = _u0s(3, np_dtype, n=200, seed=1)[:-4]
    v, w, d = u[:, 0], u[:, 1], u[:, 2]
    jsl, jsr = jax_command.wheel_steer_angles(*(jnp.asarray(x) for x in (v, w, d)), TREAD)
    sl, sr = np.array(jsl), np.array(jsr)
    sl[:20] = sr[:20]  # parallel wheels: the classic differential split
    sl[20:30] = sr[20:30] = 0.0
    got = command.wheel_speeds(*(torch.as_tensor(x) for x in (v, w, sl, sr)))
    ref = jax_command.wheel_speeds(*(jnp.asarray(x) for x in (v, w, sl, sr)))
    for a, b in zip(got, ref):
        _same(a, b, TOL[np_dtype])


_CMD_CASES = [(m, {}) for m in MODELS] + [
    ("unicycle", {"pitch_offset": 0.05}),
    ("full_body", {"pitch_offset": -0.03, "current_roll": 0.2}),
    ("full_body", {"current_roll": 0.45}),  # the roll clamp at +-30 deg
    ("full_body", {"current_roll": 0.1, "roll_off": True}),
    ("full_body", {"steer_off": True}),
    ("steering_unicycle", {"steer_off": True}),
    ("rate_limited_steering", {"current_steer": 0.3}),
    ("rate_limited_steering", {"current_steer": -0.1, "steer_off": True}),
]


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("model,kw", _CMD_CASES,
                         ids=[f"{m}-{'-'.join(kw) or 'plain'}" for m, kw in _CMD_CASES])
def test_command_from_solution_matches_jax(model, kw, np_dtype):
    fields = ("v", "w", "steer_l", "steer_r", "roll", "fore", "rear")
    for u0 in _u0s(MODELS[model], np_dtype, n=12, seed=len(kw)):
        got = command.command_from_solution(model, torch.as_tensor(u0), 0.1, **kw)
        ref = jax_command.command_from_solution(model, jnp.asarray(u0), 0.1, **kw)
        for f in fields:
            _same(getattr(got, f), getattr(ref, f), TOL[np_dtype])
            assert getattr(got, f).dtype == DTYPES[np_dtype]
        if model == "unicycle" or kw.get("steer_off"):
            assert float(got.steer_l) == float(got.steer_r) == 0.0
        if model == "full_body" and not kw.get("roll_off"):
            assert abs(float(got.roll)) <= 0.5235987755982988


def test_command_quirks_are_kept_exactly():
    cmd = command.command_from_solution("steering_unicycle",
                                        torch.tensor([1.0, 0.0, 0.2]), 0.1)
    assert cmd.steer_l == cmd.steer_r == np.float32(math.pi / 4)
    cmd = command.command_from_solution("full_body", torch.zeros(5, dtype=torch.float64),
                                        0.1)
    assert torch.isnan(cmd.steer_l) and torch.isnan(cmd.steer_r)


def test_steering_mode_grid_matches_jax():
    """Every pair of angles on a grid that straddles the 0.1 deg eps."""
    eps = 0.1 * math.pi / 180.0
    ticks = np.array([-0.3, -eps * 1.001, -eps, -eps * 0.999, -1e-9, 0.0, 1e-9,
                      eps * 0.5, eps * 0.999, eps, eps * 1.001, eps * 1.5, 0.3, 0.3 + eps])
    sr, sl = (a.ravel() for a in np.meshgrid(ticks, ticks))
    got = command.steering_mode(torch.as_tensor(sr), torch.as_tensor(sl))
    ref = jax_command.steering_mode(jnp.asarray(sr), jnp.asarray(sl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int64
    assert set(got.tolist()) == {command.MODE_NO_NEED, command.MODE_NO_STEER,
                                 command.MODE_PARALLEL, command.MODE_STEER}
    assert command.STEERING_MODE_NAMES == jax_command.STEERING_MODE_NAMES
    # the branch order of check_State: the sign check wins at tiny angles
    assert int(command.steering_mode(-1e-9, 1e-9)) == command.MODE_NO_NEED
