"""Command geometry: optimal solution -> actuator commands (port of
``solver/command.py``).

The reference maps the head of the optimal sequence to a ``Twist`` (v, w) and
a ``CmdPoseByRadian`` (left/right wheel steering angles, fore/rear pitch,
upper-body roll):

- diff-drive node: zero steering, constant pitch offset
  (src/diff_drive_mppi.cpp:255-263).
- steering node: turning-radius geometry R = |v/w|,
  steer_in  = atan2(R sin d, R cos d - tread/2),
  steer_out = atan2(R sin d, R cos d + tread/2),
  inner/outer assigned by the sign of w
  (src/steering_diff_drive_mppi.cpp:273-296). The IEEE quirks of the C++
  are kept bit-for-bit: w=0 gives R=inf and atan2(inf, inf) = pi/4 for both
  wheels (not the commanded direction); v=w=0 gives R=NaN and NaN steering
  angles. A consumer that needs safe angles gates on |w| (the reference
  publishes the NaN).
- full-body node: the same steering geometry on the ``direction`` control,
  plus the integrated, clamped upper-body roll command
  (src/full_body_mppi.cpp:246-275).

Everything runs on the device of ``u0`` and reads nothing back to the host.
The steering angles are computed in float64 and rounded to u0's dtype: the
card's float32 sin/cos/atan2 and the CPU's differ in the last place, the
rounded float64 results do not, so a command is the same on either device.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class WheelSteerCommand:
    """The full actuator command set (Twist + CmdPoseByRadian equivalents),
    0-d tensors on the device of the solution."""

    v: torch.Tensor
    w: torch.Tensor
    steer_l: torch.Tensor
    steer_r: torch.Tensor
    roll: torch.Tensor
    fore: torch.Tensor
    rear: torch.Tensor


# Steering-mode codes (steering_mode below). The reference returns strings
# from check_State (src/steering_diff_drive_mppi.cpp:84-95); integer codes
# keep the classifier a tensor op.
MODE_NO_NEED = 0  # opposite-sign angles ("ha"-shape): invalid, ROS_ERROR'd
MODE_NO_STEER = 1  # both ~zero: plain differential drive
MODE_PARALLEL = 2  # equal nonzero angles: crab motion
MODE_STEER = 3  # distinct same-sign angles: turning
STEERING_MODE_NAMES = ("no_need", "no_steer", "parallel", "steer")


def steering_mode(steer_r, steer_l, eps=0.1 * math.pi / 180.0):
    """Classify wheel steering angles into the reference's modes.

    Mirrors check_State (src/steering_diff_drive_mppi.cpp:84-95), which runs
    on every joint-state message and flags opposite-sign angles as invalid
    (:75-76). Same eps (0.1 deg) and branch order; returns an int64 tensor of
    MODE_* codes (names in STEERING_MODE_NAMES) on the device of the angles.
    """
    sr = torch.as_tensor(steer_r)
    sl = torch.as_tensor(steer_l)
    no_need = ((sr < 0.0) & (sl > 0.0)) | ((sr > 0.0) & (sl < 0.0))
    near_equal = torch.abs(sr - sl) < eps
    both_zero = (torch.abs(sr) < eps) & (torch.abs(sl) < eps)
    code = torch.where(
        near_equal,
        torch.where(both_zero, MODE_NO_STEER, MODE_PARALLEL),
        torch.full_like(sr, MODE_STEER, dtype=torch.int64),
    )
    return torch.where(no_need, MODE_NO_NEED, code)


def wheel_steer_angles(v, w, direction, tread):
    """(v, w, direction) -> (steer_l, steer_r) via turning-radius geometry,
    computed in float64 and returned in v's dtype."""
    dtype = v.dtype
    v, w, direction = (torch.as_tensor(x).to(torch.float64) for x in (v, w, direction))
    r = torch.abs(v / w)
    sin_d, cos_d = torch.sin(direction), torch.cos(direction)
    steer_in = torch.atan2(r * sin_d, r * cos_d - tread / 2.0)
    steer_out = torch.atan2(r * sin_d, r * cos_d + tread / 2.0)
    left_is_inner = w > 0.0
    steer_l = torch.where(left_is_inner, steer_in, steer_out)
    steer_r = torch.where(left_is_inner, steer_out, steer_in)
    return steer_l.to(dtype), steer_r.to(dtype)


def wheel_speeds(v, w, steer_l, steer_r, tread=0.501, wheel_radius=0.1435):
    """Left/right wheel angular velocities (rad/s) for the commanded motion.

    Completes the actuation chain the reference delegates to its downstream
    diff-drive controller. Without steering, the classic differential split
    vl,r = v -+ w*tread/2. With distinct same-sign steering angles the wheels
    ride different turning radii Rl = sin|dr| L / sin|dl - dr| (the relation
    of the feasibility analysis, src/v_w_performance.py:43-45), so the
    speed split becomes (vr - vl) = w * |Rr - Rl|.
    """
    sl, sr = steer_l, steer_r
    parallel = torch.abs(sl - sr) < 1e-6
    rl = torch.sin(torch.abs(sr)) * tread / torch.sin(torch.abs(sl - sr) + 1e-12)
    rr = torch.sin(torch.abs(sl)) * tread / torch.sin(torch.abs(sr - sl) + 1e-12)
    split = torch.where(parallel, tread, torch.abs(rr - rl))
    vl = v - w * split / 2.0
    vr = v + w * split / 2.0
    return vl / wheel_radius, vr / wheel_radius


def _on(x, ref):
    """``x`` (a number or a tensor) as a 0-d tensor of ref's dtype and
    device; a number becomes a fill on the device, not a host copy."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=ref.dtype, device=ref.device)
    return torch.full((), float(x), dtype=ref.dtype, device=ref.device)


def command_from_solution(
    model_name: str,
    u0,
    dt,
    tread: float = 0.501,
    pitch_offset: float = 0.0,
    current_roll=0.0,
    current_steer=0.0,
    roll_min: float = -0.5235987755982988,
    roll_max: float = 0.5235987755982988,
    roll_off: bool = False,
    steer_off: bool = False,
) -> WheelSteerCommand:
    """Build the actuator command from the head u0 (U,) of the optimal
    sequence, on u0's device."""
    zero = torch.zeros_like(u0[0])
    v, w = u0[0], u0[1]
    po = _on(pitch_offset, u0)

    if model_name == "unicycle":
        steer_l = steer_r = zero
        roll = zero
    else:
        if model_name == "rate_limited_steering":
            # u0[2] is a steering rate; the commanded angle is the measured
            # servo angle advanced one step, as the full-body node integrates
            # its roll (src/full_body_mppi.cpp:266)
            direction = current_steer + u0[2] * dt
        else:
            direction = u0[2]
        if steer_off:
            steer_l = steer_r = zero
        else:
            steer_l, steer_r = wheel_steer_angles(v, w, direction, tread)
        if model_name == "full_body":
            roll = torch.clamp(current_roll + u0[3] * dt, roll_min, roll_max)
            if roll_off:
                roll = zero
        else:
            roll = zero

    return WheelSteerCommand(
        v=v, w=w, steer_l=steer_l, steer_r=steer_r, roll=roll, fore=po, rear=po
    )
