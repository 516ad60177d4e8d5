"""State-estimation adapters as pure functions (port of
``runtime/estimation.py``).

The reference performs estimation inside ROS callbacks: IMU frame rotation
and gravity compensation in imuCallback (src/full_body_mppi.cpp:199-237),
force-sensor rotation in wrenchCallback (:115-156), ZMP estimation plus
low-pass in get_CurrentState (:528-567), mutating shared members without
locks. Here each piece is a pure tensor function over explicit state, on
the device of its inputs.
"""

from __future__ import annotations

import torch

from ccv_mppi_path_tracker_tpu_torch.models.full_body import (
    CONTACT_POSITIONS,
    FullBodyParams,
    com_position,
    zmp_from_model,
)

# Low-pass coefficient (full_body_mppi.h:218).
LOWPASS_ALPHA = 0.3
# Gravity constant of the IMU compensation (full_body_mppi.h:32); the
# reference uses -9.81 here but -9.8 in the ZMP model, and both are kept.
G_IMU = -9.81


def quat_to_rpy(qx, qy, qz, qw):
    """Quaternion -> (roll, pitch, yaw), ZYX convention (tf::getRPY)."""
    sinr = 2.0 * (qw * qx + qy * qz)
    cosr = 1.0 - 2.0 * (qx * qx + qy * qy)
    roll = torch.atan2(sinr, cosr)
    sinp = torch.clamp(2.0 * (qw * qy - qz * qx), -1.0, 1.0)
    pitch = torch.asin(sinp)
    siny = 2.0 * (qw * qz + qx * qy)
    cosy = 1.0 - 2.0 * (qy * qy + qz * qz)
    yaw = torch.atan2(siny, cosy)
    return roll, pitch, yaw


def gravity_compensate_accel(accel_base, pitch, g=G_IMU):
    """Remove the gravity leakage from the x acceleration
    (src/full_body_mppi.cpp:234: ``accel_x -= g*sin(imu_pitch_)``)."""
    ax = accel_base[..., 0] + -g * torch.sin(pitch)
    return torch.cat([ax[..., None], accel_base[..., 1:]], dim=-1)


def lowpass(prev, new, alpha=LOWPASS_ALPHA):
    """First-order IIR low-pass (src/full_body_mppi.cpp:565-566)."""
    return alpha * new + (1.0 - alpha) * prev


def model_zmp_estimate(roll, pitch, omega, accel, last_hg, dt, params: FullBodyParams):
    """IMU-based ZMP estimate (get_CurrentState, src/full_body_mppi.cpp:554-561).

    omega: (..., 3) measured angular velocity; accel: (..., 3) base-frame
    linear acceleration with z zeroed by the caller (:555 passes a_z = 0).
    Returns (zmp (..., 2), hg (..., 3)); carry hg to the next cycle for the
    finite-difference angular-momentum derivative.
    """
    com = com_position(roll, pitch, params)
    hg = params.inertia * omega
    hg_dot = (hg - last_hg) / dt
    zmp = zmp_from_model(com, accel, hg_dot, params)
    return zmp, hg


def rotate_force_to_base(force, rotation):
    """Rotate a raw sensor-frame force into the robot base frame.

    The reference does this per wrench message with the tf basis matrix of
    the wheel link (wrenchCallback, src/full_body_mppi.cpp:124-130:
    ``transform_.getBasis() * force``). ``rotation`` is the (..., 3, 3)
    sensor->base rotation; ``force`` is (..., 3). Batched over leading dims.
    """
    return torch.einsum("...ij,...j->...i", rotation, force)


def true_zmp_from_forces(forces, prev_zmp, contact_positions=CONTACT_POSITIONS,
                         alpha=LOWPASS_ALPHA, eps=1e-6):
    """Force-sensor ground-truth ZMP (calc_true_ZMP, src/full_body_mppi.cpp:569-596).

    forces: (C, 3) contact forces in the base frame; contacts with
    non-positive normal force are excluded (:581). ZMP = n x (sum r_i x f_i)
    / (sum f_i . n) with floor normal n = z, low-passed against prev_zmp;
    when the normal-force sum is below eps the previous value is returned
    unchanged (:589-592). Returns the (3,) low-passed ZMP (z is 0 by
    construction).
    """
    positions = torch.as_tensor(contact_positions, dtype=forces.dtype, device=forces.device)
    in_contact = forces[:, 2] > 0.0
    f = torch.where(in_contact[:, None], forces, 0.0)
    sum_f = torch.sum(f, dim=0)
    sum_m = torch.sum(torch.linalg.cross(positions, f), dim=0)
    denom = sum_f[2]  # sum F . z
    n = torch.zeros(3, dtype=forces.dtype, device=forces.device)
    n[2] = 1.0
    numer = torch.linalg.cross(n, sum_m)
    zmp = alpha * (numer / denom) + (1.0 - alpha) * prev_zmp
    return torch.where(torch.abs(denom) < eps, prev_zmp, zmp)
