"""Synthetic sensors: the Gazebo side of the reference, as pure functions
(port of ``runtime/sim_sensors.py``).

The reference's full-body node estimates its state from Gazebo topics: IMU
orientation, rates and accelerations (imuCallback,
src/full_body_mppi.cpp:199-237) and six contact force sensors
(wrenchCallback :115-156, calc_true_ZMP :569-596). This module synthesizes
those measurements from plant truth so the complete sensing -> estimation ->
control stack runs in simulation:

    plant state + commands --sim_imu/sim_contact_forces--> measurements
    measurements --runtime/estimation.py--> estimated state + ZMP
    estimated state --solver--> commands
"""

from __future__ import annotations

from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.models.full_body import (
    CONTACT_POSITIONS,
    FullBodyParams,
    com_position,
)


def sim_imu(state, u, u_prev, dt, generator: Optional[torch.Generator] = None,
            accel_noise=0.0, gyro_noise=0.0, g=-9.81):
    """Synthesize IMU readings from full-body plant truth.

    state: (5,) = (x, y, yaw, roll, pitch); u/u_prev: (5,) current and
    previous applied controls. Returns dict(roll, pitch, yaw, omega (3,),
    accel_base (3,)); accel_base carries the gravity leakage the estimator
    is expected to compensate (estimation.gravity_compensate_accel removes
    -g*sin(pitch) from x). With a ``generator`` and a nonzero noise level,
    Gaussian noise is added to the accelerations, then to the rates, drawn
    from that generator (the JAX package splits a ``noise_key``).
    """
    yaw, roll, pitch = state[2], state[3], state[4]
    v, w = u[0], u[1]
    direction = u[2]
    drive_accel = (u[0] - u_prev[0]) / dt
    ac = v * w
    ax = drive_accel * torch.cos(direction) - ac * torch.sin(direction)
    ay = drive_accel * torch.sin(direction) + ac * torch.cos(direction)
    # gravity leakage into body x for a pitched IMU (the small-angle model the
    # reference compensates at src/full_body_mppi.cpp:234)
    accel = torch.stack([ax + g * torch.sin(pitch), ay, torch.zeros_like(ax)])
    omega = torch.stack([u[3], u[4], w])
    if generator is not None and (accel_noise or gyro_noise):
        accel = accel + accel_noise * torch.randn(3, generator=generator, dtype=accel.dtype,
                                                  device=accel.device)
        omega = omega + gyro_noise * torch.randn(3, generator=generator, dtype=omega.dtype,
                                                 device=omega.device)
    return {"roll": roll, "pitch": pitch, "yaw": yaw, "omega": omega, "accel_base": accel}


def sim_contact_forces(state, accel, params: FullBodyParams,
                       contact_positions=CONTACT_POSITIONS):
    """Synthesize the six contact-sensor forces of a quasi-static robot.

    Distributes weight + inertial reaction so the force-sensor ZMP
    (estimation.true_zmp_from_forces) reproduces the model ZMP: total normal
    force N = m*|g|, split between left and right wheels so the moment about
    x matches the lateral ZMP. Casters carry nothing (worst case). Returns
    (C, 3) forces in the base frame.
    """
    m = params.mass
    gmag = -params.gravity_z
    com = com_position(state[3], state[4], params)
    # lateral ZMP of the quasi-static model (hg_dot = 0)
    bz = m * params.gravity_z
    by = -m * accel[1]
    mo_x = com[1] * bz - com[2] * by
    zmp_y = mo_x / bz
    yl = float(contact_positions[0][1])
    yr = float(contact_positions[1][1])
    total = m * gmag
    # solve fl*yl + fr*yr = total*zmp_y, fl + fr = total
    fl = (total * (zmp_y - yr) / (yl - yr)).to(com.dtype)
    fr = total.to(com.dtype) - fl
    forces = torch.zeros((len(contact_positions), 3), dtype=com.dtype, device=com.device)
    forces[0, 2] = fl
    forces[1, 2] = fr
    return forces


def run_full_stack_experiment(roll_off: bool = False, cycles: int = 80,
                              num_samples: int = 256, seed: int = 0, horizon: int = 15,
                              use_kernel: bool = False, device=None):
    """Complete sensing -> estimation -> control pipeline on the full-body
    launch preset: the equivalent of the reference's Gazebo experiment (the
    controlled-vs-uncontrolled ZMP comparison of
    log/full_body/robo_sym/{controlled,uncontrolled}.png uses roll_off=False
    vs True), on ``device`` (None: the card, core/device.py).

    The controller consumes the estimated state (noisy IMU + force sensors
    through runtime/estimation.py); ``use_kernel`` runs its update in the
    fused kernel. The IMU noise comes from a ``torch.Generator`` seeded with
    ``seed``. Every cycle stays on the device; the logs are read back once
    at the end. Returns {"metrics", "traj" (cycles+1, 5), "zmp" (cycles,),
    "true_zmp" (cycles,)}.
    """
    import numpy as np

    from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
    from ccv_mppi_path_tracker_tpu_torch.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import default_params
    from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
    from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer
    from ccv_mppi_path_tracker_tpu_torch.runtime.estimation import (
        gravity_compensate_accel,
        lowpass,
        model_zmp_estimate,
        true_zmp_from_forces,
    )
    from ccv_mppi_path_tracker_tpu_torch.solver.mppi import MPPISolver

    device = resolve_device(device)
    cfg, sp, cp, course = full_body_launch(num_samples=num_samples, horizon=horizon,
                                           roll_off=roll_off, device=device)
    path = PathBuffer.from_points(course, 0.1, device=device)
    params = default_params(device=device)
    contacts = torch.as_tensor(CONTACT_POSITIONS, dtype=torch.float32, device=device)
    solver = MPPISolver(cfg, use_kernel=use_kernel)
    ctrl = solver.init(seed=seed, device=device)
    plant = get_model("full_body")
    dt = torch.full((), 0.1, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    slope = float(np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0]))
    truth = torch.tensor([course[0, 0], course[0, 1], slope, 0.0, 0.0], dtype=torch.float32,
                         device=device)
    u_prev_cmd = torch.zeros(5, device=device)
    last_hg = torch.zeros(3, device=device)
    zmp_est = torch.zeros(2, device=device)
    true_zmp = torch.zeros(3, device=device)

    traj, zmps, true_zmps = [truth], [], []
    for _ in range(cycles):
        # sensing (synthetic Gazebo)
        imu = sim_imu(truth, u_prev_cmd, u_prev_cmd, dt, generator=generator,
                      accel_noise=0.02, gyro_noise=0.005)
        forces = sim_contact_forces(truth, imu["accel_base"], params, contacts)
        # estimation (runtime/estimation.py); the reference zeroes a_z (:555)
        accel = gravity_compensate_accel(imu["accel_base"], imu["pitch"])
        accel = torch.cat([accel[:2], torch.zeros_like(accel[2:])])
        zmp_new, last_hg = model_zmp_estimate(imu["roll"], imu["pitch"], imu["omega"], accel,
                                              last_hg, dt, params)
        zmp_est = lowpass(zmp_est, zmp_new)
        true_zmp = true_zmp_from_forces(forces, true_zmp, contacts)
        est_state = torch.stack([truth[0], truth[1], imu["yaw"], imu["roll"], imu["pitch"]])
        # control on the estimated state
        ctrl, res = solver.step(ctrl, est_state, path, dt, sp, cp)
        u_prev_cmd = res.u0
        truth = plant.step(truth, res.u0, dt)
        traj.append(truth)
        zmps.append(zmp_est[1])
        true_zmps.append(true_zmp[1])

    traj = torch.stack(traj).cpu().numpy()
    return {
        "metrics": tracking_metrics(traj[:, :2], course),
        "traj": traj,
        "zmp": torch.stack(zmps).cpu().numpy(),
        "true_zmp": torch.stack(true_zmps).cpu().numpy(),
    }
