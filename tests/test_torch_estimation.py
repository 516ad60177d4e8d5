"""The port's estimation adapters and synthetic sensors against the JAX
package's, float64 rtol 1e-12, on inputs made from a seed with NumPy; and
the port's full sensing -> estimation -> control stack at K=256 on the CPU,
held to tests/test_full_stack_sim.py's two assertions (the random streams of
the two packages differ, so the closed loop is held to its properties, not
to JAX's trajectory)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.runtime import estimation as jax_est
from ccv_mppi_path_tracker_tpu.runtime import sim_sensors as jax_sensors
from ccv_mppi_path_tracker_tpu_torch.models.full_body import CONTACT_POSITIONS, default_params
from ccv_mppi_path_tracker_tpu_torch.runtime import estimation as est
from ccv_mppi_path_tracker_tpu_torch.runtime import sim_sensors as sensors
from test_torch_realtime import one_torch_thread  # noqa: F401  (autouse: small closed loops)

TOL = dict(rtol=1e-12, atol=1e-15)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float64))


def close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def _params():
    return default_params(device="cpu", dtype=torch.float64), jax_default_params(np.float64)


def test_quat_to_rpy_matches_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(64, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = [0.5, 0.5, 0.5, 0.5]  # pitch at +90 deg: the clip
    for got, ref in zip(est.quat_to_rpy(*(_t(c) for c in q.T)),
                        jax_est.quat_to_rpy(*(_j(c) for c in q.T))):
        close(got, ref)


def test_gravity_compensate_and_lowpass_match_jax():
    rng = np.random.RandomState(1)
    accel, pitch = rng.randn(8, 3), rng.randn(8) * 0.3
    close(est.gravity_compensate_accel(_t(accel), _t(pitch)),
          jax_est.gravity_compensate_accel(_j(accel), _j(pitch)))
    close(est.gravity_compensate_accel(_t(accel[0]), _t(pitch[0]), g=-9.8),
          jax_est.gravity_compensate_accel(_j(accel[0]), _j(pitch[0]), g=-9.8))
    prev, new = rng.randn(2, 5)
    close(est.lowpass(_t(prev), _t(new)), jax_est.lowpass(_j(prev), _j(new)))
    close(est.lowpass(_t(prev), _t(new), alpha=0.7), jax_est.lowpass(_j(prev), _j(new), 0.7))


def test_model_zmp_estimate_matches_jax():
    rng = np.random.RandomState(2)
    roll, pitch = rng.randn(2, 6) * 0.2
    omega, accel, last_hg = rng.randn(3, 6, 3)
    accel[:, 2] = 0.0
    mp, jmp = _params()
    got = est.model_zmp_estimate(_t(roll), _t(pitch), _t(omega), _t(accel), _t(last_hg),
                                 0.1, mp)
    ref = jax_est.model_zmp_estimate(_j(roll), _j(pitch), _j(omega), _j(accel),
                                     _j(last_hg), 0.1, jmp)
    for a, b in zip(got, ref):
        close(a, b)


def test_rotate_force_to_base_matches_jax():
    rng = np.random.RandomState(3)
    rot = np.linalg.qr(rng.randn(6, 3, 3))[0]
    force = rng.randn(6, 3)
    close(est.rotate_force_to_base(_t(force), _t(rot)),
          jax_est.rotate_force_to_base(_j(force), _j(rot)))


@pytest.mark.parametrize("case", ["mixed", "no_contact"])
def test_true_zmp_from_forces_matches_jax(case):
    rng = np.random.RandomState(4)
    forces = rng.randn(6, 3) * 50.0
    forces[:2, 2] = [300.0, 280.0]
    forces[4, 2] = -5.0  # lifted off: excluded
    if case == "no_contact":
        forces[:, 2] = -1.0  # the normal-force sum under eps: prev is kept
    prev = rng.randn(3) * 0.01
    got = est.true_zmp_from_forces(_t(forces), _t(prev))
    close(got, jax_est.true_zmp_from_forces(_j(forces), _j(prev)))
    if case == "no_contact":
        close(got, prev)


def test_sim_imu_without_noise_matches_jax():
    rng = np.random.RandomState(5)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        state, u, u_prev = rng.randn(5) * 0.3, rng.randn(5), rng.randn(5)
        got = sensors.sim_imu(_t(state), _t(u), _t(u_prev), 0.1, generator=gen)
        ref = jax_sensors.sim_imu(_j(state), _j(u), _j(u_prev), 0.1)
        assert sorted(got) == sorted(ref)
        for k in ref:
            close(got[k], ref[k])
    # a zero noise level draws nothing from the generator
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(0).get_state())


def test_sim_imu_noise_comes_from_the_generator():
    state, u = _t(np.zeros(5)), _t(np.ones(5) * 0.2)

    def noisy(seed):
        gen = torch.Generator().manual_seed(seed)
        return sensors.sim_imu(state, u, u, 0.1, generator=gen, accel_noise=0.02,
                               gyro_noise=0.005)

    quiet = sensors.sim_imu(state, u, u, 0.1)
    a, b, c = noisy(3), noisy(3), noisy(4)
    assert torch.equal(a["accel_base"], b["accel_base"]) and torch.equal(a["omega"], b["omega"])
    assert not torch.equal(a["accel_base"], c["accel_base"])
    assert float((a["accel_base"] - quiet["accel_base"]).abs().max()) < 0.02 * 6
    assert float((a["omega"] - quiet["omega"]).abs().max()) < 0.005 * 6


def test_sim_contact_forces_match_jax():
    rng = np.random.RandomState(6)
    mp, jmp = _params()
    for _ in range(5):
        state, accel = rng.randn(5) * 0.2, rng.randn(3)
        got = sensors.sim_contact_forces(_t(state), _t(accel), mp)
        close(got, jax_sensors.sim_contact_forces(_j(state), _j(accel), jmp))
        # the force-sensor ZMP of these forces is the model's lateral ZMP
        close(got.sum(0)[:2], np.zeros(2))
    close(est.true_zmp_from_forces(got, torch.zeros(3, dtype=torch.float64), alpha=1.0),
          jax_est.true_zmp_from_forces(_j(got), _j(np.zeros(3)), alpha=1.0))
    np.testing.assert_array_equal(CONTACT_POSITIONS, jax_est.CONTACT_POSITIONS)


def test_full_stack_estimation_in_the_loop():
    out = sensors.run_full_stack_experiment(roll_off=True, device="cpu")
    m = out["metrics"]
    assert m["rmse"] < 0.2, m
    assert out["traj"].shape == (81, 5) and out["traj"][-1, 0] > 5.0
    assert np.isfinite(out["zmp"]).all() and np.isfinite(out["true_zmp"]).all()
    # the two ZMP estimates agree in steady state (quasi-static correlation)
    assert np.max(np.abs(out["zmp"][20:] - out["true_zmp"][20:])) < 0.08


def test_zmp_cost_reduces_lateral_zmp():
    """The reference's controlled-vs-uncontrolled experiment: the ZMP cost
    (roll_off=False, zmp_weight=10) shrinks the peak lateral ZMP."""
    uncontrolled = sensors.run_full_stack_experiment(roll_off=True, device="cpu")
    controlled = sensors.run_full_stack_experiment(roll_off=False, device="cpu")
    peak_u = np.max(np.abs(uncontrolled["true_zmp"][5:]))
    peak_c = np.max(np.abs(controlled["true_zmp"][5:]))
    assert peak_c < peak_u, (peak_c, peak_u)
    assert controlled["metrics"]["rmse"] < 0.3, controlled["metrics"]
