"""The port's eager ops against the JAX package's, at float64.

Inputs are made with numpy from a seed and handed to both packages;
tolerances are tests/test_solver_parity.py's (rtol 1e-9, atol 1e-12): the
two evaluate the same expressions, so they differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core.config import full_body_config as jax_full_body_config
from ccv_mppi_path_tracker_tpu.kernels.rollout_cost import pack_scalars as jax_pack_scalars
from ccv_mppi_path_tracker_tpu.models import full_body as jfb
from ccv_mppi_path_tracker_tpu.ops import costs as jcosts
from ccv_mppi_path_tracker_tpu.ops import mindist as jmindist
from ccv_mppi_path_tracker_tpu.ops.rollout import rollout as jax_rollout
from ccv_mppi_path_tracker_tpu.ops.rollout import rollout_closed_form as jax_rollout_cf
from ccv_mppi_path_tracker_tpu.ops import sampling as jsampling
from ccv_mppi_path_tracker_tpu.ops import softmax_update as jsoftmax
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.paths.resample import nearest_index as jax_nearest_index
from ccv_mppi_path_tracker_tpu.paths import resample_reference as jax_resample
from ccv_mppi_path_tracker_tpu.core.types import RefWindow as JaxRefWindow
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import NSCAL, pack_scalars
from ccv_mppi_path_tracker_tpu_torch.models import full_body as tfb
from ccv_mppi_path_tracker_tpu_torch.ops import mindist as tmindist
from ccv_mppi_path_tracker_tpu_torch.ops.costs import full_body_cost
from ccv_mppi_path_tracker_tpu_torch.ops.rollout import rollout, rollout_closed_form
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import (
    color_noise,
    draw_standard_normals,
    sample_controls,
)
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import softmax_weights, weighted_update
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, nearest_index, resample_reference
from ccv_mppi_path_tracker_tpu_torch.paths.courses import sum_of_cosines_course

TOL = dict(rtol=1e-9, atol=1e-12)
T, K = 12, 64


def close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


_SP = {n: 0.0 for n in ("control_noise", "lam", "u_min", "u_max", "noise_beta")}
_CP = {n: 0.0 for n in ("v_ref", "path_weight", "v_weight", "zmp_weight",
                        "roll_v_weight", "back_weight", "yaw_weight")}
_PATH = {"xy": np.zeros((2, 2)), "num_valid": 2, "resolution": 0.1}


def to_port(sp=_SP, cp=_CP, mp=None, dtype=torch.float64):
    """(SolverParams, CostParams, FullBodyParams) of the port from the JAX
    package's objects."""
    return from_numpy(sp, cp, mp, np.zeros(1), _PATH, dtype=dtype)[:3]


def _course():
    return sum_of_cosines_course(amplitudes=(1.0, 0.3, 0.0),
                                 frequencies=(0.25, 0.5, 0.0),
                                 resolution=0.1, course_length=12.0)


def _rollout_inputs(seed=0):
    rng = np.random.RandomState(seed)
    state0 = np.array([0.3, -0.4, 0.2, 0.05, -0.02])
    controls = rng.randn(T - 1, K, 5) * 0.5
    return state0, controls


def _params():
    jp = jfb.default_params(np.float64)
    return jp, to_port(mp=jp)[2]


def test_courses_match():
    from ccv_mppi_path_tracker_tpu.paths import sum_of_cosines_course as jcourse

    kw = dict(amplitudes=(1.5, 0.2, 0.0), frequencies=(0.127, 0.4, 0.0),
              deltas=(0.0, 0.3, 0.0), resolution=0.1, course_length=20.0)
    np.testing.assert_array_equal(sum_of_cosines_course(**kw), jcourse(**kw))


@pytest.mark.parametrize("far", [False, True])
def test_min_sq_distance(far):
    rng = np.random.RandomState(1)
    ref = np.cumsum(rng.rand(15, 2) * 0.3, axis=0) + 5.0
    xy = ref[0] + rng.randn(3, 50, 2) * (200.0 if far else 1.0)
    got = tmindist.min_sq_distance(torch.as_tensor(xy), torch.as_tensor(ref))
    assert got.shape == (3, 50)
    close(got, jmindist.min_sq_distance(jnp.asarray(xy), jnp.asarray(ref)))
    if far:
        assert float(got.max()) == tmindist.DIST_CAP**2


def test_min_sq_distance_chunked_equals_unchunked(monkeypatch):
    rng = np.random.RandomState(2)
    ref = torch.as_tensor(rng.randn(9, 2))
    xy = torch.as_tensor(rng.randn(7, 13, 2))
    whole = tmindist.min_sq_distance(xy, ref)
    monkeypatch.setattr(tmindist, "_CHUNK_ELEMS", 20)  # 2 positions a chunk
    assert torch.equal(tmindist.min_sq_distance(xy, ref), whole)


@pytest.mark.parametrize(
    "pos", [(0.0, 0.0), (3.3, -1.1), (11.95, -0.5), (250.0, 250.0)],
    ids=["start", "middle", "near_end", "beyond_100m_cap"],
)
def test_resample_reference(pos):
    course = _course()
    jpath = JaxPathBuffer.from_points(course, 0.1, capacity=150, dtype=np.float64)
    tpath = PathBuffer.from_points(course, 0.1, capacity=150, dtype=torch.float64,
                                  device="cpu")
    jpos, tpos = jnp.asarray(pos), torch.tensor(pos, dtype=torch.float64)
    assert int(nearest_index(tpath, tpos)) == int(jax_nearest_index(jpath, jpos))
    v_ref = np.float64(2.0)
    jr = jax_resample(jpath, jpos, v_ref, 0.1, T)
    tr = resample_reference(tpath, tpos, torch.tensor(v_ref), 0.1, T)
    close(tr.xy, jr.xy)
    close(tr.yaw, jr.yaw)
    if pos == (250.0, 250.0):
        assert int(nearest_index(tpath, tpos)) == 0  # the reference's 100 m quirk


@pytest.mark.parametrize("beta", [0.0, 0.5])
@pytest.mark.parametrize("steer_off", [False, True])
def test_sample_controls(beta, steer_off):
    _, jsp, _ = jax_full_body_config(num_samples=K, horizon=T, dtype=np.float64)
    jsp.noise_beta = np.asarray(beta)
    tsp = to_port(sp=jsp)[0]
    rng = np.random.RandomState(3)
    u_prev = rng.randn(T - 1, 5) * 0.3
    noise = rng.randn(T - 1, K, 5)
    ju = jsampling.sample_controls(None, jnp.asarray(u_prev), jsp, K,
                                   steer_off=steer_off, noise=jnp.asarray(noise))
    tu = sample_controls(torch.as_tensor(u_prev), tsp, K, steer_off=steer_off,
                         noise=torch.as_tensor(noise))
    close(tu, ju)
    if beta == 0.0:
        white = torch.as_tensor(noise)
        assert torch.equal(color_noise(white, tsp.noise_beta), white)


def test_sample_controls_generator_is_deterministic():
    # the eager step's normals come from the keyed draw (the kernel's Philox
    # stream): the same (seed, step) draws the same samples
    _, jsp, _ = jax_full_body_config(num_samples=K, horizon=T, dtype=np.float64)
    tsp = to_port(sp=jsp)[0]
    u_prev = torch.zeros(T - 1, 5, dtype=torch.float64)

    def draw(seed):
        noise = draw_standard_normals(None, seed, 0, (T - 1, K, 5), dtype=torch.float64,
                                      device="cpu")
        return sample_controls(u_prev, tsp, K, noise=noise)

    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))
    with pytest.raises(ValueError):
        sample_controls(u_prev, tsp, K)


def test_model_step():
    state0, controls = _rollout_inputs()
    got = tfb.step(torch.as_tensor(state0), torch.as_tensor(controls[0]), 0.1)
    close(got, jfb.step(jnp.asarray(state0), jnp.asarray(controls[0]), 0.1))


@pytest.mark.parametrize("batched", [True, False])
def test_rollouts(batched):
    state0, controls = _rollout_inputs()
    if not batched:
        controls = controls[:, 0]
    s0 = np.broadcast_to(state0, controls.shape[1:-1] + (5,)).copy()
    jseq = jax_rollout(jfb.step, jnp.asarray(s0), jnp.asarray(controls), 0.1)
    jcf = jax_rollout_cf("full_body", jnp.asarray(s0),
                                       jnp.asarray(controls), 0.1)
    tseq = rollout(tfb.step, torch.as_tensor(s0), torch.as_tensor(controls), 0.1)
    tcf = rollout_closed_form("full_body", torch.as_tensor(s0),
                              torch.as_tensor(controls), 0.1)
    assert tcf.shape == (T,) + s0.shape
    close(tseq, jseq)
    close(tcf, jcf)
    close(tcf, tseq.numpy(), rtol=1e-9, atol=1e-12)


def test_zmp_chain():
    jp, tp = _params()
    state0, controls = _rollout_inputs(4)
    s0 = np.broadcast_to(state0, (K, 5)).copy()
    jstates = jax_rollout(jfb.step, jnp.asarray(s0), jnp.asarray(controls), 0.1)
    got = tfb.zmp_chain(torch.tensor(np.asarray(jstates)),
                        torch.as_tensor(controls), 0.1, tp)
    assert got.shape == (T - 2, K, 2)
    close(got, jfb.zmp_chain(jstates, jnp.asarray(controls), 0.1, jp))


def test_full_body_cost():
    jp, tp = _params()
    _, _, jcp = jax_full_body_config(num_samples=K, horizon=T, dtype=np.float64)
    tcp = to_port(cp=jcp)[1]
    state0, controls = _rollout_inputs(5)
    s0 = np.broadcast_to(state0, (K, 5)).copy()
    jstates = jax_rollout(jfb.step, jnp.asarray(s0), jnp.asarray(controls), 0.1)
    jzmp = jfb.zmp_chain(jstates, jnp.asarray(controls), 0.1, jp)
    ref_xy = np.cumsum(np.full((T, 2), 0.1), axis=0) + np.array([0.3, -0.5])
    ref_yaw = np.full(T, 0.1)
    jc = jcosts.full_body_cost(jstates, jnp.asarray(controls), jzmp,
                               JaxRefWindow(jnp.asarray(ref_xy), jnp.asarray(ref_yaw)), jcp)
    tc = full_body_cost(torch.tensor(np.asarray(jstates)), torch.as_tensor(controls),
                        torch.tensor(np.asarray(jzmp)),
                        RefWindow(torch.as_tensor(ref_xy), torch.as_tensor(ref_yaw)), tcp)
    assert tc.shape == (K,)
    close(tc, jc)


def test_softmax_weights_and_update():
    rng = np.random.RandomState(6)
    costs = rng.rand(K) * 30.0 + 5.0
    samples = rng.randn(T - 1, K, 5)
    jw, jstats = jsoftmax.softmax_weights(jnp.asarray(costs), 0.7)
    tw, tstats = softmax_weights(torch.as_tensor(costs), torch.tensor(0.7, dtype=torch.float64))
    close(tw, jw)
    for name in ("min_cost", "mean_cost", "ess"):
        close(tstats[name], jstats[name])
    close(weighted_update(tw, torch.as_tensor(samples)),
          jsoftmax.weighted_update(jw, jnp.asarray(samples)))


def test_pack_scalars_matches_jax_layout():
    _, jsp, jcp = jax_full_body_config(dtype=np.float32)
    jp = jfb.default_params(np.float32)
    expected = np.asarray(jax_pack_scalars(np.float32(0.1), jcp, np.float32(0.3), jp,
                                           noise_beta=jsp.noise_beta, lam=jsp.lam))
    tsp, tcp, tp = to_port(jsp, jcp, jp, dtype=torch.float32)
    got = pack_scalars(0.1, tcp, torch.tensor(0.3), tp, tsp.noise_beta, tsp.lam)
    assert got.dtype == torch.float32 and got.shape == (NSCAL,)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_default_params_match():
    jp, tp = _params()
    fresh = tfb.default_params(device="cpu", dtype=torch.float64)
    for name in ("mass", "base2com", "inertia", "gravity_z"):
        close(getattr(fresh, name), getattr(jp, name))
        assert torch.equal(getattr(fresh, name), getattr(tp, name))
