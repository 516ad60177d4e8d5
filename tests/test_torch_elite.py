"""Elite sampling in the port against the JAX package.

- ``elite_threshold``: bit-equal to JAX's radix select, NaN costs, ties and
  Python's half-to-even ``round`` included;
- ``softmax_weights`` with ``elite_frac`` and with a given (stale)
  threshold, the all-masked case included, and the eager ``mppi_step`` with
  elite, at float64 rtol 1e-9 atol 1e-12 (tests/test_solver_parity.py's);
- the kernel's elite passes (costs only, costs in, threshold in the scalar
  vector) and the kernel ``mppi_step`` with elite, the port's plain version
  against the JAX kernel in interpret mode at float32: costs rtol 2e-5,
  u_opt rtol 5e-4 atol 5e-5 (tests/test_kernel.py:107-127's);
- the stale-threshold closed loop against ``build_simulate_scan``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.core.config import full_body_config as jax_full_body_config
from ccv_mppi_path_tracker_tpu.kernels.rollout_cost import pack_scalars as jax_pack_scalars
from ccv_mppi_path_tracker_tpu.ops import softmax_update as jsoftmax
from ccv_mppi_path_tracker_tpu.runtime.loop import build_simulate_scan
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import NSCAL, pack_scalars
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import (
    elite_threshold,
    softmax_weights,
)
from ccv_mppi_path_tracker_tpu_torch.runtime import simulate
from test_torch_kernel import _inputs, _jax_kernel, _port
from test_torch_solver import Case

F64 = dict(rtol=1e-9, atol=1e-12)
U_TOL = dict(rtol=5e-4, atol=5e-5)


def close(port, ref, tol=F64):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _costs(kind, dtype):
    rng = np.random.RandomState(3)
    if kind == "random":
        return (rng.rand(4096) * 80.0 + 3.0).astype(dtype)
    if kind == "nan":
        c = (rng.rand(1000) * 10.0).astype(dtype)
        c[rng.choice(1000, 150, replace=False)] = np.nan
        c[:3] = -np.asarray(np.nan, dtype)  # a sign bit set on the NaN
        c[3:6] = np.inf
        return c
    if kind == "ties":
        return rng.randint(0, 7, size=1000).astype(dtype)
    if kind == "zeros":
        return np.where(rng.rand(300) < 0.5, 0.0, rng.rand(300)).astype(dtype)
    return rng.rand(10).astype(dtype)  # "ten"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "kind,frac",
    [("random", 0.1), ("random", 1.0), ("random", 0.0), ("nan", 0.1),
     ("nan", 0.95), ("ties", 0.1), ("ties", 0.5), ("zeros", 0.3),
     ("ten", 0.25), ("ten", 0.35), ("ten", 0.05)],
    # ten samples: 2.5 -> 2 and 3.5 -> 4 (half to even), 0.5 -> max(1, 0)
)
def test_elite_threshold_matches_jax_bit_exact(kind, frac, dtype):
    costs = _costs(kind, dtype)
    got = elite_threshold(torch.as_tensor(costs), frac)
    ref = np.asarray(jsoftmax.elite_threshold(jnp.asarray(costs), frac))
    assert got.shape == () and got.dtype == torch.as_tensor(costs).dtype
    assert got.numpy().tobytes() == ref.tobytes()
    target = max(1, int(round(frac * costs.shape[0])))
    clean = np.where(np.isnan(costs), np.inf, costs)
    assert float(got) == np.sort(clean)[target - 1]


def test_elite_threshold_rejects_a_fraction_outside_the_unit_interval():
    for frac in (-0.1, 1.5):
        with pytest.raises(ValueError):
            elite_threshold(torch.rand(10), frac)


@pytest.mark.parametrize("mode", ["frac", "stale_mid", "stale_inf", "stale_empty"])
def test_softmax_weights_with_elite_match_jax(mode):
    rng = np.random.RandomState(6)
    costs = rng.rand(500) * 30.0 + 5.0
    kw, tkw = {"elite_frac": 0.1}, {"elite_frac": 0.1}
    if mode != "frac":
        thresh = {"stale_mid": 12.0, "stale_inf": np.inf, "stale_empty": 1.0}[mode]
        kw["elite_thresh"] = jnp.asarray(thresh)
        tkw["elite_thresh"] = torch.tensor(thresh, dtype=torch.float64)
    jw, jstats = jsoftmax.softmax_weights(jnp.asarray(costs), 0.7, **kw)
    tw, tstats = softmax_weights(torch.as_tensor(costs),
                                 torch.tensor(0.7, dtype=torch.float64), **tkw)
    assert set(tstats) == set(jstats)
    close(tw, jw)
    for name in tstats:
        close(tstats[name], jstats[name])
    if mode == "stale_empty":
        assert bool(tstats["elite_stale_empty"]) and float(tw.abs().max()) == 0.0
    if mode == "frac":
        assert int((tw > 0).sum()) == 50


def test_pack_scalars_threshold_and_no_model_params_match_jax():
    """The port's 18 slots equal JAX's pack_scalars output for a model
    without physical parameters and a given threshold."""
    _, jsp, jcp = jax_full_body_config(dtype=np.float32)
    expected = np.asarray(jax_pack_scalars(np.float32(0.1), jcp, np.float32(0.3), None,
                                           noise_beta=jsp.noise_beta, lam=jsp.lam,
                                           cost_thresh=np.float32(7.5)))
    path = {"xy": np.zeros((2, 2)), "num_valid": 2, "resolution": 0.1}
    tsp, tcp = from_numpy(jsp, jcp, None, np.zeros(1), path)[:2]
    got = pack_scalars(0.1, tcp, torch.tensor(0.3), None, tsp.noise_beta, tsp.lam,
                       cost_thresh=torch.tensor(7.5))
    assert got.shape == (NSCAL,) and expected.shape == (NSCAL,)
    np.testing.assert_array_equal(got.numpy(), expected)
    assert float(pack_scalars(0.1, tcp, torch.tensor(0.3))[17]) == np.inf


@pytest.mark.parametrize(
    "model,mode",
    [("full_body", "frac"), ("full_body", "frac_lean"), ("full_body", "stale_mid"),
     ("full_body", "stale_empty"), ("unicycle", "frac"), ("unicycle", "stale_mid"),
     ("steering_unicycle", "stale_empty"), ("rate_limited_steering", "frac_lean")],
)
def test_eager_elite_step_matches_jax_f64(model, mode):
    case = Case(256, model=model)
    kw = {"elite_frac": 0.1, "lean": mode == "frac_lean"}
    jkw = dict(kw)
    if mode.startswith("stale"):
        thresh = {"stale_mid": 60.0, "stale_empty": -1.0}[mode]
        jkw["elite_stale_thresh"] = jnp.asarray(thresh)
        kw["elite_stale_thresh"] = torch.tensor(thresh, dtype=torch.float64)
    jctrl, jres = case.jax(**jkw)
    ctrl, res = case.port(**kw)
    close(res.u_opt, jres.u_opt)
    close(ctrl.u_prev, jctrl.u_prev)
    assert set(res.stats) == set(jres.stats)
    for name in res.stats:
        close(res.stats[name], jres.stats[name])
    if mode == "stale_empty":
        assert bool(res.stats["elite_stale_empty"])
        assert torch.equal(res.u_opt, case.tu)  # holds the sampling mean


def _gap_threshold(costs, k):
    """The midpoint of the widest gap between sorted costs near rank k/10:
    float32 rounding of either implementation cannot move a cost across it."""
    s = np.sort(costs)
    lo = max(1, k // 10 - 20)
    i = lo + int(np.argmax(s[lo:lo + 40] - s[lo - 1:lo + 39]))
    return np.float32(0.5 * (s[i - 1] + s[i]))


@pytest.mark.parametrize("model", ["full_body", "unicycle"])
def test_elite_kernel_passes_match_jax_kernel(model):
    """Pass 1 (costs only), pass 2 (costs in, threshold in slot 17) and the
    single stale-threshold pass of the plain version against the JAX
    kernel. Both second passes read the JAX pass-1 costs, so the masks are
    the same samples."""
    k = 1000  # masked tail
    inp = _inputs(k, model=model)
    costs_j, _ = _jax_kernel(inp, k, False, model=model, accumulate=False)
    costs, u_num, norm = _port(inp, k, False, model=model, accumulate=False)
    assert u_num is None and norm is None
    np.testing.assert_allclose(costs.numpy(), costs_j, rtol=2e-5)

    thresh = np.asarray(jsoftmax.elite_threshold(jnp.asarray(costs_j), 0.1))
    inp2 = _inputs(k, model=model, cost_thresh=thresh)
    _, u_opt_j = _jax_kernel(inp2, k, False, model=model,
                             costs_in=jnp.asarray(costs_j))
    cin = torch.tensor(costs_j)
    c2, u_num, norm = _port(inp2, k, False, model=model, costs_in=cin)
    assert c2 is cin
    np.testing.assert_allclose((u_num / norm).numpy(), u_opt_j, **U_TOL)

    inp3 = _inputs(k, model=model, cost_thresh=_gap_threshold(costs_j, k))
    costs_j3, u_opt_j3 = _jax_kernel(inp3, k, False, model=model)
    costs3, u_num, norm = _port(inp3, k, False, model=model)
    np.testing.assert_allclose(costs3.numpy(), costs_j3, rtol=2e-5)
    np.testing.assert_allclose((u_num / norm).numpy(), u_opt_j3, **U_TOL)


@pytest.mark.parametrize(
    "model,mode",
    [("full_body", "two_pass"), ("unicycle", "two_pass"), ("full_body", "stale_mid"),
     ("unicycle", "stale_empty")],
)
def test_kernel_elite_step_matches_jax_kernel_f32(model, mode):
    case = Case(1000, f64=False, model=model)
    kw = {"elite_frac": 0.1, "use_kernel": True}
    jkw = dict(kw, kernel_interpret=True)
    if mode != "two_pass":
        thresh = -1.0  # below every cost: the all-masked cycle
        if mode == "stale_mid":
            _, full = case.port(use_kernel=True)
            thresh = float(full.stats["min_cost"]) * 1.5
        jkw["elite_stale_thresh"] = jnp.asarray(thresh, jnp.float32)
        kw["elite_stale_thresh"] = torch.tensor(thresh, dtype=torch.float32)
    _, jres = case.jax(**jkw)
    _, res = case.port(**kw)
    close(res.u_opt, jres.u_opt, U_TOL)
    close(res.stats["elite_thresh"], jres.stats["elite_thresh"], dict(rtol=2e-5))
    if mode == "stale_empty":
        assert bool(res.stats["elite_stale_empty"]) and bool(jres.stats["elite_stale_empty"])
        assert torch.equal(res.u_opt, case.tu)


def test_stale_elite_closed_loop_matches_jax():
    """Four cycles of single-pass elite, each masked at the previous cycle's
    threshold (+inf first), the same injected noise every cycle."""
    case = Case(128, horizon=10, model="unicycle")
    steps = 4
    sim = build_simulate_scan(
        case.jcfg, num_steps=steps,
        solver_options={"elite_frac": 0.1, "elite_stale": True,
                        "noise": jnp.asarray(case.noise)})
    jctrl0 = JaxControllerState(u_prev=jnp.asarray(case.u_prev),
                                key=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    jctrl, jlogs = sim(jctrl0, jnp.asarray(case.state), case.jpath, jnp.asarray(0.1),
                       case.jsp, case.jcp)
    ctrl, logs = simulate(
        case.cfg, ControllerState(case.tu, 0, 0), torch.as_tensor(case.state),
        case.path, torch.tensor(0.1, dtype=torch.float64), case.sp, case.cp,
        num_steps=steps,
        solver_options={"elite_frac": 0.1, "elite_stale": True,
                        "noise": torch.as_tensor(case.noise)})
    close(logs["state"], jlogs["state"])
    close(logs["u0"], jlogs["u0"])
    close(ctrl.u_prev, jctrl.u_prev)
    assert ctrl.step == steps
    with pytest.raises(ValueError):
        simulate(case.cfg, ControllerState(case.tu, 0, 0), torch.as_tensor(case.state),
                 case.path, 0.1, case.sp, case.cp, num_steps=1,
                 solver_options={"elite_stale": True})
