"""Adaptive sigma (the second moment) in the port against the JAX package.

- the eager ``mppi_step(adapt_sigma=True)`` against JAX with injected noise,
  every model, vanilla, two-pass elite and stale elite (the all-masked stale
  cycle suggests sp.control_noise): float64 rtol 1e-9 atol 1e-12
  (tests/test_solver_parity.py's);
- the kernel's plain version with ``second_moment`` against the JAX Pallas
  kernel in interpret mode (partials summed), every model, a masked tail:
  float32, costs rtol 2e-5, u_opt and u2_num/norm rtol 2e-5 atol 2e-6
  (tests/test_kernel.py's);
- the kernel ``mppi_step(adapt_sigma=True)`` against JAX's with
  ``kernel_interpret=True``: sigma_suggest at rtol 2e-4 atol 1e-6
  (tests/test_solver_options.py:137-139's), u_opt at the elite tests' rtol
  5e-4 atol 5e-5;
- what the lean result keeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.kernels.rollout_cost import (
    fused_sample_rollout_cost as jax_fused,
    padded_k,
    tile_noise,
    tile_rows,
)
from ccv_mppi_path_tracker_tpu.ops import softmax_update as jsoftmax
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import fused_sample_rollout_cost
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import _sigma_suggest
from test_torch_kernel import MODELS, T, _inputs, _port
from test_torch_solver import Case

F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-6)
SIGMA = dict(rtol=2e-4, atol=1e-6)
U_TOL = dict(rtol=5e-4, atol=5e-5)


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _elite_kw(mode, jax_side, dtype=torch.float64):
    """mppi_step options of a mode: vanilla, two_pass, stale_mid (a stale
    threshold that masks some samples), stale_empty (masks all of them)."""
    if mode == "vanilla":
        return {}
    kw = {"elite_frac": 0.1}
    if mode.startswith("stale"):
        thresh = {"stale_mid": 60.0, "stale_empty": -1.0}[mode]
        kw["elite_stale_thresh"] = (jnp.asarray(thresh) if jax_side
                                    else torch.tensor(thresh, dtype=dtype))
    return kw


@pytest.mark.parametrize("mode", ["vanilla", "two_pass", "stale_mid", "stale_empty"])
@pytest.mark.parametrize("model", list(MODELS))
def test_eager_adapt_sigma_matches_jax_f64(model, mode):
    case = Case(256, model=model)
    jctrl, jres = case.jax(adapt_sigma=True, **_elite_kw(mode, True))
    ctrl, res = case.port(adapt_sigma=True, **_elite_kw(mode, False))
    close(res.u_opt, jres.u_opt, F64)
    close(ctrl.u_prev, jctrl.u_prev, F64)
    assert set(res.stats) == set(jres.stats)
    for name in res.stats:
        close(res.stats[name], jres.stats[name], F64)
    assert res.stats["sigma_suggest"].shape == case.sp.control_noise.shape
    if mode == "stale_empty":
        assert bool(res.stats["elite_stale_empty"])
        assert torch.equal(res.stats["sigma_suggest"], case.sp.control_noise)


def _jax_kernel_m2(inp, k, model, **kw):
    """The JAX kernel with second_moment=True in interpret mode: (costs,
    u_opt, u2_num/norm)."""
    tm1, u_dim = inp["u_prev"].shape
    noise = tile_noise(jnp.asarray(inp["noise"]), padded_k(k, tile_rows(tm1 + 1, u_dim,
                                                                       True, k)))
    out = jax_fused(
        *(jnp.asarray(inp[n]) for n in ("u_prev", "sigma", "u_min", "u_max", "ref_xy",
                                        "state0", "scal")),
        jnp.zeros((1,), jnp.int32), num_samples=k, model=model, noise=noise,
        interpret=True, second_moment=True, **kw)
    if kw.get("costs_in") is not None:
        out = (None,) + tuple(out)
    costs, u_part, n_part, m2_part = out
    norm = np.asarray(n_part).sum()
    return (None if costs is None else np.asarray(costs),
            np.asarray(u_part).sum(axis=(-2, -1)).reshape(tm1, u_dim) / norm,
            np.asarray(m2_part).sum(axis=(-2, -1)).reshape(tm1, u_dim) / norm)


@pytest.mark.parametrize("model", list(MODELS))
def test_plain_second_moment_matches_jax_kernel(model):
    k = 1000  # masked tail
    inp = _inputs(k, model=model, beta=0.5 if model == "unicycle" else 0.0)
    costs_j, u_opt_j, m2_j = _jax_kernel_m2(inp, k, model)
    costs, u_num, norm, u2_num = _port(inp, k, False, model=model, second_moment=True)
    assert u2_num.shape == u_num.shape == (T - 1, inp["u_prev"].shape[1])
    close(costs, costs_j, dict(rtol=2e-5))
    close(u_num / norm, u_opt_j, F32)
    close(u2_num / norm, m2_j, F32)
    close(_sigma_suggest(u2_num / norm, u_num / norm), _sigma_suggest(
        torch.tensor(m2_j), torch.tensor(u_opt_j)), SIGMA)


def test_plain_second_moment_of_the_costs_in_pass_matches_jax_kernel():
    """The elite second pass with the second moment: costs in, the
    threshold in slot 17, the u^2 sums masked like the u sums."""
    k = 1000
    inp = _inputs(k, model="full_body")
    costs_j = _port(inp, k, False, accumulate=False)[0].numpy()
    thresh = np.asarray(jsoftmax.elite_threshold(jnp.asarray(costs_j), 0.1))
    inp = _inputs(k, model="full_body", cost_thresh=thresh)
    _, u_opt_j, m2_j = _jax_kernel_m2(inp, k, "full_body", costs_in=jnp.asarray(costs_j))
    _, u_num, norm, u2_num = _port(inp, k, False, costs_in=torch.tensor(costs_j),
                                   second_moment=True)
    close(u_num / norm, u_opt_j, U_TOL)
    close(u2_num / norm, m2_j, U_TOL)


def test_second_moment_outputs_without_the_update():
    k = 300
    inp = _inputs(k, model="unicycle")
    out = _port(inp, k, False, model="unicycle", accumulate=False, second_moment=True)
    assert len(out) == 4 and out[0].shape == (k,) and out[1:] == (None, None, None)
    vanilla = _port(inp, k, False, model="unicycle")
    m2 = _port(inp, k, False, model="unicycle", second_moment=True)
    for a, b in zip(vanilla, m2):
        assert torch.equal(a, b)  # the first three outputs do not change


@pytest.mark.parametrize(
    "model,mode",
    [("full_body", "vanilla"), ("unicycle", "vanilla"), ("full_body", "two_pass"),
     ("unicycle", "stale_mid"), ("steering_unicycle", "stale_empty")],
)
def test_kernel_adapt_sigma_matches_jax_kernel(model, mode):
    case = Case(1000, f64=False, model=model)
    kw = _elite_kw(mode, True)
    if mode == "stale_mid":
        _, full = case.port(use_kernel=True)
        thresh = float(full.stats["min_cost"]) * 1.5
        kw["elite_stale_thresh"] = jnp.asarray(thresh, jnp.float32)
    _, jres = case.jax(use_kernel=True, kernel_interpret=True, adapt_sigma=True, **kw)
    pkw = {k: (torch.tensor(float(v), dtype=torch.float32) if k == "elite_stale_thresh"
               else v) for k, v in kw.items()}
    before = fused_sample_rollout_cost.launches
    _, res = case.port(use_kernel=True, adapt_sigma=True, **pkw)
    assert fused_sample_rollout_cost.launches == before  # CPU: plain version
    close(res.u_opt, jres.u_opt, U_TOL)
    close(res.stats["sigma_suggest"], jres.stats["sigma_suggest"], SIGMA)
    # and against the port's own eager path on the same noise
    _, eager = case.port(adapt_sigma=True, **pkw)
    close(res.stats["sigma_suggest"], eager.stats["sigma_suggest"], SIGMA)
    if mode == "stale_empty":
        assert torch.equal(res.stats["sigma_suggest"], case.sp.control_noise)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["eager", "kernel"])
def test_lean_keeps_sigma_suggest_and_elite_thresh(use_kernel):
    case = Case(256, f64=False, model="unicycle")
    _, full = case.port(use_kernel=use_kernel, adapt_sigma=True, elite_frac=0.1)
    _, lean = case.port(use_kernel=use_kernel, adapt_sigma=True, elite_frac=0.1,
                        lean=True)
    assert set(lean.stats) == {"sigma_suggest", "elite_thresh"}
    assert lean.ref is None and lean.opt_states is None
    for name in lean.stats:
        assert torch.equal(lean.stats[name], full.stats[name])
    assert torch.equal(lean.u_opt, full.u_opt)
    _, plain = case.port(use_kernel=use_kernel, lean=True)
    assert plain.stats == {}
    _, off = case.port(use_kernel=use_kernel)
    assert "sigma_suggest" not in off.stats
