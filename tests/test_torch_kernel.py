"""The port's fused-kernel plain version against the JAX Pallas kernel.

The JAX kernel runs in interpret mode on the CPU with the ``tile_noise``
input; the port's wrapper, given CPU tensors, runs its plain PyTorch version
(kernels/rollout_cost.py). Both see the same float32 inputs, made with
numpy from a seed, for each of the four models: the JAX package's launch
preset of the model, with roll_off=False weights for full_body so the ZMP
and roll-rate terms are live. Tolerances are tests/test_kernel.py's: costs
rtol 2e-5, u_opt = u_num/norm rtol 2e-5 atol 2e-6 (float32 rounding between
the two evaluation orders).

Also checked: the torch Philox4x32-10 of the kernel's RNG mode against
published known-answer vectors and an independent numpy uint64 version, and
the normals it gives.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core.presets import PRESETS as JAX_PRESETS
from ccv_mppi_path_tracker_tpu.kernels.rollout_cost import (
    fused_sample_rollout_cost as jax_fused,
    pack_scalars as jax_pack_scalars,
    padded_k,
    tile_noise,
    tile_rows,
)
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.paths import resample_reference as jax_resample
from ccv_mppi_path_tracker_tpu_torch.core.random import (
    philox4x32,
    philox_normals,
)
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost,
    fused_sample_rollout_cost_reference,
)

T = 12
DT = 0.1
# model -> (its JAX launch preset, its start state after x and y)
MODELS = {
    "unicycle": ("diff_drive", (0.1,)),
    "steering_unicycle": ("steering_diff_drive", (0.1,)),
    "rate_limited_steering": ("rate_limited_steering", (0.1, 0.2)),
    "full_body": ("full_body", (0.1, 0.02, -0.03)),
}


def _inputs(k, model="full_body", beta=0.0, seed=0, cost_thresh=None):
    """float32 numpy inputs of one kernel call, from the JAX package's launch
    preset of ``model`` (full_body with roll_off=False)."""
    preset, rest = MODELS[model]
    kw = {"roll_off": False} if model == "full_body" else {}
    cfg, sp, cp, course = JAX_PRESETS[preset](
        num_samples=k, horizon=T, dtype=np.float32, **kw)
    assert cfg.model == model
    sp = dataclasses.replace(sp, noise_beta=np.asarray(beta, np.float32))
    u_dim = np.asarray(sp.u_min).shape[0]
    rng = np.random.RandomState(seed)
    state = np.array([0.05, course[0, 1] + 0.1, *rest], np.float32)
    path = JaxPathBuffer.from_points(course, 0.1, dtype=np.float32)
    ref = jax_resample(path, jnp.asarray(state[:2]), cp.v_ref, jnp.float32(DT), T)
    mp = jax_default_params() if model == "full_body" else None
    scal = jax_pack_scalars(jnp.float32(DT), cp, ref.yaw[0], mp,
                            noise_beta=sp.noise_beta, lam=sp.lam,
                            cost_thresh=cost_thresh)
    return {
        "u_prev": (rng.randn(T - 1, u_dim) * 0.2).astype(np.float32),
        "sigma": np.asarray(sp.control_noise),
        "u_min": np.asarray(sp.u_min),
        "u_max": np.asarray(sp.u_max),
        "ref_xy": np.asarray(ref.xy),
        "state0": state,
        "scal": np.asarray(scal),
        "noise": rng.randn(T - 1, k, u_dim).astype(np.float32),
    }


def _jax_kernel(inp, k, steer_off, model="full_body", **kw):
    """The JAX kernel in interpret mode. Returns (costs, u_opt); with
    ``costs_in``, costs is None; with ``accumulate=False``, u_opt is None."""
    tm1, u_dim = inp["u_prev"].shape
    rows = tile_rows(tm1 + 1, u_dim, True, k)
    noise = tile_noise(jnp.asarray(inp["noise"]), padded_k(k, rows))
    out = jax_fused(
        jnp.asarray(inp["u_prev"]), jnp.asarray(inp["sigma"]),
        jnp.asarray(inp["u_min"]), jnp.asarray(inp["u_max"]),
        jnp.asarray(inp["ref_xy"]), jnp.asarray(inp["state0"]),
        jnp.asarray(inp["scal"]), jnp.zeros((1,), jnp.int32),
        num_samples=k, model=model, steer_off=steer_off, noise=noise,
        interpret=True, **kw,
    )
    if kw.get("costs_in") is not None:
        out = (None,) + tuple(out)
    costs, u_part, n_part = out
    costs = None if costs is None else np.asarray(costs)
    if not kw.get("accumulate", True):
        return costs, None
    u_num = np.asarray(u_part).sum(axis=(-2, -1)).reshape(tm1, u_dim)
    return costs, u_num / np.asarray(n_part).sum()


def _port(inp, k, steer_off, noise=True, seed=0, step=0, model="full_body", **kw):
    t = {n: torch.tensor(v) for n, v in inp.items()}
    return fused_sample_rollout_cost(
        t["u_prev"], t["sigma"], t["u_min"], t["u_max"], t["ref_xy"],
        t["state0"], t["scal"], seed=seed, step=step, num_samples=k,
        model=model, steer_off=steer_off, noise=t["noise"] if noise else None,
        **kw,
    )


def _case(model, k, steer_off, beta):
    # the full_body cases keep the ids they had before the other models came
    name = f"{k}-{steer_off}-{beta}"
    return pytest.param(model, k, steer_off, beta,
                        id=name if model == "full_body" else f"{model}-{name}")


@pytest.mark.parametrize(
    "model,k,steer_off,beta",
    [_case("full_body", 4096, False, 0.0), _case("full_body", 4096, True, 0.0),
     _case("full_body", 1000, False, 0.0), _case("full_body", 1000, True, 0.0),
     _case("full_body", 1000, False, 0.5),
     _case("unicycle", 1000, False, 0.5), _case("unicycle", 1000, True, 0.0),
     _case("steering_unicycle", 1000, False, 0.0),
     _case("steering_unicycle", 1000, True, 0.0),
     _case("rate_limited_steering", 1000, False, 0.5),
     _case("rate_limited_steering", 1000, True, 0.0)],
)
def test_plain_version_matches_jax_kernel(model, k, steer_off, beta):
    inp = _inputs(k, model=model, beta=beta)
    u_dim = inp["u_prev"].shape[1]
    costs_j, u_opt_j = _jax_kernel(inp, k, steer_off, model=model)
    costs, u_num, norm = _port(inp, k, steer_off, model=model)
    assert costs.shape == (k,) and u_num.shape == (T - 1, u_dim) and norm.shape == ()
    np.testing.assert_allclose(costs.numpy(), costs_j, rtol=2e-5)
    np.testing.assert_allclose((u_num / norm).numpy(), u_opt_j, rtol=2e-5, atol=2e-6)
    if steer_off and u_dim > 2:  # channel 2 exists: steer_off zeroes it
        assert np.all((u_num / norm).numpy()[:, 2] == 0.0)


# Philox4x32-10 known-answer vectors (Random123's kat_vectors)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,expected", KAT)
def test_philox_known_answers(ctr, key, expected):
    out = philox4x32([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(o) for o in out) == expected


def _philox_numpy(ctr, key):
    """Independent Philox4x32-10 in numpy uint64 (32x32-bit products are
    exact in uint64)."""
    m = np.uint64(0xFFFFFFFF)
    c = [np.asarray(x, np.uint64) for x in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [((p1 >> np.uint64(32)) ^ c[1] ^ k0) & m, p1 & m,
             ((p0 >> np.uint64(32)) ^ c[3] ^ k1) & m, p0 & m]
        k0 = (k0 + np.uint64(0x9E3779B9)) & m
        k1 = (k1 + np.uint64(0xBB67AE85)) & m
    return c


def test_philox_matches_numpy_uint64():
    rng = np.random.RandomState(0)
    ctr = [rng.randint(0, 2**32, size=4096, dtype=np.uint64) for _ in range(4)]
    key = (int(rng.randint(0, 2**32)), int(rng.randint(0, 2**32)))
    got = philox4x32([torch.as_tensor(c.astype(np.int64)) for c in ctr], key)
    for g, e in zip(got, _philox_numpy(ctr, key)):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), e)


def test_philox_normals_statistics_and_determinism():
    n = philox_normals(7, 3, 100_000, 2, 5)  # 1e6 draws
    assert n.shape == (2, 100_000, 5) and n.dtype == torch.float32
    assert abs(float(n.mean())) < 5e-3
    assert abs(float(n.std()) - 1.0) < 5e-3
    assert torch.equal(n, philox_normals(7, 3, 100_000, 2, 5))
    assert not torch.equal(n, philox_normals(8, 3, 100_000, 2, 5))
    assert not torch.equal(n, philox_normals(7, 4, 100_000, 2, 5))
    # each normal depends on (k, t, j) only: a prefix of K draws the same
    assert torch.equal(n[:, :1000], philox_normals(7, 3, 1000, 2, 5))


@pytest.mark.parametrize("model", list(MODELS))
def test_rng_mode_draws_the_philox_stream(model):
    """RNG mode draws (U+1)//2 Box-Muller pairs a row and drops the last
    normal for odd U, as the kernel does."""
    k = 1000
    inp = _inputs(k, model=model)
    u_dim = inp["u_prev"].shape[1]
    inp["noise"] = philox_normals(11, 4, k, T - 1, u_dim).numpy()
    injected = _port(inp, k, False, model=model)
    drawn = _port(inp, k, False, noise=False, seed=11, step=4, model=model)
    for a, b in zip(injected, drawn):
        assert torch.equal(a, b)
    if u_dim == 3:
        np.testing.assert_array_equal(inp["noise"],
                                      philox_normals(11, 4, k, T - 1, 4).numpy()[..., :3])


def test_rng_mode_update_is_the_sample_mean_at_huge_lambda():
    """With lambda = 1e30 every weight is 1, so u_opt is the mean of the
    clamped draws: 0 in expectation for u_prev = 0 and a symmetric box."""
    k = 4096
    inp = _inputs(k)
    inp["u_prev"] = np.zeros_like(inp["u_prev"])
    inp["u_min"] = np.full(5, -1.0, np.float32)
    inp["u_max"] = np.full(5, 1.0, np.float32)
    inp["scal"] = inp["scal"].copy()
    inp["scal"][16] = 1e30
    costs, u_num, norm = _port(inp, k, False, noise=False, seed=5, step=9)
    u_opt = (u_num / norm).numpy()
    assert float(norm) == k
    assert np.all(np.abs(u_opt) < 5 * inp["sigma"] / np.sqrt(k))


def test_wrapper_cpu_path_is_the_plain_version():
    k = 1000
    inp = _inputs(k)
    t = {n: torch.tensor(v) for n, v in inp.items()}
    args = (t["u_prev"], t["sigma"], t["u_min"], t["u_max"], t["ref_xy"],
            t["state0"], t["scal"])
    kw = dict(seed=1, step=2, num_samples=k, model="full_body")
    before = fused_sample_rollout_cost.launches
    a = fused_sample_rollout_cost(*args, **kw)
    b = fused_sample_rollout_cost_reference(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert fused_sample_rollout_cost.launches == before
