"""The fused kernel's host-side layout, on the CPU (the kernel itself runs on
the card, in chip_smoke.py):

- the launch-shape chooser (kernels/rollout_cost.py launch_shape) for every
  model over horizons 2-400, with and without the second moment, for one
  robot and a fleet of 256, at K = 1 to 102400: the block fits in the
  card's 227 KB of shared memory, its threads are a multiple of 32, and the
  regenerate form is chosen exactly where 32 samples' control tiles do not
  fit, and for the two passes of two-pass elite (where it measured faster);
  at the flagship shapes, the block sizes the card measured fastest;
- the padded (R_pad, 4) reference rows give the same min-distance scan as
  the 3-float rows, exactly (a float32 torch mirror of the kernel's scan);
- rollout_cost_work and rollout_cost_bound_ms against counts worked by hand;
- the plain finish against the algebra of the per-block partials, in float64
  numpy, with block baselines spread by 1e3 (rtol 1e-5: float32 sums);
- the ptxas report parser.
"""

import math

import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu_torch.kernels import build
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    FP32_PEAK,
    HBM_BYTES_PER_S,
    INT32_PEAK,
    KERNEL_MODELS,
    MAX_DYNAMIC_SMEM,
    MAX_ROBOTS,
    SMEM_PER_BLOCK,
    STATIC_SMEM,
    finish_groups,
    finish_reference,
    instantiations,
    launch_shape,
    pad_ref_rows,
    rollout_cost_bound_ms,
    rollout_cost_work,
    row_floats,
    smem_bytes,
)

HORIZONS = (2, 15, 30, 60, 100, 200, 400)
SAMPLES = (1, 1000, 10_000, 102_400)
ROBOTS = (1, 256)


@pytest.mark.parametrize("horizon", HORIZONS)
@pytest.mark.parametrize("model", KERNEL_MODELS)
def test_launch_shape_fits_and_picks_the_form_by_the_tile(model, horizon):
    num_ref = horizon  # resample_reference gives one point per horizon step
    for m2 in (False, True):
        store_fits = smem_bytes(model, "store", m2, True, 32, horizon,
                                num_ref) <= MAX_DYNAMIC_SMEM
        for k in SAMPLES:
            shape = launch_shape(model, k, horizon, num_ref, m2)
            assert shape.form == ("store" if store_fits else "regen")
            assert shape.threads % 32 == 0 and 32 <= shape.threads <= 256
            assert shape.smem + STATIC_SMEM <= SMEM_PER_BLOCK
            assert shape.smem == smem_bytes(model, shape.form, m2, True, shape.threads,
                                            horizon, num_ref)
            assert shape.blocks == -(-k // shape.threads) and shape.blocks_per_sm >= 1
            for b in ROBOTS:  # the grid (blocks, B), counters (B, groups + 1)
                assert b <= MAX_ROBOTS and shape.blocks * b < 2**31
                assert b * (finish_groups(shape.blocks) + 1) < 2**31
            # the passes of two-pass elite: the costs-only pass (no update)
            # and the costs-in pass (no rollout) take the regenerate form
            first = launch_shape(model, k, horizon, num_ref, False, accumulate=False)
            assert first.form == "regen" and first.smem + STATIC_SMEM <= SMEM_PER_BLOCK
            second = launch_shape(model, k, horizon, num_ref, m2, costs_in=True)
            assert second.form == "regen" and second.smem + STATIC_SMEM <= SMEM_PER_BLOCK
    if model == "full_body" and horizon == 400:
        assert not store_fits  # 32 tiles of 399 x 5 floats: 255 KB
    if horizon <= 60:
        assert store_fits


# (model, K, T, second moment, accumulate, costs_in) -> (form, threads) the
# card measured fastest (scripts/torch_kernel_ab.py sweep, PERF.md)
MEASURED_BEST = {
    ("full_body", 102_400, 30, False, True, False): ("store", 96),
    ("unicycle", 102_400, 30, False, True, False): ("store", 160),
    ("steering_unicycle", 102_400, 30, False, True, False): ("store", 160),
    ("rate_limited_steering", 102_400, 30, False, True, False): ("store", 160),
    ("full_body", 10_000, 15, False, True, False): ("store", 96),
    ("full_body", 102_400, 30, False, False, False): ("regen", 160),
    ("unicycle", 102_400, 30, False, False, False): ("regen", 160),
    ("full_body", 102_400, 30, False, True, True): ("regen", 160),
    ("unicycle", 102_400, 30, False, True, True): ("regen", 160),
}


@pytest.mark.parametrize("case", sorted(MEASURED_BEST))
def test_launch_shape_picks_the_measured_best(case):
    model, k, t, m2, acc, cin = case
    shape = launch_shape(model, k, t, t, m2, accumulate=acc, costs_in=cin)
    assert (shape.form, shape.threads) == MEASURED_BEST[case]


def test_launch_shape_overrides_and_refusals():
    shape = launch_shape("full_body", 102_400, 30, 30, form="regen", threads=128)
    assert (shape.form, shape.threads, shape.blocks) == ("regen", 128, 800)
    with pytest.raises(ValueError):
        launch_shape("full_body", 1000, 400, 400, form="store")  # 32 tiles do not fit
    with pytest.raises(ValueError):
        launch_shape("unicycle", 1000, 30, 30, threads=48)
    with pytest.raises(ValueError):
        launch_shape("unicycle", 1000, 30, 30, accumulate=False, form="store")
    # the costs-in pass in the store form, which only a forced shape takes
    shape = launch_shape("full_body", 102_400, 30, 30, costs_in=True, form="store")
    assert shape.form == "store" and shape.smem == smem_bytes(
        "full_body", "store", False, True, shape.threads, 30, 30)


def test_launch_shape_is_cached():
    """Every update asks the chooser again: the same shapes return the same
    LaunchShape object, from the cache."""
    args = ("steering_unicycle", 4321, 17, 17, True)
    first = launch_shape(*args)
    hits = launch_shape.cache_info().hits
    assert launch_shape(*args) is first
    assert launch_shape.cache_info().hits == hits + 1


def test_smem_bytes_counts_the_tile_and_the_finish():
    # full_body T=30 R=30 store, 128 threads: ref 32 rows x 4, u_prev 145 (148
    # aligned), weights 128, tile 145 x 128 floats
    assert smem_bytes("full_body", "store", False, True, 128, 30, 30) == \
        4 * (4 * 32 + 148 + 128 + 145 * 128)
    # regenerate, 256 threads: 8 warps x 146 sums, less than the finish's
    # 146 (148 aligned) sums, 32 scales and 32 rows of 148 floats
    assert row_floats(145, False) == 148
    assert smem_bytes("full_body", "regen", False, True, 256, 30, 30) == \
        4 * (148 + 32 + 32 * 148)
    # costs only: no update region, no finish
    assert smem_bytes("full_body", "regen", False, False, 256, 30, 30) == \
        4 * (4 * 32 + 148 + 256)


def _scan_min(rows, x, y):
    """The kernel's scan as a float32 torch mirror: min_j (r_z - x*r_x - y*r_y)
    evaluated left to right."""
    return torch.amin(rows[:, 2] - x[:, None] * rows[:, 0] - y[:, None] * rows[:, 1],
                      dim=-1)


@pytest.mark.parametrize("num_ref", [1, 3, 30, 31])
def test_padded_reference_rows_keep_the_minimum(num_ref):
    rng = np.random.RandomState(num_ref)
    ref_xy = torch.tensor(rng.randn(num_ref, 2) * 3.0, dtype=torch.float32)
    c, refc = pad_ref_rows(ref_xy)
    r_pad = -(-num_ref // 4) * 4
    assert refc.shape == (r_pad, 4) and refc.dtype == torch.float32
    assert torch.equal(c, ref_xy[0])
    pad = refc[num_ref:]
    assert torch.equal(pad[:, [0, 1, 3]], torch.zeros(r_pad - num_ref, 3))
    assert bool(torch.isinf(pad[:, 2]).all() and (pad[:, 2] > 0).all())
    assert torch.equal(refc[:num_ref, 3], torch.zeros(num_ref))
    # the 3-float rows [2(r-c), |r-c|^2] of the kernel before the padding
    rc = ref_xy - ref_xy[0]
    rows3 = torch.cat([2.0 * rc, (rc[:, 0] * rc[:, 0] + rc[:, 1] * rc[:, 1])[:, None]], -1)
    pts = torch.tensor(rng.randn(500, 2) * 4.0, dtype=torch.float32)
    assert torch.equal(_scan_min(rows3, pts[:, 0], pts[:, 1]),
                       _scan_min(refc, pts[:, 0], pts[:, 1]))
    # a fleet's (B, R, 2) windows pad per robot
    cb, refcb = pad_ref_rows(torch.stack([ref_xy, ref_xy + 1.0]))
    assert refcb.shape == (2, r_pad, 4) and torch.equal(refcb[0], refc)


def test_work_and_bound_against_hand_counts():
    # unicycle K=1 T=3 R=2, RNG mode, one robot: T-1 = 2 rows of U = 2
    # scan: T = 3 scans x (5*2 + 6) = 48; step: 2 x 16 + 2 = 34;
    # sample: 2 x (7*2 - 3) = 22; Box-Muller: 1 pair x 2 rows x 10 = 20;
    # update: 6 + 2 x 4 = 14  ->  138 flops. Philox: 2 calls x 62 = 124.
    # bytes: u_prev 4 + ref 4 + state 3 + scal 18 + sigma/box 6 + cost 1 +
    # u_num 4 + norm 1 = 41 floats.
    w = rollout_cost_work("unicycle", 1, 3, 2)
    assert w == {"flops": 138, "int_ops": 124, "bytes": 4 * 41}
    # full_body K=1 T=3 R=2: T-1 = 2 rows of U = 5, 3 pairs a row
    # scan: T-2 = 1 scan x 16 = 16; step: 1 x 54 + 6 = 60; sample: 5 x 11 = 55;
    # Box-Muller: 3 x 2 x 10 = 60; update: 6 + 2 x 10 = 26  ->  217 flops.
    # Philox: 6 calls x 62 = 372. bytes: u_prev 10 + ref 4 + state 5 + scal 18
    # + sigma/box 15 + cost 1 + u_num 10 + norm 1 = 64 floats.
    w = rollout_cost_work("full_body", 1, 3, 2)
    assert w == {"flops": 217, "int_ops": 372, "bytes": 4 * 64}
    ms, which = rollout_cost_bound_ms("full_body", 1, 3, 2)
    assert which == "bytes" and ms == pytest.approx(256 / HBM_BYTES_PER_S * 1e3)
    # the second moment adds 2 per control; noise mode reads the noise and
    # draws nothing; the costs-in pass has no scan and no step
    assert rollout_cost_work("full_body", 1, 3, 2, second_moment=True)["flops"] == 237
    wn = rollout_cost_work("full_body", 1, 3, 2, rng=False)
    assert wn == {"flops": 217 - 60, "int_ops": 0, "bytes": 4 * (64 + 10)}
    wc = rollout_cost_work("full_body", 1, 3, 2, costs_in=True)
    assert wc["flops"] == 217 - 16 - 60
    assert rollout_cost_work("full_body", 1, 3, 2, accumulate=False)["flops"] == 217 - 26
    # K and B scale the per-sample work
    w8 = rollout_cost_work("unicycle", 4, 3, 2, num_robots=2)
    assert (w8["flops"], w8["int_ops"]) == (8 * 138, 8 * 124)
    # the flagship is bound by Philox's integer operations
    ms, which = rollout_cost_bound_ms("full_body", 102_400, 30, 30)
    w = rollout_cost_work("full_body", 102_400, 30, 30)
    assert which == "int32" and ms == pytest.approx(w["int_ops"] / INT32_PEAK * 1e3)
    assert w["int_ops"] / INT32_PEAK > w["flops"] / FP32_PEAK


@pytest.mark.parametrize("second_moment", [False, True])
def test_finish_reference_is_the_rescaled_block_sum(second_moment):
    rng = np.random.RandomState(7)
    num_robots, blocks, tm1, u_dim = 3, 9, 4, 5
    nu = tm1 * u_dim
    rs = row_floats(nu, second_moment)
    p = rng.rand(num_robots, blocks, rs) * 2.0
    p[..., 0] = rng.rand(num_robots, blocks) * 1e3  # baselines spread by 1e3
    p[..., 2 + (2 if second_moment else 1) * nu:] = np.nan  # row padding
    lam = np.array([0.5, 1.0, 300.0])
    out = finish_reference(torch.tensor(p, dtype=torch.float32),
                           torch.tensor(lam, dtype=torch.float32), tm1, u_dim,
                           second_moment)
    assert len(out) == (3 if second_moment else 2)
    scale = np.exp(-(p[..., 0] - p[..., 0].min(-1, keepdims=True)) / lam[:, None])
    u_num = np.einsum("bk,bkc->bc", scale, p[..., 2:2 + nu]).reshape(-1, tm1, u_dim)
    norm = np.einsum("bk,bk->b", scale, p[..., 1])
    np.testing.assert_allclose(out[0].numpy(), u_num, rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(out[1].numpy(), norm, rtol=1e-5)
    assert bool(torch.isfinite(out[0]).all())
    if second_moment:
        u2 = np.einsum("bk,bkc->bc", scale, p[..., 2 + nu:2 + 2 * nu])
        np.testing.assert_allclose(out[2].numpy(), u2.reshape(-1, tm1, u_dim),
                                   rtol=1e-5, atol=1e-30)
    # one robot: no leading axis
    one = finish_reference(torch.tensor(p[1], dtype=torch.float32),
                           torch.tensor(lam[1], dtype=torch.float32), tm1, u_dim)
    np.testing.assert_allclose(one[0].numpy(), u_num[1], rtol=1e-5)
    assert math.isclose(float(one[1]), norm[1], rel_tol=1e-5)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119rollout_cost_kernelILi3ELb1ELb1EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119rollout_cost_kernelILi3ELb1ELb1EEEvPKfS2_
    72 bytes stack frame, 40 bytes spill stores, 120 bytes spill loads
ptxas info    : Used 64 registers, 36 bytes smem, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119rollout_cost_kernelILi0ELb0ELb0EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119rollout_cost_kernelILi0ELb0ELb0EEEvPKfS2_
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, 512 bytes cmem[0]
"""


def test_ptxas_report_parser():
    inst = instantiations(build.ptxas_summary(PTXAS_LOG))
    assert inst == {
        ("full_body", True, "store"): {"stack": 72, "spill_stores": 40,
                                       "spill_loads": 120, "registers": 64, "smem": 36},
        ("unicycle", False, "regen"): {"stack": 32, "spill_stores": 0,
                                       "spill_loads": 0, "registers": 48, "smem": 0},
    }
