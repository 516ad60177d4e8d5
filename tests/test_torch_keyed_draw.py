"""The eager arm's keyed draw (ops/sampling.py draw_standard_normals), on the
CPU, where it runs its plain version (core/random.py philox_normals); the
CUDA kernel itself is held against that plain version on the card by
chip_smoke.py phase 31.

- the draw equals ``philox_normals`` bit for bit: robot b's rows of a fleet
  draw are the draw of robot b alone, the draw at ``first_sample`` s is
  samples s... of the draw at 0, and the key tensor draws what the host
  integers draw; its mean and variance are those of standard normals
  (within 5 standard errors);
- the eager ``mppi_step`` in RNG mode at float32 equals the fused kernel's
  plain version in RNG mode (``mppi_step(use_kernel=True)``, which runs
  ``fused_sample_rollout_cost_reference`` and its finish here) within the
  kernel gate, u_opt max |diff| <= 5e-4 max|u| + 5e-5 (scripts/tpu_smoke.py's
  bound, chip_smoke.py ``u_bound``), for the four models, elite 0.1 and
  adapt_sigma (sigma_suggest at rtol 2e-4 atol 1e-6,
  tests/test_solver_options.py:137-139): the two arms draw the same samples;
- the eager fleet equals its ``vmap`` fed ``philox_normals(robot=arange(B))``
  bit for bit, the exported step equals the eager step (rtol 1e-6 atol 1e-7,
  tests/test_torch_export.py's), a checkpoint resumed on the eager arm
  continues the uninterrupted run bit for bit, and the learned sampler's
  imitation data (drawn on the eager fleet) is a function of its generator;
- ``compile_step(use_kernel=False)`` on the CPU is ``mppi_step`` with no
  capture, and a host sync in a graphed function's first run is refused with
  its reason.
"""

import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu_torch.core import ControllerState
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
from ccv_mppi_path_tracker_tpu_torch.core.types import make_key
from ccv_mppi_path_tracker_tpu_torch.diff import collect_imitation_data
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost,
    fused_sample_rollout_cost_reference,
    pack_scalars,
    philox_normals_bound_ms,
    philox_normals_cuda,
    philox_normals_work,
)
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.runtime import run_tracking_experiment
from ccv_mppi_path_tracker_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from ccv_mppi_path_tracker_tpu_torch.runtime.export import (
    export_control_step,
    load_control_step,
)
from ccv_mppi_path_tracker_tpu_torch.solver import (
    build_fleet_step,
    compile_step,
    init_fleet,
    mppi_step,
)
from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph

PRESET_OF = {"full_body": "full_body", "unicycle": "diff_drive",
             "steering_unicycle": "steering_diff_drive",
             "rate_limited_steering": "rate_limited_steering"}
K, T = 256, 10
SIGMA_TOL = dict(rtol=2e-4, atol=1e-6)


def u_bound(u_ref):
    return 5e-4 * float(u_ref.abs().max()) + 5e-5


def _problem(model, k=K, t=T, seed=0):
    cfg, sp, cp, course = PRESETS[PRESET_OF[model]](num_samples=k, horizon=t, device="cpu")
    m = get_model(model)
    rng = np.random.RandomState(seed)
    state = torch.zeros(m.num_states)
    state[1] = float(course[0, 1]) + 0.1
    state[2:] = torch.as_tensor(0.05 * rng.randn(m.num_states - 2), dtype=torch.float32)
    u_prev = torch.as_tensor(0.2 * rng.randn(t - 1, m.num_controls), dtype=torch.float32)
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    return cfg, sp, cp, course, path, state, u_prev


@pytest.mark.parametrize("u_dim", [1, 2, 3, 5])
@pytest.mark.parametrize("first_sample", [0, 2**32 - 40])
def test_the_draw_is_the_plain_philox_draw(u_dim, first_sample):
    got = draw_standard_normals(None, 7, 3, (6, 50, u_dim), first_sample=first_sample,
                                device="cpu")
    want = philox_normals(7, 3, 50, 6, u_dim, first_sample=first_sample)
    assert got.shape == (6, 50, u_dim) and got.dtype == torch.float32
    assert torch.equal(got, want)
    wide = draw_standard_normals(None, 7, 3, (6, 50, u_dim), first_sample=first_sample,
                                 dtype=torch.float64, device="cpu")
    assert wide.dtype == torch.float64 and torch.equal(wide, want.double())


def test_robot_b_of_a_fleet_draw_is_robot_b_alone():
    fleet = draw_standard_normals(None, 11, 4, (5, 7, 40, 3), robot=2, device="cpu")
    assert fleet.shape == (5, 7, 40, 3)
    for b in range(5):
        alone = draw_standard_normals(None, 11, 4, (7, 40, 3), robot=2 + b, device="cpu")
        assert torch.equal(fleet[b], alone)
    assert not torch.equal(fleet[0], fleet[1])
    with pytest.raises(ValueError):
        draw_standard_normals(None, 11, 4, (2, 5, 7, 40, 3), device="cpu")


@pytest.mark.parametrize("start", [1, 97, 200])
def test_the_draw_at_first_sample_s_is_samples_s_of_the_draw_at_0(start):
    whole = draw_standard_normals(None, 2, 9, (8, 300, 5), device="cpu")
    part = draw_standard_normals(None, 2, 9, (8, 300 - start, 5), first_sample=start,
                                 device="cpu")
    assert torch.equal(part, whole[:, start:])


@pytest.mark.parametrize("seed", [0, 5, 2**33 + 5])
def test_the_key_tensor_draws_what_the_host_integers_draw(seed):
    key = make_key(seed, 12, "cpu")
    by_key = draw_standard_normals(key, None, None, (4, 3, 64, 2), robot=1, device="cpu")
    by_value = draw_standard_normals(None, seed, 12, (4, 3, 64, 2), robot=1, device="cpu")
    assert torch.equal(by_key, by_value)
    # the key's device is the draw's: a CPU key draws on the CPU whatever
    # device is named
    assert torch.equal(draw_standard_normals(key, None, None, (4, 3, 64, 2), robot=1,
                                             device="cuda"), by_value)


def test_the_draw_is_standard_normal():
    z = draw_standard_normals(None, 3, 1, (15, 1024, 4), device="cpu").double()
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n ** 0.5
    # var of a sample variance of normals: 2 / n
    assert abs(float(z.var()) - 1.0) < 5 * (2 / n) ** 0.5
    # the cosine and sine halves of a pair are uncorrelated
    assert abs(float(torch.corrcoef(torch.stack([z[..., 0].reshape(-1),
                                                 z[..., 1].reshape(-1)]))[0, 1])) < 0.02


def test_the_kernel_wrapper_takes_the_card_only():
    with pytest.raises(ValueError):
        philox_normals_cuda(None, 1, 2, num_samples=8, tm1=3, u_dim=2, device="cpu")
    with pytest.raises(ValueError):
        philox_normals_cuda(make_key(1, 2, "cpu"), 1, 2, num_samples=8, tm1=3, u_dim=2)
    with pytest.raises(ValueError):
        philox_normals_cuda(None, 1, None, num_samples=8, tm1=3, u_dim=2)


def test_the_draw_s_bound():
    # the flagship full_body draw, (T-1, K, U) = (29, 102400, 5): the stores
    # bound it (59.4 MB at 3.35 TB/s) against 62 int32 ops a pair
    ms, which = philox_normals_bound_ms(102_400, 29, 5)
    assert which == "bytes" and abs(ms - (29 * 102_400 * 5 * 4 + 16) / 3.35e12 * 1e3) < 1e-9
    assert abs(ms - 0.0177) < 1e-4
    work = philox_normals_work(102_400, 29, 5)
    assert work["int_ops"] == 62 * 3 * 29 * 102_400
    assert abs(work["int_ops"] / 33.5e12 * 1e3 - 0.0165) < 1e-4
    # a fleet's draw is B robots' work
    fleet = philox_normals_work(1024, 14, 2, robots=256)
    assert fleet["bytes"] == 4 * 256 * 14 * 1024 * 2 + 16


def _plain_kernel_update(cfg, sp, cp, path, state, u_prev, seed, step):
    """u_opt of the fused kernel's plain version in RNG mode, finished."""
    m = get_model(cfg.model)
    ref = resample_reference(path, state[:2], cp.v_ref, torch.tensor(0.1), cfg.horizon)
    mp = m.default_params(device="cpu") if m.default_params else None
    scal = pack_scalars(torch.tensor(0.1), cp, ref.yaw[0], mp, sp.noise_beta, sp.lam)
    _, u_num, norm = fused_sample_rollout_cost_reference(
        u_prev, sp.control_noise, sp.u_min, sp.u_max, ref.xy, state, scal, seed=seed,
        step=step, num_samples=cfg.num_samples, model=cfg.model, steer_off=cfg.steer_off)
    return u_num / norm


@pytest.mark.parametrize("model", list(PRESET_OF))
@pytest.mark.parametrize("opts", [{}, {"elite_frac": 0.1}, {"adapt_sigma": True}],
                         ids=["vanilla", "elite", "adapt_sigma"])
def test_eager_rng_mode_matches_the_kernel_s_plain_version(model, opts):
    cfg, sp, cp, _, path, state, u_prev = _problem(model, seed=1)
    ctrl = ControllerState(u_prev=u_prev, seed=21, step=4)
    _, eager = mppi_step(cfg, ctrl, state, path, 0.1, sp, cp, **opts)
    launches = fused_sample_rollout_cost.launches
    _, plain = mppi_step(cfg, ctrl, state, path, 0.1, sp, cp, use_kernel=True, **opts)
    assert fused_sample_rollout_cost.launches == launches  # the CPU launches nothing
    err = float((eager.u_opt - plain.u_opt).abs().max())
    assert err <= u_bound(plain.u_opt), (model, opts, err)
    if not opts:
        direct = _plain_kernel_update(cfg, sp, cp, path, state, u_prev, 21, 4)
        assert float((eager.u_opt - direct).abs().max()) <= u_bound(direct)
    if "elite_frac" in opts:
        np.testing.assert_allclose(eager.stats["elite_thresh"].numpy(),
                                   plain.stats["elite_thresh"].numpy(), rtol=2e-5)
    if "adapt_sigma" in opts:
        np.testing.assert_allclose(eager.stats["sigma_suggest"].numpy(),
                                   plain.stats["sigma_suggest"].numpy(), **SIGMA_TOL)
    # another key draws other samples
    _, other = mppi_step(cfg, ControllerState(u_prev, 21, 5), state, path, 0.1, sp, cp,
                         **opts)
    assert not torch.equal(other.u_opt, eager.u_opt)


def test_the_eager_step_draws_from_the_key_where_the_state_has_one():
    cfg, sp, cp, _, path, state, u_prev = _problem("full_body")
    by_value = mppi_step(cfg, ControllerState(u_prev, 8, 3), state, path, 0.1, sp, cp)[1]
    keyed = ControllerState(u_prev, 8, 3, make_key(8, 3, "cpu"))
    by_key = mppi_step(cfg, keyed, state, path, 0.1, sp, cp)[1]
    assert torch.equal(by_value.u_opt, by_key.u_opt)
    noise = philox_normals(8, 3, K, T - 1, 5)
    injected = mppi_step(cfg, keyed, state, path, 0.1, sp, cp, noise=noise)[1]
    assert torch.equal(injected.u_opt, by_key.u_opt)


def test_the_eager_fleet_is_its_vmap_fed_the_philox_draw_of_each_robot():
    cfg, sp, cp, course, path, state, _ = _problem("unicycle", k=64)
    num_robots = 4
    ctrls = init_fleet(cfg, num_robots, seed=6, device="cpu")
    states = state.expand(num_robots, -1) + torch.outer(torch.linspace(-0.2, 0.2, num_robots),
                                                        torch.tensor([0.0, 1.0, 0.0]))
    step = build_fleet_step(cfg)
    for _ in range(2):  # cycles 0 and 1
        nxt, drawn = step(ctrls, states, path, 0.1, sp, cp)
        noise = philox_normals(6, ctrls.step, 64, T - 1, 2, robot=torch.arange(num_robots))
        _, fed = step(ctrls, states, path, 0.1, sp, cp, noise=noise)
        assert torch.equal(drawn.u_opt, fed.u_opt)
        keyless = ControllerState(ctrls.u_prev, ctrls.seed, ctrls.step)
        assert torch.equal(step(keyless, states, path, 0.1, sp, cp)[1].u_opt, drawn.u_opt)
        ctrls = nxt
    # robot 0 is the single-robot eager step of the same key
    _, single = mppi_step(cfg, ControllerState(init_fleet(cfg, 1, seed=6, device="cpu")
                                               .u_prev[0], 6, 0), states[0], path, 0.1, sp, cp)
    _, first = step(init_fleet(cfg, num_robots, seed=6, device="cpu"), states, path, 0.1,
                    sp, cp)
    np.testing.assert_allclose(first.u_opt[0].numpy(), single.u_opt.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_the_exported_step_draws_what_the_eager_step_draws():
    cfg, sp, cp, course, path, state, u_prev = _problem("unicycle", k=64, t=8)
    call = load_control_step(export_control_step(cfg, path_capacity=path.xy.shape[0],
                                                 sp=sp, cp=cp, device="cpu"))
    ctrl = ControllerState(u_prev=u_prev, seed=3, step=5)
    c1, exported = call(ctrl, state, path, 0.1, sp, cp)
    c2, eager = mppi_step(cfg, ctrl, state, path, 0.1, sp, cp)
    for a, b in ((exported.u_opt, eager.u_opt), (exported.opt_states, eager.opt_states),
                 (exported.stats["min_cost"], eager.stats["min_cost"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    assert (c1.seed, c1.step) == (c2.seed, c2.step) == (3, 6)


def test_a_checkpoint_resumes_the_eager_run_bit_for_bit(tmp_path):
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=128, horizon=8, device="cpu")
    whole = run_tracking_experiment(cfg, sp, cp, course, num_steps=12, seed=9)
    half = run_tracking_experiment(cfg, sp, cp, course, num_steps=6, seed=9)
    save_checkpoint(str(tmp_path / "ck.npz"), cfg, half["ctrl"], sp=sp, cp=cp)
    _, ctrl, params = load_checkpoint(str(tmp_path / "ck.npz"), device="cpu")
    assert ctrl.step == 6 and ctrl.key.tolist() == [9, 6]
    rest = run_tracking_experiment(cfg, params["sp"], params["cp"], course, num_steps=6,
                                   ctrl=ctrl, state0=half["logs"]["state"][-1])
    np.testing.assert_array_equal(rest["logs"]["u0"], whole["logs"]["u0"][6:])
    np.testing.assert_array_equal(rest["logs"]["state"], whole["logs"]["state"][6:])


def test_imitation_data_is_a_function_of_its_generator():
    # the learned sampler's data comes from the eager fleet, whose robots draw
    # the Philox stream under a key seeded from the generator: the same
    # generator state gives the same data, another state other data
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=64, horizon=8, device="cpu")

    def collect(seed):
        gen = torch.Generator().manual_seed(seed)
        return collect_imitation_data(cfg, sp, cp, course, gen, num_states=6,
                                      solve_cycles=3)

    (fa, ta), (fb, tb), (_, tc) = collect(5), collect(5), collect(6)
    assert torch.equal(fa, fb) and torch.equal(ta, tb)
    assert ta.shape == (6, 7, 2) and not torch.equal(ta, tc)


@pytest.mark.parametrize("model", ["full_body", "unicycle"])
def test_compile_step_eager_on_the_cpu_is_mppi_step(model):
    cfg, sp, cp, _, path, state, u_prev = _problem(model)
    step = compile_step(cfg, use_kernel=False, elite_frac=0.1)
    c1 = c2 = ControllerState.initial(4, T, u_prev.shape[1], device="cpu")
    for _ in range(3):
        c1, a = step(c1, state, path, 0.1, sp, cp)
        c2, b = mppi_step(cfg, c2, state, path, 0.1, sp, cp, elite_frac=0.1)
        assert torch.equal(a.u_opt, b.u_opt)
        assert torch.equal(a.stats["elite_thresh"], b.stats["elite_thresh"])
    assert step.captures == 0 and c1.step == 3 and c1.key.tolist() == [4, 3]


class _FakeSyncDebug:
    """torch.cuda's sync debug mode, for a CPU test: the mode set, and a
    step that raises torch's sync error as a CUDA ``.item()`` would in mode
    "error" (2)."""

    def __init__(self):
        self.mode = 0

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)

    def read_back(self, x):
        if self.mode == 2:
            raise RuntimeError(f"{cuda_graph.SYNC_ERROR}")
        return float(x.sum())


def test_a_host_sync_in_a_graphed_first_run_is_refused_with_its_reason(monkeypatch):
    fake = _FakeSyncDebug()
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    fake.mode = 1  # the caller's own mode comes back after the block

    def syncing_step(state, u, dt):
        # a user model's step that branches on a value read back to the host
        return state + dt * u if fake.read_back(u) > 0 else state

    with pytest.raises(ValueError) as info:
        with cuda_graph.refuse_host_syncs("the step of a user model"):
            syncing_step(torch.zeros(3), torch.ones(3), 0.1)
    msg = str(info.value)
    assert "no CUDA graph of the step of a user model" in msg
    assert cuda_graph.SYNC_ERROR in msg and "op by op" in msg
    assert fake.mode == 1
    # other errors pass unchanged; a block with no sync runs as it is
    with pytest.raises(KeyError):
        with cuda_graph.refuse_host_syncs("f"):
            raise KeyError("x")
    with cuda_graph.refuse_host_syncs("f"):
        out = torch.zeros(3) + 1
    assert fake.mode == 1 and torch.equal(out, torch.ones(3))
