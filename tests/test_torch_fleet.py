"""The port's fleet (B robots per tick) against the JAX package.

- the kernel's batched plain version against the JAX batched Pallas kernel in
  interpret mode, injected noise, tests/test_kernel.py:130-165's layout at
  B=3, K=2048, T=8 (and a masked tail), every model, with the second moment:
  float32, costs rtol 2e-5, u_opt and u2_num/norm rtol 2e-5 atol 2e-6
  (tests/test_kernel.py's tolerances);
- the batched plain version equal to a loop of the single-robot one, and
  each robot's Philox stream, which both arms draw;
- the eager fleet step against ``jax.vmap`` of the JAX ``mppi_step`` with
  injected noise at float64 rtol 1e-9 atol 1e-12 (tests/test_solver_parity.py's),
  and the kernel arm against the eager arm at float32;
- the ports of tests/test_fleet.py (independent robots, convergence,
  per-robot paths) on both arms, batched resampling, ``convert.py`` with a
  batched path, and the ``fleet`` command on the CPU;
- the fleet's plant (runtime/plant.py fleet_plant_step, the function the
  ``fleet`` command's plant graph holds on the card) against
  ``jax.vmap(model.step)`` at float64 rtol 1e-12, every model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.core.presets import PRESETS as JAX_PRESETS
from ccv_mppi_path_tracker_tpu.kernels.rollout_cost import (
    fused_sample_rollout_cost as jax_fused,
    pack_scalars as jax_pack_scalars,
    padded_k,
    tile_noise,
    tile_rows,
)
from ccv_mppi_path_tracker_tpu.models import get_model as jax_get_model
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.paths import PathBuffer as JaxPathBuffer
from ccv_mppi_path_tracker_tpu.paths import resample_reference as jax_resample
from ccv_mppi_path_tracker_tpu.solver import mppi_step as jax_mppi_step
from ccv_mppi_path_tracker_tpu_torch import cli
from ccv_mppi_path_tracker_tpu_torch.convert import from_numpy
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS, diff_drive_launch
from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    NSCAL,
    fused_sample_rollout_cost,
    fused_sample_rollout_cost_reference,
)
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals
from ccv_mppi_path_tracker_tpu_torch.paths import (
    PathBuffer,
    resample_reference,
    resample_references,
)
from ccv_mppi_path_tracker_tpu_torch.runtime import plant as plant_mod
from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, init_fleet, mppi_step
from test_torch_kernel import MODELS
from test_torch_solver import Case

F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-6)
DT = 0.1


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _fleet_inputs(model, k, t, num_robots=3, seed=0):
    """float32 numpy inputs of one batched kernel call: robots near the
    course of the model's JAX launch preset, each with its own reference
    window and scalars."""
    preset, rest = MODELS[model]
    kw = {"roll_off": False} if model == "full_body" else {}
    _, sp, cp, course = JAX_PRESETS[preset](num_samples=k, horizon=t, dtype=np.float32,
                                            **kw)
    u_dim = np.asarray(sp.u_min).shape[0]
    rng = np.random.RandomState(seed)
    path = JaxPathBuffer.from_points(course, 0.1, dtype=np.float32)
    x = rng.uniform(0.0, 5.0, num_robots)
    states = np.stack([np.r_[x[b], np.interp(x[b], course[:, 0], course[:, 1])
                             + 0.2 * rng.randn(), np.asarray(rest) + 0.05 * rng.randn()]
                       for b in range(num_robots)]).astype(np.float32)
    refs = [jax_resample(path, jnp.asarray(s[:2]), cp.v_ref, jnp.float32(DT), t)
            for s in states]
    mp = jax_default_params() if model == "full_body" else None
    scal = np.stack([np.asarray(jax_pack_scalars(jnp.float32(DT), cp, r.yaw[0], mp,
                                                 noise_beta=sp.noise_beta, lam=sp.lam))
                     for r in refs])
    return {
        "u_prev": (rng.randn(num_robots, t - 1, u_dim) * 0.2).astype(np.float32),
        "sigma": np.asarray(sp.control_noise),
        "u_min": np.asarray(sp.u_min),
        "u_max": np.asarray(sp.u_max),
        "ref_xy": np.stack([np.asarray(r.xy) for r in refs]),
        "state0": states,
        "scal": scal,
        "noise": rng.randn(num_robots, t - 1, k, u_dim).astype(np.float32),
    }


def _port(inp, k, model, noise=True, **kw):
    t = {n: torch.tensor(v) for n, v in inp.items()}
    return fused_sample_rollout_cost(
        t["u_prev"], t["sigma"], t["u_min"], t["u_max"], t["ref_xy"], t["state0"],
        t["scal"], seed=kw.pop("seed", 0), step=kw.pop("step", 0), num_samples=k,
        model=model, noise=t["noise"] if noise else None, **kw)


@pytest.mark.parametrize(
    "model,k",
    [("unicycle", 2048), ("steering_unicycle", 2048), ("rate_limited_steering", 2048),
     ("full_body", 2048), ("unicycle", 1000)],
)
def test_batched_plain_version_matches_jax_batched_kernel(model, k):
    num_robots, t = 3, 8
    inp = _fleet_inputs(model, k, t, num_robots)
    u_dim = inp["u_prev"].shape[-1]
    rows = tile_rows(t, u_dim, True, k)
    noise = jnp.stack([tile_noise(jnp.asarray(n), padded_k(k, rows)) for n in inp["noise"]])
    costs_j, u_part, n_part, m2_part = jax_fused(
        *(jnp.asarray(inp[n]) for n in ("u_prev", "sigma", "u_min", "u_max", "ref_xy",
                                        "state0", "scal")),
        jnp.arange(num_robots, dtype=jnp.int32), num_samples=k, model=model, noise=noise,
        interpret=True, second_moment=True)
    norm_j = np.asarray(n_part).sum(axis=(-2, -1))[:, None, None]
    u_opt_j = np.asarray(u_part).sum(axis=(-2, -1)).reshape(num_robots, t - 1, u_dim) / norm_j
    m2_j = np.asarray(m2_part).sum(axis=(-2, -1)).reshape(num_robots, t - 1, u_dim) / norm_j
    costs, u_num, norm, u2_num = _port(inp, k, model, second_moment=True)
    assert costs.shape == (num_robots, k) and norm.shape == (num_robots,)
    assert u_num.shape == u2_num.shape == (num_robots, t - 1, u_dim)
    close(costs, costs_j, dict(rtol=2e-5))
    close(u_num / norm[:, None, None], u_opt_j, F32)
    close(u2_num / norm[:, None, None], m2_j, F32)


@pytest.mark.parametrize("mode", ["noise", "rng", "costs_only", "costs_in", "second_moment"])
@pytest.mark.parametrize("model", ["unicycle", "full_body"])
def test_batched_plain_version_is_a_loop_of_the_single_robot_one(model, mode):
    k, t = 300, 8
    inp = _fleet_inputs(model, k, t, num_robots=4, seed=3)
    kw = {"noise": mode == "noise", "seed": 9, "step": 2}
    if mode == "costs_only":
        kw["accumulate"] = False
    if mode == "second_moment":
        kw["second_moment"] = True
    if mode == "costs_in":
        inp["scal"][:, 17] = np.median(_port(inp, k, model, accumulate=False)[0].numpy(),
                                       axis=1)
        kw["costs_in"] = torch.tensor(inp["state0"][:, :1] + np.random.RandomState(0)
                                      .rand(4, k).astype(np.float32) * 50.0)
    batched = _port(inp, k, model, **dict(kw))
    for b in range(4):
        one = {n: v[b] if n in ("u_prev", "ref_xy", "state0", "scal", "noise") else v
               for n, v in inp.items()}
        kb = dict(kw)
        if "costs_in" in kb:
            kb["costs_in"] = kw["costs_in"][b]
        single = _port(one, k, model, robot=b, **kb)
        assert len(single) == len(batched)
        for x, y in zip(batched, single):
            assert (x is None and y is None) or torch.equal(x[b], y)


def test_fleet_random_streams_are_per_robot_and_robot_zero_is_the_single_stream():
    rob = philox_normals(5, 3, 200, 4, 3, robot=torch.arange(4))
    assert rob.shape == (4, 4, 200, 3)
    assert torch.equal(rob[0], philox_normals(5, 3, 200, 4, 3))
    for b in range(4):
        assert torch.equal(rob[b], philox_normals(5, 3, 200, 4, 3, robot=b))
    assert torch.equal(philox_normals(5, 3, 200, 4, 3, robot=torch.arange(2, 4)), rob[2:])
    assert not torch.equal(rob[0], rob[1])
    # independent across robots: uncorrelated draws
    assert abs(float(torch.corrcoef(rob[:, :, :, 0].reshape(4, -1))[0, 1])) < 0.05
    # the eager arm's draw is the same stream: robot b of a fleet's draw is
    # the draw of robot b alone, robot 0 the single-robot one
    fleet = draw_standard_normals(None, 5, 3, (4, 4, 200, 3), device="cpu")
    assert torch.equal(fleet, rob)
    one = draw_standard_normals(None, 5, 3, (4, 200, 3), device="cpu")
    assert torch.equal(one, rob[0])
    two = draw_standard_normals(None, 5, 3, (4, 200, 3), robot=2, device="cpu")
    assert torch.equal(two, rob[2])


def _jax_fleet_eager(case, noise, u_prev, states, jpath, path_axis=None, **kw):
    """jax.vmap of the JAX mppi_step with injected per-robot noise."""
    num_robots = u_prev.shape[0]
    ctrls = JaxControllerState(u_prev=jnp.asarray(u_prev),
                               key=jax.random.split(jax.random.PRNGKey(0), num_robots),
                               step=jnp.zeros((num_robots,), jnp.int32))

    def one(ctrl, state, path, nz):
        return jax_mppi_step(case.jcfg, ctrl, state, path, DT, case.jsp, case.jcp,
                             model_params=case.jmp, noise=nz, **kw)

    return jax.vmap(one, in_axes=(0, 0, path_axis, 0))(
        ctrls, jnp.asarray(states), jpath, jnp.asarray(noise))


def _robots(case, num_robots, seed=0):
    rng = np.random.RandomState(seed)
    u_dim = case.u_prev.shape[-1]
    noise = rng.randn(num_robots, case.horizon - 1, case.k, u_dim)
    u_prev = rng.randn(num_robots, case.horizon - 1, u_dim) * 0.1
    states = case.state + np.outer(np.linspace(-0.3, 0.3, num_robots),
                                   np.r_[0.0, 1.0, np.zeros(case.state.size - 2)])
    return noise, u_prev, states


@pytest.mark.parametrize("model", list(MODELS))
def test_eager_fleet_step_matches_jax_vmapped_step_f64(model):
    case = Case(64, horizon=10, model=model)
    noise, u_prev, states = _robots(case, 3)
    _, jres = _jax_fleet_eager(case, noise, u_prev, states, case.jpath)
    step = build_fleet_step(case.cfg)
    ctrls, res = step(ControllerState(torch.as_tensor(u_prev), 0, 0),
                      torch.as_tensor(states), case.path, DT, case.sp, case.cp,
                      model_params=case.mp, noise=torch.as_tensor(noise))
    assert ctrls.step == 1 and res.u0.shape == (3, u_prev.shape[-1])
    for got, want in ((res.u_opt, jres.u_opt), (res.u0, jres.u0), (res.ref.xy, jres.ref.xy),
                      (res.ref.yaw, jres.ref.yaw), (res.opt_states, jres.opt_states),
                      (ctrls.u_prev, jres.u_opt)):
        close(got, want, F64)
    assert set(res.stats) == set(jres.stats)
    for name in res.stats:
        close(res.stats[name], jres.stats[name], F64)


def test_eager_fleet_step_on_per_robot_paths_matches_jax_f64():
    case = Case(64, horizon=10, model="unicycle")
    noise, u_prev, states = _robots(case, 3, seed=1)
    courses = [case.course[: len(case.course) - 20 * b] + [0.0, 0.5 * b] for b in range(3)]
    jpaths = [JaxPathBuffer.from_points(c, 0.1, capacity=len(case.course),
                                        dtype=np.float64) for c in courses]
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jpaths)
    states = states + np.outer(0.5 * np.arange(3), [0.0, 1.0, 0.0])
    _, jres = _jax_fleet_eager(case, noise, u_prev, states, jstacked, path_axis=0)
    paths = PathBuffer.stack([from_numpy(case.jsp, case.jcp, None, case.u_prev, p,
                                         dtype=torch.float64)[4] for p in jpaths])
    step = build_fleet_step(case.cfg, shared_path=False)
    _, res = step(ControllerState(torch.as_tensor(u_prev), 0, 0), torch.as_tensor(states),
                  paths, DT, case.sp, case.cp, noise=torch.as_tensor(noise))
    close(res.u_opt, jres.u_opt, F64)
    close(res.ref.xy, jres.ref.xy, F64)
    with pytest.raises(ValueError):
        build_fleet_step(case.cfg)(ControllerState(torch.as_tensor(u_prev), 0, 0),
                                   torch.as_tensor(states), paths, DT, case.sp, case.cp)


def test_eager_fleet_draws_each_robots_own_generator():
    case = Case(64, horizon=10, model="unicycle", f64=False)
    num_robots = 3
    ctrls = init_fleet(case.cfg, num_robots, seed=4, device="cpu")
    ctrls = ControllerState(ctrls.u_prev, ctrls.seed, 2)
    states = torch.as_tensor(np.tile(case.state, (num_robots, 1)))
    step = build_fleet_step(case.cfg)
    _, drawn = step(ctrls, states, case.path, DT, case.sp, case.cp)
    noise = philox_normals(4, 2, 64, 9, 2, robot=torch.arange(num_robots))
    _, injected = step(ctrls, states, case.path, DT, case.sp, case.cp, noise=noise)
    assert torch.equal(drawn.u_opt, injected.u_opt)
    # same start, different streams: different commands; robot 0 is the
    # single-robot step of the same seed and cycle
    assert float(drawn.u0[:, 1].max() - drawn.u0[:, 1].min()) > 1e-3
    _, single = mppi_step(case.cfg, ControllerState(ctrls.u_prev[0], 4, 2), states[0],
                          case.path, DT, case.sp, case.cp)
    close(drawn.u_opt[0], single.u_opt, dict(rtol=1e-6, atol=1e-7))


def test_kernel_fleet_step_matches_eager_fleet_step_f32():
    case = Case(1000, horizon=12, model="full_body", f64=False)  # masked tail
    noise, u_prev, states = _robots(case, 3, seed=2)
    args = (ControllerState(torch.tensor(u_prev, dtype=torch.float32), 0, 0),
            torch.tensor(states, dtype=torch.float32), case.path, torch.tensor(DT),
            case.sp, case.cp)
    noise = torch.tensor(noise, dtype=torch.float32)
    before = fused_sample_rollout_cost.launches
    _, krn = build_fleet_step(case.cfg, use_kernel=True)(*args, noise=noise)
    _, eag = build_fleet_step(case.cfg)(*args, noise=noise)
    assert fused_sample_rollout_cost.launches == before  # CPU: plain version
    close(krn.u_opt, eag.u_opt, F32)
    close(krn.opt_states, eag.opt_states, F32)
    close(krn.ref.xy, eag.ref.xy, F64)
    close(krn.stats["min_cost"], eag.stats["min_cost"], dict(rtol=2e-5))
    close(krn.stats["ess"], eag.stats["ess"], dict(rtol=1e-3))


def test_each_robot_has_its_own_baseline():
    """One robot's costs offset by 1e3: under a baseline shared across the
    fleet its weights would underflow to zero and its update be NaN."""
    k = 500
    inp = _fleet_inputs("unicycle", k, 8, num_robots=3, seed=5)
    costs = _port(inp, k, "unicycle", accumulate=False)[0]
    off = costs.clone()
    off[1] += 1e3
    _, u_num, norm = _port(inp, k, "unicycle", costs_in=costs)
    _, u_off, n_off = _port(inp, k, "unicycle", costs_in=off)
    assert torch.isfinite(u_off).all() and float(n_off[1]) > 0.0
    close(u_off / n_off[:, None, None], u_num / norm[:, None, None],
          dict(rtol=1e-3, atol=1e-4))  # costs + 1e3 round at the float32 ulp of 1e3


def _fan(course, num_robots, s_dim, spread=0.4):
    states = torch.zeros((num_robots, s_dim))
    states[:, 1] = float(course[0, 1]) + torch.linspace(-spread, spread, num_robots)
    return states


@pytest.mark.parametrize("use_kernel", [False, True], ids=["eager", "kernel"])
def test_fleet_step_independent_robots(use_kernel):
    cfg, sp, cp, course = diff_drive_launch(num_samples=64, horizon=10, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    num_robots = 5
    ctrls2, res = build_fleet_step(cfg, use_kernel=use_kernel)(
        init_fleet(cfg, num_robots, seed=0, device="cpu"), _fan(course, num_robots, 3, 0.5), path,
        torch.tensor(DT), sp, cp)
    assert res.u0.shape == (num_robots, 2) and torch.isfinite(res.u_opt).all()
    assert ctrls2.step == 1 and ctrls2.u_prev.shape == (num_robots, 9, 2)
    assert float(res.u0[:, 1].max() - res.u0[:, 1].min()) > 1e-3


@pytest.mark.parametrize("use_kernel", [False, True], ids=["eager", "kernel"])
def test_fleet_closed_loop_converges_to_course(use_kernel):
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=15, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    num_robots = 4
    ctrls = init_fleet(cfg, num_robots, seed=1, device="cpu")
    states = _fan(course, num_robots, 3)
    step = build_fleet_step(cfg, use_kernel=use_kernel)
    plant = get_model(cfg.model)
    dt = torch.tensor(DT)
    for _ in range(60):
        ctrls, res = step(ctrls, states, path, dt, sp, cp)
        states = plant.step(states, res.u0, dt)
    final = states.numpy()
    d = np.min(np.linalg.norm(final[:, None, :2] - course[None], axis=-1), axis=1)
    assert np.all(d < 0.3), d
    assert np.all(final[:, 0] > 2.0)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["eager", "kernel"])
def test_fleet_per_robot_paths(use_kernel):
    num_robots = 4
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=10, device="cpu")
    courses = np.stack([course + [0.0, 2.0 * b] for b in range(num_robots)])
    paths = PathBuffer.stack([PathBuffer.from_points(c, 0.1, device="cpu") for c in courses])
    states = torch.tensor([[c[0, 0], c[0, 1], 0.0] for c in courses], dtype=torch.float32)
    step = build_fleet_step(cfg, shared_path=False, use_kernel=use_kernel)
    ctrls = init_fleet(cfg, num_robots, device="cpu")
    model = get_model(cfg.model)
    for _ in range(30):
        ctrls, res = step(ctrls, states, paths, DT, sp, cp)
        states = model.step(states, res.u0, DT)
    xy = states.numpy()
    for b in range(num_robots):
        err = abs(xy[b, 1] - np.interp(xy[b, 0], courses[b][:, 0], courses[b][:, 1]))
        assert err < 0.4, (b, err)
        assert xy[b, 0] > 1.0


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_robot"])
def test_resample_references_equals_a_per_robot_loop_and_jax(shared):
    rng = np.random.RandomState(4)
    course = PRESETS["diff_drive"](device="cpu")[3].astype(np.float64)
    lengths = (len(course), len(course) - 30, len(course) - 60)
    jpaths = [JaxPathBuffer.from_points(course[:n] + [0.0, 0.3 * b], 0.1,
                                        capacity=len(course), dtype=np.float64)
              for b, n in enumerate(lengths)]
    if shared:
        jpaths = jpaths[:1] * 3
    paths = [PathBuffer(torch.as_tensor(np.asarray(p.xy)), int(p.num_valid),
                        torch.as_tensor(np.asarray(p.resolution))) for p in jpaths]
    pos = np.c_[rng.uniform(0, 8, 3), rng.randn(3) * 0.5]
    batched_path = paths[0] if shared else PathBuffer.stack(paths)
    got = resample_references(batched_path, torch.as_tensor(pos), 1.2, DT, 12)
    assert got.xy.shape == (3, 12, 2) and got.yaw.shape == (3, 12)
    for b in range(3):
        one = resample_reference(paths[b], torch.as_tensor(pos[b]), 1.2, DT, 12)
        assert torch.equal(got.xy[b], one.xy) and torch.equal(got.yaw[b], one.yaw)
        ref = jax_resample(jpaths[b], jnp.asarray(pos[b]), 1.2, DT, 12)
        close(got.xy[b], ref.xy, F64)
        close(got.yaw[b], ref.yaw, F64)


def test_convert_carries_a_batched_path_and_fleet_warm_start():
    case = Case(64, horizon=10, model="unicycle")
    jpaths = [JaxPathBuffer.from_points(case.course[: len(case.course) - 10 * b], 0.1,
                                        capacity=len(case.course), dtype=np.float64)
              for b in range(3)]
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jpaths)
    u_prev = np.random.RandomState(0).randn(3, 9, 2)
    _, _, _, u, path = from_numpy(case.jsp, case.jcp, None, u_prev, jstacked,
                                  dtype=torch.float64)
    assert u.shape == (3, 9, 2) and torch.equal(u, torch.as_tensor(u_prev))
    assert path.xy.shape == (3, len(case.course), 2)
    assert path.num_valid.tolist() == [len(case.course) - 10 * b for b in range(3)]
    assert path.resolution.shape == (3,)
    pos = np.array([[1.0, 0.5], [3.0, -0.4], [9.5, 0.2]])
    got = resample_references(path, torch.as_tensor(pos), 1.2, DT, 10)
    want = jax.vmap(lambda p, q: jax_resample(p, q, 1.2, DT, 10))(jstacked,
                                                                   jnp.asarray(pos))
    close(got.xy, want.xy, F64)
    close(got.yaw, want.yaw, F64)


@pytest.mark.parametrize("extra", [["--kernel"], ["--no-kernel"]],
                         ids=["kernel", "eager"])
def test_fleet_cli_on_cpu(extra, capsys):
    before = fused_sample_rollout_cost.launches
    rc = cli.main(["fleet", "--device", "cpu", "--robots", "3", "--steps", "20",
                   "--num-samples", "256", *extra])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[-3].startswith("fleet: 3 robots x K=256, 20 ticks, "
                              + ("eager" if "--no-kernel" in extra else "kernel"))
    assert out[-2].startswith("RMSE mean=")
    assert float(out[-2].split("worst=")[1]) < 0.15
    assert out[-1].startswith("wall: ") and "robot-updates/s" in out[-1]
    assert fused_sample_rollout_cost.launches == before


@pytest.mark.parametrize("model", MODELS)
def test_fleet_plant_matches_jax_vmapped_step_f64(model):
    """The fleet's plant against the JAX CLI's ``jax.vmap(model.step)`` (its
    ``jax.jit``, cli.py:411), B=6 robots at float64 rtol 1e-12; on the CPU
    ``step_fleet_plant`` runs it op by op, bit-equal."""
    m = get_model(model)
    rng = np.random.RandomState(11)
    states = rng.randn(6, m.num_states)
    u0 = rng.randn(6, m.num_controls)
    jstep = jax_get_model(model).step
    want = jax.vmap(lambda s, u: jstep(s, u, jnp.float64(DT)))(jnp.asarray(states),
                                                               jnp.asarray(u0))
    dt = torch.tensor(DT, dtype=torch.float64)
    got = plant_mod.fleet_plant_step(model, torch.as_tensor(states), torch.as_tensor(u0), dt)
    close(got, want, dict(rtol=1e-12, atol=1e-14))
    assert torch.equal(plant_mod.step_fleet_plant(model, torch.as_tensor(states),
                                                  torch.as_tensor(u0), dt), got)


def test_fleet_cli_steps_its_plant_through_the_fleet_plant(monkeypatch, capsys):
    """The ``fleet`` command steps its plant once a tick through
    ``step_fleet_plant`` (on the card a graph's replay), on every robot at
    once."""
    calls = []
    real = plant_mod.step_fleet_plant

    def counted(model, states, u0, dt):
        calls.append((model, tuple(states.shape), tuple(u0.shape)))
        return real(model, states, u0, dt)

    monkeypatch.setattr(plant_mod, "step_fleet_plant", counted)
    assert cli.main(["fleet", "--device", "cpu", "--robots", "3", "--steps", "5",
                     "--num-samples", "64"]) == 0
    capsys.readouterr()
    assert calls == [("unicycle", (3, 3), (3, 2))] * 5


def test_fleet_cli_refuses_a_missing_cuda_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["fleet", "--steps", "1"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def _fleet_kernel_args(**over):
    args = dict(
        u_prev=torch.zeros(3, 9, 2), sigma=torch.full((2,), 0.5), u_min=-torch.ones(2),
        u_max=torch.ones(2), ref_xy=torch.rand(3, 10, 2), state0=torch.zeros(3, 3),
        scal=torch.ones(3, NSCAL), model="unicycle",
    )
    args.update(over)
    return args


@pytest.mark.parametrize(
    "over",
    [{"scal": torch.ones(2, NSCAL)}, {"ref_xy": torch.rand(10, 2)},
     {"state0": torch.zeros(3)}, {"noise": torch.zeros(2, 9, 8, 2)},
     {"costs_in": torch.zeros(8)}, {"sigma": torch.full((3, 2), 0.5)},
     {"u_prev": torch.zeros(0, 9, 2)}],
    ids=["scal_robots", "ref_unbatched", "state_unbatched", "noise_robots",
         "costs_in_unbatched", "sigma_per_robot", "no_robots"],
)
def test_kernel_wrapper_rejects_fleet_shapes_it_does_not_take(over):
    with pytest.raises(ValueError):
        fused_sample_rollout_cost(**_fleet_kernel_args(**over), seed=0, step=0,
                                  num_samples=8)


def test_fleet_wrapper_on_cpu_is_the_plain_version():
    args = _fleet_kernel_args(scal=torch.tensor(np.tile(
        np.r_[0.1, 1.2, 10.0, 1.0, [0.0] * 12, 1.0, np.inf], (3, 1)), dtype=torch.float32))
    before = fused_sample_rollout_cost.launches
    a = fused_sample_rollout_cost(**args, seed=1, step=2, num_samples=300)
    b = fused_sample_rollout_cost_reference(**args, seed=1, step=2, num_samples=300)
    assert a[0].shape == (3, 300) and a[1].shape == (3, 9, 2) and a[2].shape == (3,)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert fused_sample_rollout_cost.launches == before
