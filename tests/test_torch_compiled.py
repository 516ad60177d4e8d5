"""The port's compiled execution on the CPU: the counterparts of ``jax.jit``
and ``lax.scan`` (utils/cuda_graph.py; solver/mppi.py compile_step;
runtime/loop.py simulate; solver/batch.py build_fleet_step; runtime/realtime.py)
and the device key they rest on.

A CUDA graph exists only on the card, where chip_smoke.py phase 30 holds the
replays against the op-by-op paths. On the CPU every compiled entry point
runs its plain function, as the caller asked for the CPU. Checked here:

- the kernel's key tensor: the plain version with a (2,) int64 key [seed,
  step] equals it with the key as host integers, bit for bit, in every mode;
- the key invariant ``key == [seed, step]`` through mppi_step, the fleet
  step, ControlLoop, simulate and a checkpoint's save and load;
- compile_step on the CPU is mppi_step, and matches ``jax.jit`` of the JAX
  step with the Pallas kernel in interpret mode (float32 rtol 2e-5 atol
  2e-6, tests/test_kernel.py's tolerance);
- the closed loop: the cycle that the card captures, run eagerly, equals
  simulate; simulate on the kernel path matches JAX build_simulate_scan;
- the cache key: equal across cycles, dt, retuned parameters and a course of
  the same capacity; different across the configuration and the options;
- the plant's process noise from the device key;
- the refusals: a graph of CPU tensors, of a tensor that requires grad.
"""

import dataclasses
import functools
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.runtime.loop import build_simulate_scan
from ccv_mppi_path_tracker_tpu.solver import mppi_step as jax_mppi_step
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
from ccv_mppi_path_tracker_tpu_torch.core.random import plant_normals
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, advance_key, make_key
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    fused_sample_rollout_cost,
    fused_sample_rollout_cost_reference,
)
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.parallel import (
    initialize_multihost,
    samples_group,
    shutdown_multihost,
)
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.runtime import (
    ControlLoop,
    Plant,
    load_checkpoint,
    save_checkpoint,
    simulate,
)
from ccv_mppi_path_tracker_tpu_torch.runtime import loop as loop_mod
from ccv_mppi_path_tracker_tpu_torch.runtime import realtime
from ccv_mppi_path_tracker_tpu_torch.solver import (
    build_fleet_step,
    compile_step,
    init_fleet,
    mppi_step,
)
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import KeyedGraph
from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph
from test_torch_fleet import _fleet_inputs
from test_torch_kernel import MODELS, _inputs
from test_torch_solver import DT, F32, Case, close

K = 96
SEED, STEP = 123_456_789_012, 7  # a seed past 32 bits: both forms keep its low word


def _key_holds(ctrl):
    return torch.equal(ctrl.key, torch.tensor([ctrl.seed, ctrl.step]))


KEY_MODES = [(m, "vanilla") for m in MODELS] + [
    ("full_body", "costs_only"), ("full_body", "costs_in"), ("unicycle", "costs_in"),
    ("unicycle", "second_moment"), ("full_body", "second_moment"),
    ("full_body", "first_sample"), ("rate_limited_steering", "first_sample"),
    ("unicycle", "fleet"), ("full_body", "fleet"), ("full_body", "fleet_second_moment"),
]


@pytest.mark.parametrize("model,mode", KEY_MODES)
def test_plain_version_with_the_key_tensor_equals_the_int_key(model, mode):
    """The RNG mode keyed by a (2,) int64 tensor draws the samples of the
    same key given by value: every output bit-equal."""
    inp = (_fleet_inputs(model, K, 12, num_robots=3) if mode.startswith("fleet")
           else _inputs(K, model))
    t = {n: torch.tensor(v) for n, v in inp.items() if n != "noise"}
    args = (t["u_prev"], t["sigma"], t["u_min"], t["u_max"], t["ref_xy"], t["state0"],
            t["scal"])
    kw = dict(num_samples=K, model=model, second_moment=mode.endswith("second_moment"))
    if mode == "costs_only":
        kw["accumulate"] = False
    if mode == "first_sample":
        kw["first_sample"] = 37
    if mode == "costs_in":
        costs = fused_sample_rollout_cost_reference(*args, SEED, STEP, accumulate=False,
                                                    **kw)[0]
        kw["costs_in"] = costs + 0.5
    by_value = fused_sample_rollout_cost(*args, seed=SEED, step=STEP, **kw)
    by_key = fused_sample_rollout_cost(*args, seed=None, step=None,
                                       key=torch.tensor([SEED, STEP]), **kw)
    assert len(by_value) == len(by_key)
    for a, b in zip(by_value, by_key):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    # another step is another draw
    other = fused_sample_rollout_cost(*args, seed=None, step=None,
                                      key=torch.tensor([SEED, STEP + 1]), **kw)
    assert not torch.equal(by_key[1 if mode != "costs_only" else 0],
                           other[1 if mode != "costs_only" else 0])


def test_the_key_is_checked():
    inp = _inputs(K, "unicycle")
    t = [torch.tensor(inp[n]) for n in ("u_prev", "sigma", "u_min", "u_max", "ref_xy",
                                        "state0", "scal")]
    kw = dict(num_samples=K, model="unicycle")
    with pytest.raises(ValueError, match="not both"):
        fused_sample_rollout_cost(*t, seed=1, step=2, key=torch.tensor([1, 2]), **kw)
    with pytest.raises(ValueError, match="int64"):
        fused_sample_rollout_cost(*t, seed=None, step=None, key=torch.tensor([1, 2, 3]),
                                  **kw)
    with pytest.raises(ValueError, match="int64"):
        fused_sample_rollout_cost(*t, seed=None, step=None,
                                  key=torch.tensor([1.0, 2.0]), **kw)
    with pytest.raises(ValueError, match="needs seed and step"):
        fused_sample_rollout_cost(*t, seed=None, step=None, **kw)


def test_make_and_advance_the_key():
    key = make_key(SEED, 4, "cpu")
    assert key.dtype == torch.int64 and torch.equal(key, torch.tensor([SEED, 4]))
    assert torch.equal(advance_key(key), torch.tensor([SEED, 5]))
    assert torch.equal(advance_key(key, 8), torch.tensor([SEED, 12]))
    assert torch.equal(key, torch.tensor([SEED, 4]))  # not in place
    ctrl = ControllerState(torch.zeros(3, 2), 9, 2)
    assert ctrl.key is None and ctrl.advanced(ctrl.u_prev).key is None
    assert _key_holds(ctrl.with_key()) and _key_holds(ctrl.with_key().advanced(ctrl.u_prev, 3))


# --- the key invariant --------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_the_key_follows_seed_and_step_through_mppi_step(use_kernel):
    case = Case(64, f64=False)
    ctrl = ControllerState.initial(SEED, case.horizon, 5, device="cpu")
    assert _key_holds(ctrl)
    for _ in range(3):
        ctrl, _ = mppi_step(case.cfg, ctrl, torch.as_tensor(case.state), case.path, DT,
                            case.sp, case.cp, model_params=case.mp, use_kernel=use_kernel,
                            lean=True)
        assert _key_holds(ctrl)
    assert ctrl.step == 3


@pytest.mark.parametrize("use_kernel", [False, True])
def test_the_key_follows_seed_and_step_through_the_fleet_step(use_kernel):
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=64, horizon=8, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    ctrls = init_fleet(cfg, 3, seed=SEED, device="cpu")
    states = torch.tensor([[0.0, float(course[0, 1]) + d, 0.0] for d in (-0.2, 0.0, 0.2)])
    step = build_fleet_step(cfg, use_kernel=use_kernel)
    for _ in range(3):
        ctrls, res = step(ctrls, states, path, DT, sp, cp)
        states = get_model(cfg.model).step(states, res.u0, DT)
        assert _key_holds(ctrls)
    # both arms replay on the card; the CPU captures nothing
    assert ctrls.step == 3 and step.graphed.captures == 0


def test_the_key_follows_seed_and_step_through_control_loop_and_simulate(tmp_path):
    cfg, sp, cp, course = PRESETS["full_body"](num_samples=64, horizon=8, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path, sigma_adapt=0.2,
                       solver_options={"use_kernel": True, "lean": True})
    state = torch.tensor([0.0, float(course[0, 1]), 0.0, 0.0, 0.0])
    for i in range(3):
        loop.step(state, dt=0.1 + 0.01 * i)
        assert _key_holds(loop.ctrl)
    assert loop.ctrl.step == 3 and loop.compiled.captures == 0  # the CPU captures nothing
    start = ControllerState.initial(SEED, cfg.horizon, 5, device="cpu")
    ctrl, _ = simulate(cfg, start, state, path, torch.tensor(0.1), sp, cp, num_steps=4,
                       use_kernel=True, with_stats=False)
    assert ctrl.step == 4 and _key_holds(ctrl)
    # a checkpoint holds seed and step; the key is rebuilt from them on load
    save_checkpoint(str(tmp_path / "c.npz"), cfg, ctrl, sp=sp, cp=cp)
    _, loaded, _ = load_checkpoint(str(tmp_path / "c.npz"), device="cpu")
    assert _key_holds(loaded) and torch.equal(loaded.key, ctrl.key)
    resumed, a = simulate(cfg, loaded, state, path, torch.tensor(0.1), sp, cp, num_steps=3,
                          use_kernel=True, with_stats=False)
    cont, b = simulate(cfg, ctrl, state, path, torch.tensor(0.1), sp, cp, num_steps=3,
                       use_kernel=True, with_stats=False)
    assert torch.equal(a["u0"], b["u0"]) and _key_holds(resumed) and resumed.step == 7


# --- compile_step ----------------------------------------------------------------

@pytest.mark.parametrize("model", list(MODELS))
def test_compiled_step_on_the_cpu_is_mppi_step_and_matches_jax_jit(model):
    case = Case(200, f64=False, model=model)  # K=200: a masked tail
    noise = torch.as_tensor(case.noise)
    state = torch.as_tensor(case.state)
    ctrl = ControllerState(case.tu, 0, 0, make_key(0, 0, "cpu"))
    step = compile_step(case.cfg, use_kernel=True, lean=True)
    got_ctrl, got = step(ctrl, state, case.path, DT, case.sp, case.cp,
                         model_params=case.mp, noise=noise)
    ref_ctrl, ref = mppi_step(case.cfg, ctrl, state, case.path, DT, case.sp, case.cp,
                              model_params=case.mp, noise=noise, use_kernel=True, lean=True)
    assert torch.equal(got.u_opt, ref.u_opt) and torch.equal(got_ctrl.key, ref_ctrl.key)
    assert got_ctrl.step == 1 and _key_holds(got_ctrl) and step.captures == 0
    jstep = jax.jit(functools.partial(jax_mppi_step, case.jcfg, use_kernel=True, lean=True,
                                      kernel_interpret=True))
    jctrl = JaxControllerState(u_prev=jnp.asarray(case.u_prev), key=jax.random.PRNGKey(0),
                               step=jnp.zeros((), jnp.int32))
    jnext, jres = jstep(jctrl, jnp.asarray(case.state), case.jpath, DT, case.jsp, case.jcp,
                        model_params=case.jmp, noise=jnp.asarray(case.noise))
    close(got.u_opt, jres.u_opt, F32)
    close(got_ctrl.u_prev, jnext.u_prev, F32)


@pytest.mark.parametrize("opts", [
    {}, {"elite_frac": 0.25}, {"adapt_sigma": True}, {"refine_steps": 2},
    {"shift_warm_start": True, "delay": 0.05},
])
def test_compiled_step_takes_the_options_of_mppi_step(opts):
    """Every option reaches the step (the CPU runs mppi_step): bit-equal to
    mppi_step with the same options and the same injected noise."""
    case = Case(96, f64=False)
    noise = torch.as_tensor(case.noise)
    ctrl = ControllerState(case.tu, 0, 0)
    args = (ctrl, torch.as_tensor(case.state), case.path, DT, case.sp, case.cp)
    _, got = compile_step(case.cfg, use_kernel=True, **opts)(*args, model_params=case.mp,
                                                             noise=noise)
    _, ref = mppi_step(case.cfg, *args, model_params=case.mp, noise=noise, use_kernel=True,
                       **opts)
    assert torch.equal(got.u_opt, ref.u_opt)
    assert set(got.stats) == set(ref.stats)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compiled_step_refuses_the_sharded_step():
    """The sharded step over gloo, whose collectives copy through the host,
    is refused with its state on the card, naming NCCL: nothing runs op by
    op in the graph's place (a stand-in state: this machine has no card).
    Over NCCL it is compiled (tests/test_torch_sharded_programs.py)."""
    case = Case(8)
    on_card = types.SimpleNamespace(u_prev=types.SimpleNamespace(device=torch.device("cuda", 0)))
    assert initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="gloo",
                                timeout_s=30)
    try:
        step = compile_step(case.cfg, use_kernel=True, group=samples_group(device="cpu")[0])
        with pytest.raises(ValueError, match="NCCL"):
            step(on_card, None, case.path, 0.1, case.sp, case.cp)
    finally:
        shutdown_multihost()


# --- the closed loop ---------------------------------------------------------------

@pytest.mark.parametrize("opts,with_stats", [
    ({}, False), ({}, True), ({"elite_frac": 0.25, "elite_stale": True}, True),
    ({"elite_frac": 0.25}, True),
])
def test_the_cycle_run_eagerly_equals_simulate(opts, with_stats):
    """simulate is the scan of loop.cycle, the function the card captures:
    the cycle called N times on the CPU gives simulate's logs and state."""
    cfg, sp, cp, course = PRESETS["full_body"](num_samples=96, horizon=10, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    plant = Plant(model_name="full_body", process_noise=0.01)
    mp = get_model("full_body").default_params(device="cpu")
    start = torch.tensor([0.0, float(course[0, 1]), 0.0, 0.0, 0.0])
    dt = torch.tensor(0.1)
    ctrl0 = ControllerState.initial(3, cfg.horizon, 5, device="cpu")
    last, logs = simulate(cfg, ctrl0, start, path, dt, sp, cp, model_params=mp, plant=plant,
                          num_steps=5, use_kernel=True, solver_options=dict(opts),
                          with_stats=with_stats)
    options = {k: v for k, v in opts.items() if k != "elite_stale"}
    options.update(use_kernel=True, lean=not with_stats)
    thresh = torch.full((), torch.inf) if opts.get("elite_stale") else None
    carry, rows = (ctrl0, start, thresh), []
    for _ in range(5):
        carry, row = loop_mod.cycle(carry, path, dt, sp, cp, mp, cfg, plant, options,
                                    with_stats, False)
        rows.append(row)
    assert set(logs) == set(rows[0])
    for name in logs:
        assert torch.equal(logs[name], torch.stack([r[name] for r in rows])), name
    assert torch.equal(carry[0].u_prev, last.u_prev) and torch.equal(carry[1], logs["state"][-1])
    assert last.step == 5 and _key_holds(last) and _key_holds(carry[0])


def test_scan_and_stack():
    def body(carry, inc):
        return carry + inc, {"x": carry, "pair": (carry * 2, carry.sum())}

    carry, ys = cuda_graph.scan(body, torch.zeros(3), torch.ones(3), length=4)
    assert torch.equal(carry, torch.full((3,), 4.0))
    assert ys["x"].shape == (4, 3) and torch.equal(ys["x"][:, 0], torch.arange(4.0))
    assert torch.equal(ys["pair"][1], torch.tensor([0.0, 3.0, 6.0, 9.0]))
    with pytest.raises(ValueError, match="length"):
        cuda_graph.scan(body, torch.zeros(3), torch.ones(3), length=0)


def test_split_and_fill_a_dict():
    tree = {"a": torch.ones(2), "b": (3, torch.zeros(1)), "c": None}
    leaves = []
    template, key = cuda_graph.split_tensors(tree, leaves)
    hash(key)
    assert len(leaves) == 2 and leaves[0] is tree["a"]
    back = cuda_graph.fill_tensors(template, leaves)
    assert back["a"] is tree["a"] and back["b"][0] == 3 and back["c"] is None
    assert cuda_graph.split_tensors({"a": torch.ones(3), "b": (3, torch.zeros(1)),
                                     "c": None}, [])[1] != key


def test_closed_loop_on_the_kernel_path_matches_jax_build_simulate_scan():
    """simulate(use_kernel=True) with the same injected noise every cycle
    against JAX build_simulate_scan with the Pallas kernel in interpret mode:
    float32 at the kernel's tolerance."""
    case = Case(64, f64=False, horizon=10)
    steps = 4
    sim = build_simulate_scan(case.jcfg, num_steps=steps, use_kernel=True, solver_options={
        "noise": jnp.asarray(case.noise), "kernel_interpret": True})
    jctrl0 = JaxControllerState(u_prev=jnp.asarray(case.u_prev), key=jax.random.PRNGKey(0),
                                step=jnp.zeros((), jnp.int32))
    _, jlogs = sim(jctrl0, jnp.asarray(case.state), case.jpath, jnp.float32(DT), case.jsp,
                   case.jcp, case.jmp)
    ctrl0 = ControllerState(case.tu, 0, 0, make_key(0, 0, "cpu"))
    last, logs = simulate(case.cfg, ctrl0, torch.as_tensor(case.state), case.path,
                          torch.tensor(DT, dtype=torch.float32), case.sp, case.cp,
                          model_params=case.mp, num_steps=steps, use_kernel=True,
                          solver_options={"noise": torch.as_tensor(case.noise)})
    assert set(logs) == set(jlogs)
    close(logs["state"], jlogs["state"], F32)
    close(logs["u0"], jlogs["u0"], F32)
    close(logs["min_cost"], jlogs["min_cost"], dict(rtol=2e-5))
    close(logs["ess"], jlogs["ess"], dict(rtol=1e-3))
    assert last.step == steps and _key_holds(last)


# --- the cache key ---------------------------------------------------------------

def test_the_cache_key_ignores_values_and_host_integers():
    case = Case(64, f64=False)
    state = torch.as_tensor(case.state)
    step = compile_step(case.cfg, use_kernel=True, lean=True)
    ctrl = ControllerState.initial(0, case.horizon, 5, device="cpu")
    kw = dict(model_params=case.mp)
    base = step.cache_key(ctrl, state, case.path, DT, case.sp, case.cp, **kw)
    nxt, res = step(ctrl, state, case.path, DT, case.sp, case.cp, **kw)
    keyless = ControllerState(nxt.u_prev, nxt.seed, nxt.step)
    capacity = case.path.xy.shape[0]
    shorter = PathBuffer.from_points(case.course[:80], 0.1, capacity=capacity,
                                     dtype=torch.float32, device="cpu")
    assert shorter.num_valid != case.path.num_valid
    same = [
        (nxt, state + 0.1, case.path, DT, case.sp, case.cp),          # the next cycle
        (keyless, state, case.path, DT, case.sp, case.cp),            # no key yet
        (ctrl, state, case.path, 0.05, case.sp, case.cp),             # another dt
        (ctrl, state, case.path, torch.tensor(0.2), case.sp, case.cp),
        (ctrl, state, case.path, DT,                                  # retuned
         dataclasses.replace(case.sp, control_noise=case.sp.control_noise * 2),
         dataclasses.replace(case.cp, path_weight=case.cp.path_weight + 1.0)),
        (ctrl, state, shorter, DT, case.sp, case.cp),                 # same capacity
    ]
    for args in same:
        assert step.cache_key(*args, **kw) == base
    longer = PathBuffer.from_points(case.course, 0.1, capacity=capacity + 8,
                                    dtype=torch.float32, device="cpu")
    other = [
        compile_step(dataclasses.replace(case.cfg, num_samples=32), use_kernel=True,
                     lean=True).cache_key(ctrl, state, case.path, DT, case.sp, case.cp, **kw),
        compile_step(case.cfg, use_kernel=True).cache_key(
            ctrl, state, case.path, DT, case.sp, case.cp, **kw),
        compile_step(case.cfg, use_kernel=True, lean=True, elite_frac=0.1).cache_key(
            ctrl, state, case.path, DT, case.sp, case.cp, **kw),
        step.cache_key(ctrl, state, longer, DT, case.sp, case.cp, **kw),
        step.cache_key(ctrl, state, case.path, DT, case.sp, case.cp),  # default params
        step.cache_key(ctrl, state, case.path, DT, case.sp, case.cp,
                       elite_stale_thresh=torch.tensor(1.0), **kw),
    ]
    assert all(key != base for key in other) and len(set(other)) == len(other)


def test_the_loop_s_cache_key_ignores_the_run_s_values():
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=64, horizon=8, device="cpu")
    capacity = len(course)
    plant = Plant(model_name="unicycle")

    def key(ctrl, dt, path):
        return loop_mod.CYCLE.cache_key(
            (ctrl, torch.zeros(3), None), path, dt, sp, cp, None, cfg, plant,
            {"use_kernel": True, "lean": True}, False, False)

    path = PathBuffer.from_points(course, 0.1, device="cpu")
    base = key(ControllerState.initial(0, 8, 2, device="cpu"), torch.tensor(0.1), path)
    shorter = PathBuffer.from_points(course[:50], 0.1, capacity=capacity, device="cpu")
    assert key(ControllerState.initial(5, 8, 2, device="cpu"), torch.tensor(0.05),
               shorter) == base


# --- plant noise -------------------------------------------------------------------

def test_plant_noise_is_drawn_from_the_key():
    a = plant_normals(make_key(3, 0, "cpu"), (5,), torch.float64)
    assert torch.equal(a, plant_normals(torch.tensor([3, 0]), (5,), torch.float64))
    assert not torch.equal(a, plant_normals(make_key(3, 1, "cpu"), (5,), torch.float64))
    assert not torch.equal(a, plant_normals(make_key(4, 0, "cpu"), (5,), torch.float64))
    many = plant_normals(make_key(3, 0, "cpu"), (4, 2500), torch.float64)
    assert many.shape == (4, 2500) and abs(float(many.mean())) < 0.05
    assert abs(float(many.std()) - 1.0) < 0.03
    # cycle 0 of a noisy run moves the state by process_noise * the normals
    # of (seed, 0); the controller's draw is the same in both runs
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=64, horizon=8, device="cpu",
                                                dtype=torch.float64)
    path = PathBuffer.from_points(course, 0.1, dtype=torch.float64, device="cpu")
    start = torch.tensor([0.0, float(course[0, 1]), 0.0], dtype=torch.float64)

    def run(noise):
        ctrl = ControllerState.initial(3, 8, 2, dtype=torch.float64, device="cpu")
        return simulate(cfg, ctrl, start, path, torch.tensor(0.1, dtype=torch.float64), sp,
                        cp, plant=Plant(model_name="unicycle", process_noise=noise),
                        num_steps=3, with_stats=False)[1]["state"]

    noisy, quiet = run(0.01), run(0.0)
    assert torch.equal(noisy, run(0.01))
    np.testing.assert_allclose((noisy[0] - quiet[0]).numpy(),
                               0.01 * plant_normals(make_key(3, 0, "cpu"), (3,),
                                                    torch.float64).numpy(), rtol=1e-9,
                               atol=1e-15)


@pytest.mark.parametrize("use_kernel,dtype", [(False, torch.float64), (True, torch.float32)])
def test_plant_noise_does_not_depend_on_how_the_state_was_built(use_kernel, dtype):
    """A state without a key gets the one its seed and step make: the same
    plant noise and controls as the state built with it, on both arms."""
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=64, horizon=8, device="cpu",
                                                dtype=dtype)
    path = PathBuffer.from_points(course, 0.1, dtype=dtype, device="cpu")
    start = torch.tensor([0.0, float(course[0, 1]), 0.0], dtype=dtype)
    plant = Plant(model_name="unicycle", process_noise=0.01)
    keyed = ControllerState.initial(3, 8, 2, dtype=dtype, device="cpu")
    keyless = ControllerState(keyed.u_prev, 3, 0)
    (ca, a), (cb, b) = [simulate(cfg, c, start, path, torch.tensor(0.1, dtype=dtype), sp, cp,
                                 plant=plant, num_steps=3, use_kernel=use_kernel,
                                 with_stats=False) for c in (keyed, keyless)]
    assert torch.equal(a["state"], b["state"]) and torch.equal(a["u0"], b["u0"])
    assert _key_holds(ca) and _key_holds(cb) and cb.step == 3
    with pytest.raises(ValueError, match="key"):
        plant.step(start, torch.zeros(2, dtype=dtype), 0.1)
    moved = plant.step(start, torch.zeros(2, dtype=dtype), 0.1, key=keyed.key)
    assert not torch.equal(moved, Plant(model_name="unicycle").step(
        start, torch.zeros(2, dtype=dtype), 0.1))


def test_a_graph_copies_what_torch_saw_change():
    """The buffers of a graph are loaded anew from another tensor, from the
    same tensor after a torch in-place op, and from an inference tensor at
    every call; a write through ``.data`` is not seen (the documented
    contract of Graphed)."""
    a, b = torch.ones(2), torch.zeros(3)
    marks = cuda_graph._marks([a, b])
    assert cuda_graph.stale([a, b], marks) == []
    a.add_(1.0)
    assert cuda_graph.stale([a, b], marks) == [0]
    marks = cuda_graph._marks([a, b])
    assert cuda_graph.stale([a, b.clone()], marks) == [1]
    assert cuda_graph.stale([a, b], [(None, None), marks[1]]) == [0]  # a scan's carry
    with torch.inference_mode():
        c = torch.ones(2)
    marks = cuda_graph._marks([c, b])
    assert cuda_graph.stale([c, b], marks) == [0] and cuda_graph.stale([c, b], marks) == [0]
    marks = cuda_graph._marks([a])
    a.data.fill_(5.0)
    assert cuda_graph.stale([a], marks) == []


def test_a_keyed_graph_runs_its_function_off_the_card():
    """Off the card (or with graph=False) a KeyedGraph is its function on
    the arguments as given; its cache key leaves out seed, step, dt's value
    and the path's count."""
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=64, horizon=8, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    state = torch.tensor([0.0, float(course[0, 1]), 0.0])
    seen = []

    def fn(ctrl, path_, dt, x):
        seen.append((ctrl, path_, dt))
        return ctrl.advanced(ctrl.u_prev + x), x * 2

    graph = KeyedGraph(fn)
    ctrl = ControllerState(torch.zeros(7, 2), 4, 2)
    out, y = graph(ctrl, path, 0.1, torch.ones(()), steps=5)
    assert seen[-1] == (ctrl, path, 0.1) and out.step == 3 and torch.equal(y, torch.tensor(2.0))

    def body(carry, path_, dt, x):
        c, s = carry
        return (c.advanced(c.u_prev + x), s + dt), s

    (last, s_last), ys = KeyedGraph(body).scan((ctrl, state), path, 0.1, torch.ones(()),
                                               length=3)
    (ref, s_ref), ys_ref = cuda_graph.scan(body, (ctrl, state), path, 0.1, torch.ones(()),
                                           length=3)
    assert last.step == ref.step == 5 and torch.equal(last.u_prev, ref.u_prev)
    assert torch.equal(s_last, s_ref) and torch.equal(ys, ys_ref) and ys.shape == (3, 3)
    key = graph.cache_key(ctrl, path, 0.1, torch.ones(()))
    other = ControllerState.initial(9, 8, 2, device="cpu").advanced(torch.zeros(7, 2), 6)
    shorter = PathBuffer.from_points(course[:40], 0.1, capacity=path.xy.shape[0],
                                     device="cpu")
    assert graph.cache_key(other, shorter, torch.tensor(0.3), torch.ones(())) == key
    assert graph.cache_key(ctrl, path, 0.1, torch.ones(2)) != key
    assert graph.captures == 0


# --- refusals ----------------------------------------------------------------------

def test_a_graph_refuses_the_cpu_and_a_tensor_that_requires_grad():
    graphed = cuda_graph.Graphed(lambda x: x * 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        graphed(torch.ones(2))
    with pytest.raises(ValueError, match="requires grad"):
        graphed(torch.ones(2, requires_grad=True))
    with pytest.raises(ValueError, match="no tensor"):
        graphed(1.0)
    scanned = cuda_graph.Graphed(lambda c: (c + 1, c))
    with pytest.raises(ValueError, match="one CUDA device"):
        scanned.scan(torch.ones(2), length=3)
    assert graphed.captures == 0 and not graphed.graphs
    assert cuda_graph.refusal([torch.ones(1, device="meta")]) is not None


def test_the_pipelined_window_is_the_cycles_of_mppi_step():
    """realtime.window, the function the card captures for micro_batch > 1:
    M lean updates and model plant steps, the key advanced M times."""
    cfg, sp, cp, course = PRESETS["diff_drive"](num_samples=64, horizon=8, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    state = torch.tensor([0.0, float(course[0, 1]), 0.0])
    dt = torch.tensor(0.1)
    step_kw = dict(model_params=None, use_kernel=True, lean=True)
    ctrl0 = ControllerState.initial(2, 8, 2, device="cpu")
    last, u = realtime.window(ctrl0, path, dt, state, sp, cp, cfg, 3, 0.04, step_kw)
    ctrl, s, expect = ctrl0, state, []
    for _ in range(3):
        ctrl, res = mppi_step(cfg, ctrl, s, path, dt, sp, cp, **step_kw)
        s = get_model("unicycle").step(s, res.u0, 0.04)
        expect.append(res.u0)
    assert torch.equal(u, torch.stack(expect)) and torch.equal(last.u_prev, ctrl.u_prev)
    assert last.step == 3 and _key_holds(last)
