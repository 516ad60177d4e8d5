"""The control step's prologue (kernels/step_prologue.py, csrc/rollout_cost.cu
step_prologue) on the CPU: the plain version against the composition the
step ran before it (resample_reference, pack_scalars, pad_ref_rows, the
translated start state, advance_key), which calls the dispatch hands to the
kernel, the kernel's operands against a float32 emulation of its arithmetic,
the default body parameters as views of the scalar vector, the C entry
point's parameters and constants against the binding, the counters and the
readers ``prologue_fused.update`` / ``.gn``. The kernel itself runs only on
the card: chip_smoke.py phase 37 holds it against the plain version there,
bit for bit."""

import ast
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from benchmark import harness
from ccv_mppi_path_tracker_tpu_torch.core.presets import PRESETS
from ccv_mppi_path_tracker_tpu_torch.core.types import (
    ControllerState,
    RefWindow,
    advance_key,
    make_key,
)
from ccv_mppi_path_tracker_tpu_torch.kernels import rollout_cost as rc
from ccv_mppi_path_tracker_tpu_torch.kernels import step_prologue as pro
from ccv_mppi_path_tracker_tpu_torch.models import get_model
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams, default_params
from ccv_mppi_path_tracker_tpu_torch.ops.mindist import DIST_CAP
from ccv_mppi_path_tracker_tpu_torch.paths import (
    PathBuffer,
    resample_reference,
    resample_references,
)
from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step, init_fleet, mppi_step
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / rc.SOURCE
MODELS = list(PRESETS)          # the presets of the four models
HORIZON, K = 9, 48


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def setup(preset, dtype=torch.float32, robots=None, per_robot=False, seed=0):
    """(cfg, path, state, dt, sp, cp) of one robot near the course, or of a
    fleet of ``robots`` on a shared path or on per-robot paths of other
    lengths, in ``dtype`` on the CPU."""
    cfg, sp, cp, course = PRESETS[preset](num_samples=K, horizon=HORIZON, dtype=dtype,
                                          device="cpu")
    m = get_model(cfg.model)
    g = torch.Generator().manual_seed(seed)
    n = len(course)
    if per_robot:
        lens = torch.randint(n // 2, n + 1, (robots,), generator=g).tolist()
        path = PathBuffer.stack([PathBuffer.from_points(course[:ln] + 0.1 * i, 0.1,
                                                        capacity=n, dtype=dtype, device="cpu")
                                 for i, ln in enumerate(lens)])
    else:
        path = PathBuffer.from_points(course, 0.1, capacity=n + 7, dtype=dtype, device="cpu")
    lead = () if robots is None else (robots,)
    idx = torch.randint(0, n, lead, generator=g)
    at = torch.as_tensor(course, dtype=dtype)[idx]
    state = torch.cat([at + 0.3 * torch.randn(lead + (2,), generator=g, dtype=dtype),
                       0.1 * torch.randn(lead + (m.num_states - 2,), generator=g,
                                         dtype=dtype)], dim=-1)
    dt = torch.tensor(0.1, dtype=dtype)
    return cfg, path, state, dt, sp, cp


def composition(cfg, path, state, dt, sp, cp, model_params=None, cost_thresh=None, key=None):
    """What the step ran before the prologue existed (solver/mppi.py and
    solver/batch.py's kernel arms, kernels/rollout_cost.py KernelLaunch):
    (ref, scal, model_params, refc, s0, next key)."""
    model = get_model(cfg.model)
    if model_params is None and model.default_params is not None:
        model_params = model.default_params(device=state.device, dtype=state.dtype)
    if state.dim() == 1:
        ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
        scal = rc.pack_scalars(dt, cp, ref.yaw[0], model_params, sp.noise_beta, sp.lam,
                               cost_thresh=cost_thresh)
    else:
        ref = resample_references(path, state[:, :2], cp.v_ref, dt, cfg.horizon)
        scal = rc.pack_scalars(dt, cp, ref.yaw[:, 0], model_params, sp.noise_beta, sp.lam,
                               cost_thresh=cost_thresh)
    refc, s0 = centred(ref.xy, state)
    return ref, scal, model_params, refc, s0, None if key is None else advance_key(key)


def centred(ref_xy, state):
    """The fused launch's centred rows and start state as KernelLaunch makes
    them where no prologue gives them: (refc, s0)."""
    c, refc = rc.pad_ref_rows(ref_xy)
    return refc, torch.cat([state[..., :2] - c, state[..., 2:]], dim=-1).contiguous()


def bits(t):
    """Bit patterns, so that -0.0 and +0.0 differ."""
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    if t.dtype == torch.float64:
        return t.contiguous().view(torch.int64)
    return t


def same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))


def params_same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))


# --- the plain version is the old composition -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", ["robot", "fleet_shared", "fleet_own"])
@pytest.mark.parametrize("preset", MODELS)
def test_the_plain_prologue_is_the_old_composition(preset, shape, dtype):
    robots = None if shape == "robot" else 5
    cfg, path, state, dt, sp, cp = setup(preset, dtype, robots, shape == "fleet_own",
                                         seed=len(preset))
    key = make_key(11, 4, "cpu")
    thresh = torch.tensor(30.0, dtype=dtype) if shape == "robot" else None
    got = pro.step_prologue_plain(cfg, path, state, dt, sp, cp, None, thresh, key)
    ref, scal, mp, refc, s0, next_key = composition(cfg, path, state, dt, sp, cp, None,
                                                    thresh, key)
    assert same(got.ref.xy, ref.xy) and same(got.ref.yaw, ref.yaw)
    assert same(got.scal, scal) and same(got.next_key, next_key)
    assert params_same(got.model_params, mp)
    assert all(same(a, b) for a, b in zip(centred(got.ref.xy, state), (refc, s0)))


def test_the_plain_prologue_makes_no_launch_operands_off_the_card(monkeypatch):
    """The plain version leaves the centred rows, the start state and the
    tickets to the fused launch, off the card and on it alike."""
    for card in (False, True):
        monkeypatch.setattr(pro, "_on_card", lambda t: card)
        for robots in (None, 3):
            cfg, path, state, dt, sp, cp = setup("full_body", robots=robots)
            got = pro.step_prologue_plain(cfg, path, state, dt, sp, cp)
            assert got.refc is None and got.s0 is None and got.tickets is None
            assert got.launch is None and got.next_key is None


# --- the dispatch ------------------------------------------------------------------------------

@pytest.fixture
def on_the_card(monkeypatch):
    """Dispatch as if the tensors were on the card, the launcher replaced by
    one that records its call and returns the emulated kernel's outputs."""
    launched = []

    def launch(**ops):
        launched.append(ops)
        return emulate(**ops)

    monkeypatch.setattr(pro, "_on_card", lambda t: True)
    monkeypatch.setattr(pro, "step_prologue_cuda", launch)
    return launched


def refuse(**ops):
    raise AssertionError("the prologue kernel was launched")


@pytest.mark.parametrize("preset", MODELS)
def test_a_float32_call_on_the_card_goes_to_the_kernel(preset, on_the_card):
    cfg, path, state, dt, sp, cp = setup(preset)
    out = pro.step_prologue(cfg, path.with_count_tensor(), state, dt, sp, cp,
                            key=make_key(3, 1, "cpu"), num_samples=1000)
    (ops,), = [on_the_card]
    assert ops["tickets_per_robot"] == pro.ticket_count(1000) == 2
    assert ops["horizon"] == HORIZON and ops["num_robots"] == 1 and ops["lead"] == ()
    assert ops["sources"][pro.YAW_SLOT] is None and ops["sources"][0] is dt
    assert out.tickets is not None and not out.tickets.any()
    assert profiling.counters() == {"step.kernel_updates": 1, "step.prologue_fused": 1}


@pytest.mark.parametrize("case", ["cpu", "float64", "float64_path", "float64_dt", "grad_state",
                                  "grad_param", "grad_path", "window"])
def test_the_op_by_op_prologue_runs_where_the_kernel_does_not_take_the_call(case, on_the_card,
                                                                            monkeypatch):
    """Off the card, in float64 (the whole call, or the path or dt alone),
    with grad or past the window's limit, the call runs op by op: the plain
    version, counted in step.kernel_updates only (as on the card)."""
    monkeypatch.setattr(pro, "step_prologue_cuda", refuse)
    if case == "cpu":
        monkeypatch.setattr(pro, "_on_card", lambda t: t.is_cuda)
    cfg, path, state, dt, sp, cp = setup("full_body",
                                         torch.float64 if case == "float64" else torch.float32)
    if case == "float64_path":
        path = dataclasses.replace(path, xy=path.xy.double())
    if case == "float64_dt":
        dt = dt.double()
    if case == "grad_state":
        state = state.clone().requires_grad_(True)
    if case == "grad_param":
        cp = dataclasses.replace(cp, path_weight=cp.path_weight.clone().requires_grad_(True))
    if case == "grad_path":
        path = dataclasses.replace(path, xy=path.xy.clone().requires_grad_(True))
    if case == "window":
        cfg = dataclasses.replace(cfg, horizon=pro.MAX_WINDOW + 1)
    assert pro._kernel_operands(cfg, path, state, dt, sp, cp, None, None, None) is None
    if case in ("cpu", "float64", "float64_dt", "grad_state", "grad_param"):
        with torch.enable_grad():
            pro.step_prologue(cfg, path, state, dt, sp, cp)
        counted = profiling.counters()
        assert counted.get("step.prologue_fused") is None
        assert counted.get("step.kernel_updates") == (None if case == "cpu" else 1)


def test_no_kernel_under_a_torch_func_transform(on_the_card):
    cfg, path, state, dt, sp, cp = setup("full_body")
    seen = []

    def probe(x):
        seen.append(pro._kernel_operands(cfg, path, state, dt, sp, cp, None, None, None))
        pro.step_prologue(cfg, path, state, dt, sp, cp)
        return x

    torch.func.vmap(probe)(torch.ones(2))
    assert seen == [None] and on_the_card == []
    assert profiling.counters() == {}         # nothing counted under the transform
    assert pro._kernel_operands(cfg, path, state, dt, sp, cp, None, None, None) is not None


def test_the_kernel_takes_numbers_for_the_other_scalars(on_the_card):
    """A weight, the threshold or a body parameter given as a number (a bool
    too, 1.0 as the op-by-op fill makes it) is a constant of the launch, as
    the op-by-op fill was a constant of the graph; another kind of value is
    refused."""
    cfg, path, state, dt, sp, cp = setup("full_body")
    cp = dataclasses.replace(cp, yaw_weight=2.5)
    sp = dataclasses.replace(sp, noise_beta=0)
    ops = pro._kernel_operands(cfg, path, state, dt, sp, cp, None, 70.0, None)
    assert ops["sources"][7] == 2.5 and ops["sources"][15] == 0 and ops["sources"][17] == 70.0
    flag = dataclasses.replace(sp, noise_beta=True)
    ops = pro._kernel_operands(cfg, path, state, dt, flag, cp, None, None, None)
    assert ops["sources"][15] is True
    assert same(emulate(**ops).scal, pro.step_prologue_plain(cfg, path, state, dt, flag,
                                                              cp).scal)
    with pytest.raises(TypeError, match="slot 15"):
        pro._kernel_operands(cfg, path, state, dt, dataclasses.replace(sp, noise_beta="0.1"),
                             cp, None, None, None)


@pytest.mark.parametrize("case", ["state_shape", "path_device", "per_robot_path_one_robot",
                                  "per_robot_path_number_count", "float_count", "key_dtype",
                                  "key_shape", "window_of_one", "slot_shape", "dt_per_robot",
                                  "both_numbers"])
def test_an_operand_neither_prologue_takes_is_refused_on_the_card(case, on_the_card,
                                                                 monkeypatch):
    """On the card an operand of a shape, device or kind that the kernel does
    not read raises, in place of a silent detour through the op-by-op
    prologue: ValueError where the op-by-op prologue or the fused launch
    after it fails too, TypeError for dt and v_ref both numbers (their
    product op by op rounds in double, the kernel's in float32)."""
    monkeypatch.setattr(pro, "step_prologue_cuda", refuse)
    fleet = case in ("dt_per_robot", "slot_shape", "per_robot_path_number_count")
    cfg, path, state, dt, sp, cp = setup("full_body", robots=4 if fleet else None)
    key = make_key(1, 2, "cpu")
    if case == "state_shape":
        state = state[:4]
    if case == "path_device":
        path = dataclasses.replace(path, resolution=torch.empty((), device="meta"))
    if case == "per_robot_path_one_robot":
        path = PathBuffer.stack([path, path])
    if case == "per_robot_path_number_count":
        path = dataclasses.replace(PathBuffer.stack([path] * 4), num_valid=int(path.num_valid))
    if case == "float_count":
        path = dataclasses.replace(path, num_valid=torch.tensor(float(path.num_valid)))
    if case == "key_dtype":
        key = key.to(torch.int32)
    if case == "key_shape":
        key = torch.zeros(3, dtype=torch.int64)
    if case == "window_of_one":
        cfg = dataclasses.replace(cfg, horizon=1)
    if case == "slot_shape":
        cp = dataclasses.replace(cp, path_weight=torch.ones(3))
    if case == "dt_per_robot":
        dt = torch.full((4,), 0.1)
    if case == "both_numbers":
        dt, cp = 0.1, dataclasses.replace(cp, v_ref=float(cp.v_ref))
    error = TypeError if case == "both_numbers" else ValueError
    with pytest.raises(error):
        pro._kernel_operands(cfg, path, state, dt, sp, cp, None, None, key)
    with pytest.raises(error):
        pro.step_prologue(cfg, path, state, dt, sp, cp, key=key)
    assert profiling.counters() == {}


@pytest.mark.parametrize("shape", ["shared", "shared_count", "own"])
def test_a_fleet_goes_to_the_kernel_with_per_robot_operands(shape, on_the_card):
    cfg, path, states, dt, sp, cp = setup("diff_drive", robots=4, per_robot=shape == "own")
    if shape == "shared_count":
        path = path.with_count_tensor()
    thresh = torch.arange(4.0) + 10.0
    ops = pro._kernel_operands(cfg, path, states, dt, sp, cp, None, thresh, None)
    assert ops["num_robots"] == 4 and ops["lead"] == (4,)
    assert ops["xy_per_robot"] == (shape == "own")
    assert ops["sources"][17] is thresh
    strided = torch.arange(8.0)[::2]
    ops = pro._kernel_operands(cfg, path, states, dt, sp, cp, None, strided, None)
    assert ops["sources"][17].is_contiguous() and same(ops["sources"][17], strided)


# --- the kernel's arithmetic, emulated -----------------------------------------------------------

def emulate(model, lead, num_robots, xy, xy_per_robot, nv, res, state, key, sources, horizon,
            model_params, tickets_per_robot=0):
    """A float32 emulation of csrc step_prologue_kernel on the operands of
    _kernel_operands: one robot at a time, each expression one rounding, the
    scalar slots from their sources (a tensor's element, or the number
    rounded to float32 as ctypes passes it). Returns what
    step_prologue_cuda returns, and adds to the counters as the kernel does."""
    f32 = torch.float32
    st = state.reshape(num_robots, -1)
    out = {k: [] for k in ("xy", "yaw", "refc", "s0", "scal")}
    r4 = rc.pad_ref_count(horizon)
    for b in range(num_robots):
        pts = xy[b] if xy_per_robot else xy
        n = int(nv[b] if isinstance(nv, torch.Tensor) and nv.dim() else nv)
        d = pts[:n] - st[b, :2]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
        best, i = torch.min(d2, dim=0)
        cur = int(i) if float(best) < DIST_CAP * DIST_CAP else 0

        def slot(j):
            v = sources[j]
            if isinstance(v, torch.Tensor):
                return v[b] if v.dim() else v
            return torch.tensor(float(v), dtype=f32)

        r = res[b] if res.dim() else res
        step = (slot(1) * slot(0)) / r
        idx = [min(cur + int(torch.floor(torch.tensor(float(t), dtype=f32) * step)), n - 1)
               for t in range(horizon)]
        w = pts[idx]
        seg = w[1:] - w[:-1]
        yaw = torch.atan2(seg[:, 1], seg[:, 0])
        yaw = torch.cat([yaw, yaw[-1:]])
        rc_ = w - w[0]
        rows = torch.zeros((r4, 4), dtype=f32)
        rows[:, 2] = float("inf")
        rows[:horizon, 0] = 2.0 * rc_[:, 0]
        rows[:horizon, 1] = 2.0 * rc_[:, 1]
        rows[:horizon, 2] = rc_[:, 0] * rc_[:, 0] + rc_[:, 1] * rc_[:, 1]
        rows[:horizon, 3] = 0.0
        s0 = st[b].clone()
        s0[:2] = st[b, :2] - w[0]
        scal = torch.stack([yaw[0] if j == pro.YAW_SLOT else slot(j) for j in range(rc.NSCAL)])
        for k, v in zip(out, (w, yaw, rows, s0, scal)):
            out[k].append(v)
    xs = {k: torch.stack(v).reshape(lead + v[0].shape) for k, v in out.items()}
    profiling.device_group(pro.UPDATES, state.device).add_(1)
    profiling.device_group(pro.FUSED, state.device).add_(1)
    mp = model_params
    if mp is None and model.default_params is not None:
        s = xs["scal"]
        mp = FullBodyParams(mass=s[..., 9], base2com=s[..., 10], inertia=s[..., 11:14],
                            gravity_z=s[..., 14])
    tickets = torch.zeros(num_robots * tickets_per_robot, dtype=torch.int32) \
        if tickets_per_robot else None
    next_key = None if key is None else torch.stack([key[0], key[1] + 1])
    return pro.Prologue(RefWindow(xs["xy"], xs["yaw"]), xs["scal"], mp, xs["refc"], xs["s0"],
                        tickets, next_key)


@pytest.mark.parametrize("variant", ["plain", "thresh", "no_key", "params", "count_tensor",
                                     "fleet_shared", "fleet_own", "fleet_thresh", "number_dt",
                                     "number_v_ref", "float64_weight", "int32_count",
                                     "fleet_one_element"])
@pytest.mark.parametrize("preset", MODELS)
def test_the_kernel_s_operands_give_the_plain_outputs(preset, variant, monkeypatch):
    """The float32 emulation of the kernel on the operands the dispatch
    hands it equals the plain version bit for bit: the slot order, the
    default constants, the per-robot flags and the threshold's +inf, and
    the operands it converts (a number dt or v_ref a constant of the launch,
    a float64 weight cast, an int32 count widened, a fleet's (1,) threshold
    read as a scalar)."""
    monkeypatch.setattr(pro, "_on_card", lambda t: True)
    fleet = variant.startswith("fleet")
    cfg, path, state, dt, sp, cp = setup(preset, robots=6 if fleet else None,
                                         per_robot=variant == "fleet_own", seed=3)
    if variant == "count_tensor":
        path = path.with_count_tensor()
    if variant == "int32_count":
        path = dataclasses.replace(path, num_valid=torch.tensor(path.num_valid - 3,
                                                                dtype=torch.int32))
    if variant == "number_dt":
        dt = 0.1
    if variant == "number_v_ref":
        cp = dataclasses.replace(cp, v_ref=float(cp.v_ref) + 0.07)
    if variant == "float64_weight":
        cp = dataclasses.replace(cp, path_weight=torch.tensor(1.0 / 3.0, dtype=torch.float64))
    thresh = {"thresh": torch.tensor(25.0), "fleet_one_element": torch.tensor([31.7]),
              "fleet_thresh": torch.linspace(5.0, 60.0, 6)}.get(variant)
    key = None if variant == "no_key" else make_key(9, 2, "cpu")
    mp = None
    if variant == "params" and get_model(cfg.model).default_params is not None:
        d = default_params(device="cpu")
        mp = FullBodyParams(d.mass * 1.5, d.base2com, d.inertia * 0.5, d.gravity_z)
    ops = pro._kernel_operands(cfg, path, state, dt, sp, cp, mp, thresh, key)
    got = emulate(**ops, tickets_per_robot=3)
    want = pro.step_prologue_plain(cfg, path, state, dt, sp, cp, mp, thresh, key)
    refc, s0 = centred(want.ref.xy, state)
    for name in ("scal", "next_key"):
        assert same(getattr(got, name), getattr(want, name)), name
    assert same(got.refc, refc) and same(got.s0, s0)
    assert same(got.ref.xy, want.ref.xy) and same(got.ref.yaw, want.ref.yaw)
    assert got.tickets.shape == ((6 if fleet else 1) * 3,)


def test_default_body_parameters_are_views_of_the_scalars(on_the_card):
    """Where no parameters are given the kernel writes full_body's defaults
    into slots 9-14 and the step takes them as views there: equal to
    default_params, the inertia a (3,) view."""
    cfg, path, state, dt, sp, cp = setup("full_body")
    out = pro.step_prologue(cfg, path, state, dt, sp, cp)
    mp, d = out.model_params, default_params(device="cpu")
    assert mp.inertia.shape == (3,) and mp.inertia.data_ptr() == out.scal[11:].data_ptr()
    assert mp.mass.data_ptr() == out.scal[9:].data_ptr()
    assert params_same(mp, d)
    assert pro._default_values("full_body") == tuple(
        float(v) for v in (d.mass, d.base2com, *d.inertia, d.gravity_z))
    assert pro._default_values("unicycle") == (0.0,) * 6
    given = FullBodyParams(d.mass * 2, d.base2com, d.inertia, d.gravity_z)
    assert pro.step_prologue(cfg, path, state, dt, sp, cp, given).model_params is given


# --- the step takes the prologue's outputs ------------------------------------------------------

@pytest.mark.parametrize("opts", [dict(lean=True), dict(lean=False),
                                  dict(lean=True, elite_frac=0.25),
                                  dict(lean=True, refine_steps=2, refine_method="gauss_newton"),
                                  dict(lean=True, shift_warm_start=True, delay=0.05)],
                         ids=["lean", "full", "elite", "gauss_newton", "shift_delay"])
def test_the_step_with_the_kernel_s_prologue_equals_the_step_without(opts, on_the_card,
                                                                    monkeypatch):
    """mppi_step's kernel path on the emulated kernel's outputs (the
    window, the scalars, the body parameters as views, the next key) equals
    its path on the op-by-op prologue, over three chained updates."""
    from ccv_mppi_path_tracker_tpu_torch.diff import gradients

    monkeypatch.setattr(gradients, "_on_card", lambda t: False)
    cfg, path, state, dt, sp, cp = setup("full_body", seed=7)
    runs = {}
    for arm in ("kernel", "plain"):
        if arm == "plain":
            monkeypatch.setattr(pro, "_kernel_operands", lambda *a: None)
        ctrl = ControllerState.initial(5, HORIZON, 5, device="cpu")
        seq = []
        for _ in range(3):
            ctrl, res = mppi_step(cfg, ctrl, state, path, dt, sp, cp, use_kernel=True, **opts)
            seq.append((ctrl.u_prev, ctrl.key, res.ref))
        runs[arm] = seq
    assert len(on_the_card) == 3
    for (u_k, key_k, ref_k), (u_p, key_p, ref_p) in zip(runs["kernel"], runs["plain"]):
        assert same(u_k, u_p) and same(key_k, key_p)
        assert (ref_k is None) == (ref_p is None)
        if ref_k is not None:
            assert same(ref_k.xy, ref_p.xy) and same(ref_k.yaw, ref_p.yaw)
    assert [int(k[1]) for _, k, _ in runs["kernel"]] == [1, 2, 3]


def test_the_fleet_tick_with_the_kernel_s_prologue_equals_the_tick_without(on_the_card,
                                                                          monkeypatch):
    cfg, path, states, dt, sp, cp = setup("full_body", robots=3, seed=2)
    runs = {}
    for arm in ("kernel", "plain"):
        if arm == "plain":
            monkeypatch.setattr(pro, "_kernel_operands", lambda *a: None)
        tick = build_fleet_step(cfg, use_kernel=True)
        ctrls = init_fleet(cfg, 3, seed=4, device="cpu")
        seq = []
        for _ in range(2):
            ctrls, res = tick(ctrls, states, path, dt, sp, cp)
            seq.append((ctrls.u_prev, ctrls.key, res.ref.xy, res.ref.yaw))
        runs[arm] = seq
    assert len(on_the_card) == 2
    for a, b in zip(runs["kernel"], runs["plain"]):
        assert all(same(x, y) for x, y in zip(a, b))


def test_the_op_by_op_prologue_counts_an_update_on_the_card(monkeypatch):
    """On the card the plain version adds 1 to step.kernel_updates with one
    add onto the device counter; the CPU counts nothing."""
    cfg, path, state, dt, sp, cp = setup("unicycle" if "unicycle" in PRESETS else "diff_drive")
    pro.step_prologue(cfg, path, state, dt, sp, cp)
    assert profiling.counters() == {}
    monkeypatch.setattr(pro, "_on_card", lambda t: True)
    monkeypatch.setattr(pro, "_kernel_operands", lambda *a: None)
    for _ in range(3):
        pro.step_prologue(cfg, path, state, dt, sp, cp)
    assert profiling.counters() == {"step.kernel_updates": 3}


# --- the source and the binding ---------------------------------------------------------------

HIGHER = ("paths", "solver", "diff", "parallel", "runtime", "metrics", "cli")


@pytest.mark.parametrize("name", ["build", "gauss_newton", "rollout_cost", "step_prologue"])
def test_the_kernels_import_no_higher_layer_when_imported(name):
    """kernels/ sits below paths/ and solver/: a kernel module imports them,
    for its plain version, only inside the function that needs them."""
    tree = ast.parse((ROOT / "ccv_mppi_path_tracker_tpu_torch" / "kernels" / f"{name}.py")
                     .read_text())
    top = [n.module for n in tree.body if isinstance(n, ast.ImportFrom) and n.module]
    up = [m for m in top if m.split(".")[1:2] and m.split(".")[1] in HIGHER]
    assert up == []

LETTERS = [(r"^(const\s+)?(float|long long|unsigned int|void)\s*\*", "p"),
           (r"^long long\s+\w+$", "l"), (r"^unsigned int\s+\w+$", "u"), (r"^int\s+\w+$", "i"),
           (r"^float\s+\w+$", "f")]


def c_letters(name):
    """The entry point ``name``'s parameters in csrc/rollout_cost.cu, one
    letter each, read from its definition."""
    src = SOURCE.read_text()
    params = re.search(rf"\nint {name}\((.*?)\)\s*\{{", src, re.S).group(1)
    out = ""
    for p in (" ".join(x.split()) for x in params.split(",")):
        out += next(letter for pattern, letter in LETTERS if re.search(pattern, p))
    return out


@pytest.mark.parametrize("name", ["step_prologue", "rollout_cost", "philox_normals"])
def test_the_ctypes_signature_is_the_entry_point_s_parameter_list(name):
    assert c_letters(name) == rc.SIGNATURE[name]


def test_the_constants_and_the_scalars_struct_are_the_source_s():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (kPrologue\w+) = (\d+);", src))
    assert int(consts["kPrologueThreads"]) == pro.THREADS
    assert int(consts["kPrologueMaxWindow"]) == pro.MAX_WINDOW
    assert int(consts["kPrologueMaxState"]) == pro.MAX_STATE
    slots = re.search(r"enum Scal \{(.*?)\};", src, re.S).group(1).replace("\n", " ")
    names = [s.strip() for s in slots.split(",")]
    assert names.index("kYawRef0") == pro.YAW_SLOT and names.index("kNScal") == rc.NSCAL
    struct = re.search(r"struct PrologueScalars \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(const float\*|float|int) (\w+)\[kNScal\];", struct)
    assert [f for _, f in fields] == [f for f, _ in pro.PrologueScalars._fields_]
    assert [t for t, _ in fields] == ["const float*", "float", "int"]
    assert "step_prologue_kernel" in src and "rollout_cost_kernel" not in "step_prologue_kernel"


@pytest.mark.parametrize("k,want", [(1000, 2), (102400, 101), (32, 2), (33 * 32, 3), (1, 2)])
def test_the_tickets_cover_every_launch_shape(k, want):
    """A robot's tickets at K samples cover the finish of every launch shape
    the chooser may pick, whatever the block size."""
    assert pro.ticket_count(k) == want
    for model in rc.KERNEL_MODELS:
        for threads in range(32, rc.MAX_THREADS + 1, 32):
            shape = rc.launch_shape(model, k, 30, 30, threads=threads)
            assert rc.finish_groups(shape.blocks) + 1 <= pro.ticket_count(k)


# --- the readers ------------------------------------------------------------------------------

@pytest.mark.parametrize("metric,cell", [("prologue_fused.update", "full_body.update"),
                                         ("prologue_fused.gn", "full_body_gn.update")])
def test_prologue_fused_reads_the_share_the_kernel_took(metric, cell, monkeypatch):
    read = harness.reader(metric)
    assert read({}) is None
    profiling.count_on_device(pro.UPDATES, torch.tensor([4]))
    assert read({}) is None                 # the op-by-op prologue: no fused counter
    profiling.count_on_device(pro.FUSED, torch.tensor([3]))
    assert read({}) == 75.0
    monkeypatch.delattr(profiling, "counters")
    assert read({}) is None
    (entry,) = [m for m in harness.load_benchmark()["per_layer"] if m["name"] == metric]
    assert entry == {"name": metric, "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "control step",
                     "moves": "propagations_per_s", "workloads": [cell]}
