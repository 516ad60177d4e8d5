"""A fleet of more than 65535 robots: the kernel arm splits it into launches
of at most 65535 robots (gridDim.y of one launch), each at its robot offset,
where the JAX package's batched kernel runs a (B, grid_k) grid of any B.

- ``fleet_chunks``: the split's plan, every robot once, in order;
- ``KernelLaunch`` with a stand-in for the CUDA library: one C call a chunk,
  each on its robots' rows of the operands, outputs and tickets, the first
  robot ``robot + start``, and a launch error raised;
- the fleet step at B = 65536 (diff_drive, K=4, T=3): the kernel arm (its
  plain version on the CPU) against the eager arm at float32 within the
  kernel gate, the eager arm against the JAX package's vmapped mppi_step at
  float64 on the same noise;
- RNG mode at B = 65536: robot 65535 of the fleet's draw and of the
  kernel's plain version is bit-equal to a one-robot call at robot=65535.
"""

import contextlib

import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
from ccv_mppi_path_tracker_tpu_torch.kernels import build
from ccv_mppi_path_tracker_tpu_torch.kernels import rollout_cost as kernel_mod
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    MAX_ROBOTS,
    KernelLaunch,
    finish_groups,
    fleet_chunks,
    fused_sample_rollout_cost,
    launch_shape,
)
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals
from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step
from test_torch_fleet import _fleet_inputs, _jax_fleet_eager, _port, _robots
from test_torch_solver import Case

BIG = MAX_ROBOTS + 1
F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-6)
DT = 0.1


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


@pytest.mark.parametrize("num_robots", [1, 65535, 65536, 131070, 131071, 200000])
def test_fleet_chunks_cover_every_robot_once_in_launches_of_at_most_65535(num_robots):
    chunks = fleet_chunks(num_robots)
    assert len(chunks) == -(-num_robots // 65535)
    assert all(1 <= count <= 65535 for _, count in chunks)
    assert [start for start, _ in chunks] == list(range(0, num_robots, 65535))
    covered = np.concatenate([np.arange(s, s + n) for s, n in chunks])
    assert np.array_equal(covered, np.arange(num_robots))


def test_fleet_chunks_refuse_an_empty_fleet():
    with pytest.raises(ValueError):
        fleet_chunks(0)


class FakeLibrary:
    """Stands in for the bound CUDA library: records each rollout_cost call's
    arguments and returns the error code ``fail_at`` gives that call."""

    _rollout_cost_bound = True

    def __init__(self, fail_at=None):
        self.calls = []
        self.fail_at = fail_at

    def rollout_cost(self, *args):
        self.calls.append(args)
        return 700 if len(self.calls) == self.fail_at else 0

    def rollout_cost_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake_card(monkeypatch):
    """KernelLaunch on CPU tensors, the library and the CUDA stream faked."""
    lib = FakeLibrary()
    monkeypatch.setattr(build, "load_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(kernel_mod, "_COUNTERS", {})
    return lib


def _big_inputs(num_robots, k=3, t=3):
    """Tiny unicycle operands of a fleet, float32 on the CPU."""
    rng = np.random.RandomState(0)
    f = dict(dtype=torch.float32)
    return (torch.tensor(rng.randn(num_robots, t - 1, 2) * 0.1, **f),
            torch.tensor([0.5, 0.5], **f), torch.tensor([-1.0, -1.0], **f),
            torch.tensor([1.0, 1.0], **f),
            torch.tensor(rng.randn(num_robots, t, 2), **f),
            torch.tensor(rng.randn(num_robots, 3), **f),
            torch.ones((num_robots, kernel_mod.NSCAL), **f))


# positions of the C entry's arguments (csrc/rollout_cost.cu rollout_cost;
# SIGNATURE): the head's thirteen, counters, key, then the tail
U_PREV, REFC, STATE0, SCAL, NOISE, COSTS_IN, COSTS, ROWS = 2, 6, 7, 8, 9, 10, 11, 12
COUNTERS, U_NUM, NORM, ROBOT, NUM_ROBOTS = 13, 15, 16, 23, 29


@pytest.mark.parametrize("num_robots,launches", [(65535, 1), (65536, 2), (131071, 3)])
def test_a_fleet_launches_one_chunk_at_a_time_at_its_robot_offset(fake_card, num_robots,
                                                                  launches):
    k = 3
    args = _big_inputs(num_robots, k)
    noise = torch.zeros((num_robots, 2, k, 2))
    launch = KernelLaunch(*args, None, None, k, "unicycle", noise=noise, robot=7)
    assert launch.calls == launches
    launch.run()
    calls = fake_card.calls
    assert len(calls) == launches
    tickets = next(iter(kernel_mod._COUNTERS.values()))
    per_robot = finish_groups(launch_shape("unicycle", k, 3, 3).blocks) + 1
    assert tickets.numel() == num_robots * per_robot
    for (start, count), call in zip(fleet_chunks(num_robots), calls):
        assert call[ROBOT] == 7 + start and call[NUM_ROBOTS] == count
        assert call[U_PREV] == args[0][start].data_ptr()
        assert call[STATE0] == launch._keep[5][start].data_ptr()
        assert call[SCAL] == args[6][start].data_ptr()
        assert call[REFC] == launch._keep[4][start].data_ptr()
        assert call[NOISE] == launch._keep[7][start].data_ptr()
        assert call[COSTS] == launch.costs[start].data_ptr() and call[COSTS_IN] is None
        assert call[ROWS] == launch._keep[8][start].data_ptr()
        assert call[U_NUM] == launch.u_num[start].data_ptr()
        assert call[NORM] == launch.norm[start].data_ptr()
        # each chunk its own robots' tickets of the one buffer
        assert call[COUNTERS] == tickets[start * per_robot].data_ptr()
    # the outputs are one allocation each: no concatenation after the launches
    assert launch.costs.shape == (num_robots, k)


def test_the_costs_only_pass_of_a_big_fleet_takes_no_tickets(fake_card):
    k = 3
    args = _big_inputs(BIG, k)
    launch = KernelLaunch(*args, 1, 2, k, "unicycle", accumulate=False)
    launch.run()
    assert launch.calls == 2 and [c[COUNTERS] for c in fake_card.calls] == [None, None]
    assert [c[ROBOT] for c in fake_card.calls] == [0, MAX_ROBOTS]


def test_a_chunk_that_fails_raises_and_launches_no_further_chunk(fake_card):
    fake_card.fail_at = 2
    args = _big_inputs(2 * MAX_ROBOTS + 1)
    launch = KernelLaunch(*args, 1, 2, 3, "unicycle")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        launch.run()
    assert len(fake_card.calls) == 2


def test_the_fleet_step_at_65536_robots_runs_both_arms_and_matches_jax():
    num_robots = BIG
    case64 = Case(4, horizon=3, model="unicycle")
    noise, u_prev, states = _robots(case64, num_robots, seed=3)
    # the eager arm at float64 against the JAX package's vmapped step
    _, jres = _jax_fleet_eager(case64, noise, u_prev, states, case64.jpath)
    _, eag64 = build_fleet_step(case64.cfg)(
        ControllerState(torch.as_tensor(u_prev), 0, 0), torch.as_tensor(states),
        case64.path, DT, case64.sp, case64.cp, noise=torch.as_tensor(noise))
    assert eag64.u_opt.shape == (num_robots, 2, 2)
    close(eag64.u_opt, jres.u_opt, F64)
    close(eag64.ref.xy, jres.ref.xy, F64)
    close(eag64.stats["min_cost"], jres.stats["min_cost"], F64)
    # the kernel arm (its plain version here) against the eager arm at float32
    case32 = Case(4, horizon=3, model="unicycle", f64=False)
    f32 = dict(dtype=torch.float32)
    args = (ControllerState(torch.tensor(u_prev, **f32), 0, 0),
            torch.tensor(states, **f32), case32.path, torch.tensor(DT), case32.sp,
            case32.cp)
    noise32 = torch.tensor(noise, **f32)
    before = fused_sample_rollout_cost.launches
    ctrls, krn = build_fleet_step(case32.cfg, use_kernel=True)(*args, noise=noise32)
    _, eag = build_fleet_step(case32.cfg)(*args, noise=noise32)
    assert fused_sample_rollout_cost.launches == before  # CPU: plain version
    assert ctrls.u_prev.shape == (num_robots, 2, 2) and ctrls.step == 1
    close(krn.u_opt, eag.u_opt, F32)
    close(krn.stats["min_cost"], eag.stats["min_cost"], dict(rtol=2e-5))
    close(krn.u_opt, jres.u_opt, dict(rtol=2e-5, atol=2e-5))


def test_robot_65535_draws_the_stream_of_robot_65535_alone():
    num_robots, k, t = BIG, 4, 3
    fleet = draw_standard_normals(None, 5, 3, (num_robots, t - 1, k, 2), device="cpu")
    for b in (0, MAX_ROBOTS - 1, MAX_ROBOTS):
        one = draw_standard_normals(None, 5, 3, (t - 1, k, 2), robot=b, device="cpu")
        assert torch.equal(fleet[b], one)
    # the kernel's plain version in RNG mode: the fleet's robot 65535 is the
    # one-robot call at robot=65535
    inp = _fleet_inputs("unicycle", k, t, num_robots=2, seed=4)
    big = {n: np.repeat(v[:1], num_robots, axis=0) if n in ("u_prev", "ref_xy", "state0",
                                                          "scal") else v
           for n, v in inp.items()}
    big["u_prev"][MAX_ROBOTS] = inp["u_prev"][1]
    big["state0"][MAX_ROBOTS] = inp["state0"][1]
    del big["noise"]
    batched = _port(big, k, "unicycle", noise=False, seed=9, step=2)
    one = {n: v[MAX_ROBOTS] if n in ("u_prev", "ref_xy", "state0", "scal") else v
           for n, v in big.items()}
    single = _port(one, k, "unicycle", noise=False, seed=9, step=2, robot=MAX_ROBOTS)
    for x, y in zip(batched, single):
        assert torch.equal(x[MAX_ROBOTS], y)
    assert not torch.equal(batched[0][0], batched[0][MAX_ROBOTS])
