"""utils/cuda_graph.py and the refine stage's dispatch to it.

The capture and replay need a CUDA device; chip_smoke.py phase 22 holds the
replayed refine stage against the eager one on the card (float64 rtol
1e-8). Here, on the CPU: the argument split and rebuild that the replay's
input buffers rest on, the cache key, the refusals, and that CPU tensors
take the eager stage, which equals the JAX refinement (float64 rtol 1e-9
for the gradient, 1e-7 for Gauss-Newton, as tests/test_torch_diff.py).
"""

import jax
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu import diff as jdiff
from ccv_mppi_path_tracker_tpu_torch.core.config import make_solver_params
from ccv_mppi_path_tracker_tpu_torch.core.types import RefWindow
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import REFINE_GRAPHS, _refine, refine_stage
from ccv_mppi_path_tracker_tpu_torch.utils import cuda_graph
from test_torch_diff import F64, GN, MODELS, Problem, close


def _args(n=4, dt=0.1, dtype=torch.float64, mp=None):
    rng = np.random.RandomState(0)
    u = torch.as_tensor(rng.randn(n, 2), dtype=dtype)
    ref = RefWindow(xy=torch.as_tensor(rng.randn(n + 1, 2), dtype=dtype),
                    yaw=torch.as_tensor(rng.randn(n + 1), dtype=dtype))
    sp = make_solver_params(0.5, 1.0, [-1.0, -2.0], [1.0, 2.0], dtype=dtype, device="cpu")
    return (u, ref, dt, sp, mp)


def test_split_and_fill_round_trip():
    args = _args()
    leaves = []
    template, key = cuda_graph.split_tensors(args, leaves)
    hash(key)
    # u, ref.xy, ref.yaw and the five SolverParams fields, in order
    assert len(leaves) == 8 and leaves[0] is args[0] and leaves[1] is args[1].xy
    copies = [t.clone() for t in leaves]
    rebuilt = cuda_graph.fill_tensors(template, copies)
    assert type(rebuilt) is tuple and isinstance(rebuilt[1], RefWindow)
    assert rebuilt[2] == 0.1 and rebuilt[4] is None
    assert rebuilt[1].yaw is copies[2] and rebuilt[3].noise_beta is copies[7]
    new_leaves = []
    assert cuda_graph.split_tensors(rebuilt, new_leaves)[1] == key
    assert all(a is b for a, b in zip(new_leaves, copies))


@pytest.mark.parametrize("change,same", [
    (dict(), True),              # other values, same structure: one graph
    (dict(n=5), False),          # shape
    (dict(dtype=torch.float32), False),
    (dict(dt=0.05), False),      # a constant is fixed at capture
    (dict(mp=torch.zeros(3, dtype=torch.float64)), False),
])
def test_cache_key(change, same):
    base = cuda_graph.split_tensors(_args(), [])[1]
    other = _args(**change)
    if not change:
        other[0].add_(1.0)
    assert (cuda_graph.split_tensors(other, [])[1] == base) is same


def test_capturable_refuses_cpu_grad_and_no_tensor():
    args = _args()
    assert not cuda_graph.capturable(args)
    assert not cuda_graph.capturable((0.1, None))
    args[0].requires_grad_(True)
    assert not cuda_graph.capturable(args)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_graph.Graphed(lambda *a: a[0])(*_args())


@pytest.mark.parametrize("method", ["gradient", "gauss_newton"])
@pytest.mark.parametrize("model", list(MODELS))
def test_refine_on_cpu_is_the_eager_stage(model, method):
    """_refine on CPU tensors runs refine_stage itself (bit-equal), captures
    nothing, and matches the JAX refinement."""
    captured = REFINE_GRAPHS.captures
    p = Problem(model, seed=2)
    u, state, ref, dt, cp, mp = p.port_args()
    got = _refine(p.cfg, u, state, ref, dt, p.sp, cp, mp, 3, 0.02, method)
    eager = refine_stage(p.cfg, u, state, ref, dt, p.sp, cp, mp, 3, 0.02, method)
    assert torch.equal(got, eager) and REFINE_GRAPHS.captures == captured
    jargs = p.jax_args()
    if method == "gradient":
        ref_u = jax.jit(lambda u: jdiff.gradient_refine(
            p.jcfg, u, *jargs[1:4], p.jsp, p.jcp, p.jmp, step_size=0.02, num_steps=3))(jargs[0])
    else:
        ref_u = jax.jit(lambda u: jdiff.gauss_newton_refine(
            p.jcfg, u, *jargs[1:4], p.jsp, p.jcp, p.jmp, num_steps=3))(jargs[0])
    close(got, ref_u, F64 if method == "gradient" else GN)


def test_refine_stage_rejects_an_unknown_method():
    p = Problem("unicycle")
    u, state, ref, dt, cp, mp = p.port_args()
    with pytest.raises(ValueError, match="refine_method"):
        _refine(p.cfg, u, state, ref, dt, p.sp, cp, mp, 1, 0.02, "newton")


def test_frozen_config_is_a_constant_of_the_key():
    from ccv_mppi_path_tracker_tpu_torch.core import SolverConfig

    def key(cfg):
        return cuda_graph.split_tensors((cfg, torch.zeros(2)), [])[1]

    assert key(SolverConfig(horizon=5)) == key(SolverConfig(horizon=5))
    assert key(SolverConfig(horizon=5)) != key(SolverConfig(horizon=6))
