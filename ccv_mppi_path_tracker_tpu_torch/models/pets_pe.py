"""PETS's probabilistic ensemble: five 6-200-200-200-200-8 swish networks
with Gaussian heads, propagated by trajectory sampling (Chua, Calandra,
McAllister and Levine, "Deep Reinforcement Learning in a Handful of Trials
using Probabilistic Dynamics Models", NeurIPS 2018; the code's
``dmbrl/modeling/models/BNN.py`` and ``dmbrl/controllers/MPC.py``).

State and controls are models/autorally_nn.py's: (x, y, yaw, roll, v_x, v_y,
yaw_mder) under (steering, throttle). The ensemble's E = 5 members predict
the change of the four dynamic states (roll, v_x, v_y, yaw_mder) over one
step; the pose follows AutoRally's kinematics. One step of member e:

    z       = ([roll, v_x, v_y, yaw_mder, steering, throttle] - mu_in) / sigma_in
    h_1     = swish(W_1 z + b_1),  h_{i+1} = swish(W_{i+1} h_i + b_{i+1}), i = 1 ... 3
    [m, l]  = W_5 h_4 + b_5                      (m and l each of 4)
    l      <- l_max - softplus(l_max - l);  l <- l_min + softplus(l - l_min)

with swish(x) = x sigmoid(x), widths 6 -> 200 -> 200 -> 200 -> 200 -> 8, and
the log-variance bounded as BNN.py bounds it (l_max 0.5, l_min -10, its
initial values). The input standardiser (mu_in, sigma_in) is applied even
where it is (0, 1).

Sampled propagation (:func:`rollout_cost`, the eager update's): each of the
K sequences is rolled out by P = 20 particles; particle p follows member
e(p) = p mod E at every step (TS-infinity), and

    dyn_{t+1}  = dyn_t + m + exp(l / 2) * eps_{k,p,t},  eps ~ N(0, I_4)
    pose_{t+1} = pose_t + dt * (v_x cos yaw - v_y sin yaw,
                                v_x sin yaw + v_y cos yaw, -yaw_mder),

summed left to right. A particle's cost is autorally_nn's ``states_cost``; a
cost that is not finite counts as 1e6 (MPC.py replaces a NaN; an overflowing
state here gives inf as well), and a sequence's cost is the mean over its P
particles. The normals eps are the second stream of the step's Philox key
(core/random.py): particle p of sequence k draws at particle index
(first_sample + k) P + p, counter (that index, t, pair, 2^31 + robot), where
no exploration normal (robot < 2^31) nor plant normal (pair word 2^31) lies.

Inside a call the K·P particles are laid out member by member, (E, K·P/E):
row e, column k·(P/E) + j holds particle p = j·E + e of sequence k, so that
each layer is one product batched over the members (``torch.baddbmm``), in
float32 as the caller leaves TF32 (the benchmark's configuration: off).
Where the call is float32 on the card with the shapes of :data:`LAYERS`,
:data:`MEMBERS` and :data:`PARTICLES`, no grad and no ``torch.func``
transform (:func:`_fused_operands`), the particles' rollouts and costs are
one launch of kernels/pets_rollout.py, which keeps every activation on chip
and rounds each operation as this op-by-op version does.

Paths that get no key (:func:`rollout` and :func:`step`: the planned path,
``delay``'s prediction, the refinement, a plant) propagate the ensemble's
mean: the members' mean of m, with eps = 0.

PETS's trained weights are not in this repository, so :func:`default_params`
draws seeded ones (:data:`WEIGHTS`): for each member in turn, each layer's
(out, in) matrix then its bias, uniform in +-1/sqrt(fan_in) (PyTorch
``Linear``'s init) drawn in float32 on the CPU by one ``torch.Generator``,
the four hidden matrices' bound times ``hidden_gain`` = sqrt(6) (He's
uniform init: under Linear's a 4-deep swish network all but ignores its
inputs, a control moving the final state by ~1e-4); the head's mean rows and
bias times ``output_scale``, its log-variance bias plus ``logvar_offset``.
Under this draw an ensemble-mean rollout from rest under zero controls keeps
|roll|, |v_x|, |v_y| and |yaw_mder| under 0.15 over T=30 steps, and each
dynamic state's per-step sigma exp(l/2) along it lies in 0.029-0.033
(tests/test_torch_pets_pe.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.core.random import PROPAGATION_ROBOT
from ccv_mppi_path_tracker_tpu_torch.kernels import pets_rollout
from ccv_mppi_path_tracker_tpu_torch.models.autorally_nn import cost, kinematics, states_cost
from ccv_mppi_path_tracker_tpu_torch.models.base import Model
from ccv_mppi_path_tracker_tpu_torch.models.registry import register_model
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals
from ccv_mppi_path_tracker_tpu_torch.utils import profiling

MEMBERS = 5
PARTICLES = 20
# (in, out) of each member's five layers
LAYERS = ((6, 200), (200, 200), (200, 200), (200, 200), (200, 8))
OUT = 4                            # the dynamic states a member predicts
LOGVAR_BOUNDS = (0.5, -10.0)       # BNN.py's max_logvar and min_logvar
# How default_params draws the weights; benchmark/configs/pets_pe-*.json
# states the same numbers.
WEIGHTS = {"seed": 20181203, "hidden_gain": 6 ** 0.5, "output_scale": 0.2,
           "logvar_offset": -7.0}
# The cost that stands for a particle's non-finite one (MPC.py's)
NONFINITE_COST = 1e6
# Device counters (utils/profiling.py): member evaluations, one a particle
# and step (a mean step evaluates every member), and the particle costs
# replaced by NONFINITE_COST; kernels/pets_rollout.py adds to the first too,
# and to its own FUSED
EVALS = pets_rollout.COUNTERS
NONFINITE = ("model.pe_nonfinite",)


@dataclasses.dataclass
class PEParams:
    """The ensemble: ``w`` each layer's (E, out, in) matrices and ``b`` its
    (E, out) biases; the input standardiser's ``mu_in`` and ``sigma_in``
    (6,); the log-variance bounds ``max_logvar`` and ``min_logvar`` (4,)."""

    w: tuple
    b: tuple
    mu_in: torch.Tensor
    sigma_in: torch.Tensor
    max_logvar: torch.Tensor
    min_logvar: torch.Tensor


def draw_weights() -> PEParams:
    """The seeded ensemble of :data:`WEIGHTS`, float32 on the CPU."""
    g = torch.Generator().manual_seed(WEIGHTS["seed"])
    f32 = dict(dtype=torch.float32)
    w = [[] for _ in LAYERS]
    b = [[] for _ in LAYERS]
    for _ in range(MEMBERS):
        for n, (fan_in, fan_out) in enumerate(LAYERS):
            bound = 1.0 / fan_in ** 0.5
            gain = WEIGHTS["hidden_gain"] if n < len(LAYERS) - 1 else 1.0
            wn = (torch.rand((fan_out, fan_in), generator=g, **f32) * 2.0 - 1.0) * (bound * gain)
            bn = (torch.rand((fan_out,), generator=g, **f32) * 2.0 - 1.0) * bound
            if n == len(LAYERS) - 1:
                wn[:OUT] = wn[:OUT] * WEIGHTS["output_scale"]
                bn[:OUT] = bn[:OUT] * WEIGHTS["output_scale"]
                bn[OUT:] = bn[OUT:] + WEIGHTS["logvar_offset"]
            w[n].append(wn)
            b[n].append(bn)
    return PEParams(tuple(torch.stack(x) for x in w), tuple(torch.stack(x) for x in b),
                    torch.zeros(6, **f32), torch.ones(6, **f32),
                    torch.full((OUT,), LOGVAR_BOUNDS[0], **f32),
                    torch.full((OUT,), LOGVAR_BOUNDS[1], **f32))


# (device, dtype) -> PEParams, made once, so that a CUDA graph captured
# around the ensemble reads the same tensors at every replay
_CACHE: dict = {}


def default_params(device=None, dtype=torch.float32) -> PEParams:
    """The seeded ensemble on ``device`` (None: the card) in ``dtype``, made
    once a device and dtype; on the card sent up through pinned memory
    without a wait, as models/autorally_nn.py sends its weights."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    params = _CACHE.get((device, dtype))
    if params is None:
        def up(t):
            t = t.to(dtype)
            return (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                    else t.to(device))

        # drawn outside any transform: a first call may come under vmap,
        # which refuses a random operation
        with torch._C._DisableFuncTorch():
            host = draw_weights()
        params = _CACHE[(device, dtype)] = PEParams(
            tuple(up(t) for t in host.w), tuple(up(t) for t in host.b),
            *(up(getattr(host, n)) for n in ("mu_in", "sigma_in", "max_logvar",
                                             "min_logvar")))
    return params


def heads(dyn, u, params: PEParams):
    """Each member's mean m and bounded log-variance l, (E, M, 4) each, of
    the dynamic states dyn (E, M, 4) under controls u (E, M, 2): row e
    through member e's network."""
    h = (torch.cat([dyn, u], dim=-1) - params.mu_in) / params.sigma_in
    last = len(params.w) - 1
    for n, (w, b) in enumerate(zip(params.w, params.b)):
        h = torch.baddbmm(b.unsqueeze(1), h, w.transpose(1, 2))
        if n < last:
            h = F.silu(h)
    mean, logvar = h[..., :OUT], h[..., OUT:]
    logvar = params.max_logvar - F.softplus(params.max_logvar - logvar)
    return mean, params.min_logvar + F.softplus(logvar - params.min_logvar)


def _count(names, value, like):
    """Add ``value`` (an int, or a 0-d int64 tensor on the device of
    ``like``) to the device counters ``names``, where they may be added to."""
    if not profiling.device_counting(like):
        return
    if isinstance(value, int):
        value = profiling.device_constant(value, torch.int64, like.device)
    if value is not None:
        profiling.count_on_device(names, value)


def step(state, u, dt, params: PEParams = None):
    """One step of the ensemble's mean, states (..., 7) under controls (...,
    2), batched by broadcasting; ``params`` None: :func:`default_params`."""
    if params is None:
        params = default_params(state.device, state.dtype)
    lead = torch.broadcast_shapes(state.shape[:-1], u.shape[:-1])
    state, u = state.expand(lead + (7,)), u.expand(lead + (2,))
    members = len(params.w[0])
    dyn = state[..., 3:].reshape(1, -1, OUT)
    mean, _ = heads(dyn.expand(members, -1, -1),
                    u.reshape(1, -1, 2).expand(members, -1, -1), params)
    change = torch.mean(mean, dim=0).reshape(lead + (OUT,))
    return torch.cat([state[..., :3] + kinematics(state) * dt, state[..., 3:] + change], dim=-1)


def rollout(state0, controls, dt, params: PEParams = None):
    """The ensemble-mean rollout of controls (T-1, ..., 2) from state0 (...,
    7): states (T, ..., 7). Span ``model.pe_rollout``; adds its member
    evaluations, E a state and step, to ``model.pe_evals``."""
    with profiling.span("model.pe_rollout"):
        if params is None:
            params = default_params(state0.device, state0.dtype)
        states = [state0]
        for u in controls:
            states.append(step(states[-1], u, dt, params))
        states = torch.stack(states)
        _count(EVALS, len(params.w[0]) * states[1:, ..., 0].numel(), states)
        return states


def particle_states(state0, controls, dt, params: PEParams, normals):
    """States (T, E, K·P/E, 7) of the K·P particles (the module docstring's
    layout) of controls (T-1, K, 2) from state0 (K, 7) under ``normals``
    (T-1, K·P, 4), particle index k·P + p."""
    tm1, k, _ = controls.shape
    members = len(params.w[0])
    per = PARTICLES // members
    s = state0.reshape(1, k, 1, 7).expand(members, k, per, 7).reshape(members, k * per, 7)
    states = [s]
    for t in range(tm1):
        u = controls[t].reshape(1, k, 1, 2).expand(members, k, per, 2).reshape(
            members, k * per, 2)
        eps = normals[t].reshape(k, per, members, OUT).permute(2, 0, 1, 3).reshape(
            members, k * per, OUT)
        mean, logvar = heads(s[..., 3:], u, params)
        dyn = s[..., 3:] + mean + torch.exp(0.5 * logvar) * eps
        s = torch.cat([s[..., :3] + kinematics(s) * dt, dyn], dim=-1)
        states.append(s)
    return torch.stack(states)


def _on_card(t) -> bool:
    return t.is_cuda


def _fused_operands(state0, controls, normals, dt, params, ref, cp):
    """The operands of kernels/pets_rollout.py pets_rollout_cost for this
    call, each contiguous (the start state as the one state state0 expands,
    a number dt made a tensor), or None where the particles run op by op: off
    the card, a start state that is not one state expanded over the
    sequences, another dtype or shape, an input that requires grad, or a
    ``torch.func`` transform."""
    if not (_on_card(controls) and profiling.device_counting(state0, controls, normals)
            and state0.dim() == 2 and controls.dim() == 3
            and state0.shape[0] == controls.shape[1]
            and (state0.stride(0) == 0 or state0.shape[0] == 1)):
        return None
    state = state0[0]
    if not isinstance(dt, torch.Tensor):
        dt = torch.full((), dt, dtype=controls.dtype, device=controls.device)
    args = (state, controls, normals, dt, params, ref.xy, cp)
    if not pets_rollout.takes(*args):
        return None
    rest = [getattr(params, n) for n in pets_rollout.PARAM_NAMES]
    if not profiling.device_counting(dt, ref.xy, *params.w, *params.b, *rest,
                                     *(getattr(cp, n) for n in pets_rollout.COST_NAMES)):
        return None
    params = PEParams(tuple(w.contiguous() for w in params.w),
                      tuple(b.contiguous() for b in params.b), *[t.contiguous() for t in rest])
    return (*[t.contiguous() for t in args[:4]], params, ref.xy.contiguous(),
            dataclasses.replace(cp, **{n: getattr(cp, n).contiguous()
                                       for n in pets_rollout.COST_NAMES}))


def rollout_cost(state0, controls, dt, params, ref, cp, key=None, seed=None, step=None,
                 first_sample=0):
    """The model's ``rollout_cost`` hook (``Model.stochastic``): the (K,)
    costs of sequences controls (T-1, K, 2) from state0 (K, 7), each the mean
    over its P particles' costs, a non-finite one counted as 1e6. The
    propagation normals come from the step's key (``key`` on its device, or
    ``seed`` and ``step``) at the sequences' ``first_sample``. Where the
    kernel takes the call (:func:`_fused_operands`: float32 CUDA tensors,
    the start state one state expanded over the K sequences, controls (T-1,
    K, 2), the ensemble of :data:`LAYERS`' shapes, a window of at most
    kernels/pets_rollout.py MAX_REF points, nothing that requires grad, no
    transform) the particles' costs are one launch of
    kernels/pets_rollout.py; elsewhere, the CPU, float64, grad, vmap and
    other shapes, ``states_cost(particle_states(...))`` op by op. Span
    ``model.pe_rollout``; adds K·P·(T-1) to the device counter
    ``model.pe_evals`` (the kernel also to ``model.pe_fused``) and the
    replaced costs to ``model.pe_nonfinite``."""
    with profiling.span("model.pe_rollout"):
        if params is None:
            params = default_params(state0.device, state0.dtype)
        tm1, k, _ = controls.shape
        normals = draw_standard_normals(key, seed, step, shape=(tm1, k * PARTICLES, OUT),
                                        robot=PROPAGATION_ROBOT,
                                        first_sample=first_sample * PARTICLES,
                                        dtype=controls.dtype, device=controls.device)
        operands = _fused_operands(state0, controls, normals, dt, params, ref, cp)
        if operands is None:
            costs = states_cost(particle_states(state0, controls, dt, params, normals),
                                ref.xy, cp)
        else:
            device = controls.device
            costs = pets_rollout.pets_rollout_cost(
                *operands, evals=profiling.device_group(EVALS, device),
                fused=profiling.device_group(pets_rollout.FUSED, device))
        finite = torch.isfinite(costs)
        costs = torch.where(finite, costs, NONFINITE_COST)
        members = costs.shape[0]
        per_sequence = costs.reshape(members, k, PARTICLES // members).permute(1, 2, 0)
        if operands is None:
            _count(EVALS, PARTICLES * controls[..., 0].numel(), costs)
        _count(NONFINITE, (~finite).sum(), costs)
        return torch.mean(per_sequence.reshape(k, PARTICLES), dim=1)


MODEL = register_model(
    Model(
        name="pets_pe",
        state_names=("x", "y", "yaw", "roll", "v_x", "v_y", "yaw_mder"),
        control_names=("steering", "throttle"),
        step=step,
        default_params=default_params,
        cost_fn=cost,
        rollout=rollout,
        rollout_cost=rollout_cost,
        stochastic=True,
    )
)
