"""Ahead-of-time export of the control step (port of ``runtime/export.py``).

``torch.export`` captures the eager control step as a graph and serializes
it, so a serving process can load and run it without the solver's Python:
the counterpart of the JAX package's ``jax.export`` of StableHLO. The
artifact pins the static structure (model, K, T, the path's capacity) and
the eager path: the fused kernel is a ctypes launch, which ``torch.export``
cannot trace, as the JAX export pins the non-kernel path. The numeric
parameters (SolverParams, CostParams, the model's physical parameters), the
warm start, the state, the path and dt stay inputs, so weights can be
retuned through the artifact.

The exported step draws its own noise: the kernel's Philox normals
(``core/random.py philox_normals``, the plain torch version, which
``torch.export`` traces) keyed by the cycle's seed and step, which enter as
0-d int64 tensors. It therefore samples the stream of the kernel's RNG mode
and of the eager ``mppi_step`` (whose draw on the card is the CUDA kernel of
the same normals): on the card its update can be held against either at
the same seed and step.
"""

from __future__ import annotations

import dataclasses
import io
import json

import torch

from ccv_mppi_path_tracker_tpu_torch.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu_torch.core.device import resolve_device
from ccv_mppi_path_tracker_tpu_torch.core.random import philox_normals
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, RefWindow, StepResult
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model
from ccv_mppi_path_tracker_tpu_torch.paths.resample import PathBuffer
from ccv_mppi_path_tracker_tpu_torch.solver.mppi import mppi_step

_CONFIG_FILE = "ccv_mppi_config.json"


def _fields(obj):
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


class _ControlStep(torch.nn.Module):
    """mppi_step on flat tensor inputs: (u_prev, seed, step, state, path xy,
    path num_valid, path resolution, dt, *SolverParams, *CostParams,
    *model params) -> (u_opt, ref xy, ref yaw, opt_states, min_cost,
    mean_cost, ess)."""

    def __init__(self, cfg: SolverConfig, mp_type):
        super().__init__()
        self.cfg = cfg
        self.mp_type = mp_type

    def forward(self, u_prev, seed, step, state, path_xy, num_valid, resolution, dt,
                *params):
        n_sp, n_cp = len(dataclasses.fields(SolverParams)), len(dataclasses.fields(CostParams))
        sp = SolverParams(*params[:n_sp])
        cp = CostParams(*params[n_sp:n_sp + n_cp])
        mp = self.mp_type(*params[n_sp + n_cp:]) if self.mp_type is not None else None
        noise = philox_normals(seed, step, self.cfg.num_samples, self.cfg.horizon - 1,
                               u_prev.shape[1], device=u_prev.device, dtype=u_prev.dtype)
        _, res = mppi_step(self.cfg, ControllerState(u_prev=u_prev, seed=0, step=0), state,
                           PathBuffer(xy=path_xy, num_valid=num_valid, resolution=resolution),
                           dt, sp, cp, model_params=mp, noise=noise)
        s = res.stats
        return (res.u_opt, res.ref.xy, res.ref.yaw, res.opt_states, s["min_cost"],
                s["mean_cost"], s["ess"])


def _flat_inputs(ctrl, state, path, dt, sp, cp, model_params):
    """The exported program's inputs, on the device and dtype of ``state``."""
    dev, dtype = state.device, state.dtype

    def scalar(v, dt_):
        return torch.as_tensor(v, dtype=dt_, device=dev).reshape(())

    return (ctrl.u_prev, scalar(ctrl.seed, torch.int64), scalar(ctrl.step, torch.int64),
            state, path.xy, scalar(path.num_valid, torch.int64),
            scalar(path.resolution, dtype), scalar(dt, dtype),
            *_fields(sp), *_fields(cp), *(_fields(model_params) if model_params else []))


def export_control_step(cfg: SolverConfig, path_capacity: int, sp: SolverParams,
                        cp: CostParams, model_params=None, dtype=torch.float32,
                        device=None) -> bytes:
    """Serialize the control step of this config (the eager path, noise
    drawn in the program from the cycle's seed and step).

    Returns the artifact as bytes (``torch.export.save``); persist them with
    ``open(f, "wb").write(blob)``. ``sp``, ``cp`` and ``model_params`` (None:
    the model's defaults, where it has parameters) are example inputs of the
    right shapes: the export pins shapes, dtypes and the device (None: the
    card), not values.
    """
    device = resolve_device(device)
    model = get_model(cfg.model)
    if model_params is None and model.default_params is not None:
        model_params = model.default_params(device=device, dtype=dtype)
    ctrl = ControllerState.initial(0, cfg.horizon, model.num_controls, dtype=dtype,
                                   device=device)
    state = torch.zeros(model.num_states, dtype=dtype, device=device)
    path = PathBuffer(xy=torch.zeros((path_capacity, 2), dtype=dtype, device=device),
                      num_valid=path_capacity,
                      resolution=torch.full((), 0.1, dtype=dtype, device=device))
    args = _flat_inputs(ctrl, state, path, 0.1, sp, cp, model_params)
    module = _ControlStep(cfg, type(model_params) if model_params is not None else None)
    program = torch.export.export(module, args)
    meta = {"model": cfg.model, "num_samples": cfg.num_samples, "horizon": cfg.horizon,
            "steer_off": cfg.steer_off, "path_capacity": path_capacity}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_CONFIG_FILE: json.dumps(meta)})
    return buf.getvalue()


def load_control_step(blob: bytes):
    """Deserialize an exported control step. Returns a callable
    ``(ctrl, state, path, dt, sp, cp, model_params=None) -> (next
    ControllerState, StepResult)``, as ``mppi_step`` returns them;
    ``model_params`` None: the model's defaults. The callable's ``cfg``
    attribute is the exported SolverConfig."""
    extra = {_CONFIG_FILE: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    meta = json.loads(extra[_CONFIG_FILE])
    cfg = SolverConfig(model=meta["model"], num_samples=meta["num_samples"],
                       horizon=meta["horizon"], steer_off=meta["steer_off"])
    model = get_model(cfg.model)
    fn = program.module()

    def call(ctrl, state, path, dt, sp, cp, model_params=None):
        if model_params is None and model.default_params is not None:
            model_params = model.default_params(device=state.device, dtype=state.dtype)
        u_opt, ref_xy, ref_yaw, opt_states, min_cost, mean_cost, ess = fn(
            *_flat_inputs(ctrl, state, path, dt, sp, cp, model_params))
        stats = {"min_cost": min_cost, "mean_cost": mean_cost, "ess": ess}
        return (ctrl.advanced(u_opt),
                StepResult(u_opt=u_opt, u0=u_opt[0], ref=RefWindow(xy=ref_xy, yaw=ref_yaw),
                           opt_states=opt_states, stats=stats))

    call.cfg = cfg
    return call
