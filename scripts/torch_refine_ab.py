#!/usr/bin/env python3
"""The PyTorch port's refine stage (``mppi_step(refine_steps=3)``,
diff/gradients.py) against the JAX package's formulation of it carried over
literally: ``torch.func.grad`` and ``torch.func.jacfwd`` through the
sequential Euler rollout. Both compute the same function (the closed-form and
sequential rollouts agree to round-off; forward mode over a batch of basis
directions is jacfwd's computation), so the difference is host work.

    python3 scripts/torch_refine_ab.py count
        on the CPU: aten calls per refined update (torch.profiler, every
        level), full_body and unicycle at K=256 T=30, each arm and method
    python3 scripts/torch_refine_ab.py time
        on the card: the kernel-lean update at K=102400 T=30 refined by each
        arm and method, CUDA events in turns (chip_smoke.py's
        time_interleaved), median of 5 reps of 3 updates, with the card's
        name and power limit

Prints one JSON line.
"""

import contextlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (the operands and the timing loop)

PRESETS = ("full_body", "diff_drive")
METHODS = ("gradient", "gauss_newton")


@contextlib.contextmanager
def sequential_rollout():
    """diff/gradients.py rolls every model out sequentially, as JAX does."""
    from ccv_mppi_path_tracker_tpu_torch.diff import gradients

    saved = gradients.CLOSED_FORM_MODELS
    gradients.CLOSED_FORM_MODELS = ()
    try:
        yield
    finally:
        gradients.CLOSED_FORM_MODELS = saved


def literal_refine(cfg, method, u, state, ref, dt, sp, cp, mp, steps=3):
    """The JAX package's refinement (its diff/gradients.py:103-178) with
    torch.func in place of jax: the same guard, damping and projection."""
    import torch

    from ccv_mppi_path_tracker_tpu_torch.diff import gradients

    with sequential_rollout():
        if method == "gradient":
            cost = gradients.make_trajectory_cost(cfg)
            grad = torch.func.grad(lambda v: cost(v, state, ref, dt, cp, mp))
            for _ in range(steps):
                u = torch.clamp(u - 0.02 * grad(u), sp.u_min, sp.u_max)
            return u
        res = gradients.make_trajectory_residuals(cfg)

        def f(v):
            return res(v, state, ref, dt, cp, mp)

        def f_and_r(v):
            r = f(v)
            return r, r

        eye = torch.eye(u.numel(), dtype=u.dtype, device=u.device)
        r0 = f(u)
        cost = torch.sum(r0 * r0)
        lam = torch.full((), 1e-3, dtype=u.dtype, device=u.device)
        for _ in range(steps):
            jac, r = torch.func.jacfwd(f_and_r, has_aux=True)(u)
            jac = jac.reshape(r.shape[0], -1)
            chol, _ = torch.linalg.cholesky_ex(jac.T @ jac + lam * eye)
            delta = torch.cholesky_solve((jac.T @ r)[:, None], chol)[:, 0]
            u_new = torch.clamp(u - delta.reshape(u.shape), sp.u_min, sp.u_max)
            r_new = f(u_new)
            cost_new = torch.sum(r_new * r_new)
            accept = cost_new < cost
            u = torch.where(accept, u_new, u)
            cost = torch.where(accept, cost_new, cost)
            lam = torch.where(accept, lam * 0.5, lam * 10.0)
        return u


def updaters(s, use_kernel=True):
    """{(arm, method): fn} of refined updates of one kernel_case, each
    carrying its own warm start."""
    from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu_torch.paths import resample_reference
    from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

    args = (s["state"], s["path"], s["dt"], s["sp"], s["cp"])
    ref = resample_reference(s["path"], s["state"][:2], s["cp"].v_ref, s["dt"],
                             s["cfg"].horizon)
    fns = {}
    for method in METHODS:
        shipped = [ControllerState(s["u_prev"], 0, 0)]
        literal = [ControllerState(s["u_prev"], 0, 0)]

        def run_shipped(c=shipped, m=method):
            c[0], _ = mppi_step(s["cfg"], c[0], *args, model_params=s["mp"],
                                use_kernel=use_kernel, lean=True, refine_steps=3,
                                refine_method=m)

        def run_literal(c=literal, m=method):
            c[0], res = mppi_step(s["cfg"], c[0], *args, model_params=s["mp"],
                                  use_kernel=use_kernel, lean=True)
            c[0].u_prev = literal_refine(s["cfg"], m, res.u_opt, s["state"], ref, s["dt"],
                                         s["sp"], s["cp"], s["mp"])

        fns["shipped", method] = run_shipped
        fns["literal", method] = run_literal
    return fns


def count():
    import collections

    from torch.profiler import ProfilerActivity, profile

    out = {}
    for preset in PRESETS:
        s = smoke.kernel_case(preset, 256, 30, roll_off=True, seed=5, device="cpu")
        for (arm, method), fn in updaters(s).items():
            fn()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                fn()
            calls = collections.Counter(e.name for e in prof.events()
                                        if e.name.startswith("aten::"))
            out[f"{s['model']}/{arm}/{method}"] = sum(calls.values())
    print(json.dumps({"aten_calls_per_refined_update": out, "device": "cpu"}))


def time_arms():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_refine_ab.py time: no CUDA device")
    arms = {}
    for preset in PRESETS:
        s = smoke.kernel_case(preset, smoke.K_MAIN, smoke.T_MAIN, roll_off=True, seed=5)
        for (arm, method), fn in updaters(s).items():
            arms[f"{s['model']}/{arm}/{method}"] = (fn, 3)
    times = smoke.time_interleaved(arms, 5, warm=1)
    print(json.dumps({"refined_update_ms": {
        name: {"median": statistics.median(v), "min": min(v), "max": max(v)}
        for name, v in times.items()},
        "card": smoke.nvidia_smi("name,power.limit")}))


if __name__ == "__main__":
    {"count": count, "time": time_arms}[sys.argv[1]]()
