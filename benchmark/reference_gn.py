"""The plain reference of the Gauss-Newton-refined full-body controller: the
sampled MPPI update of ``benchmark/reference.py``, then three Gauss-Newton
steps, each guarded by a Levenberg-Marquardt accept, for each robot.

It imports nothing of the program, of JAX, of the JAX package or of
``bench_torch``: the draw, the window, the course, the Euler step, the
distance and the ZMP come from ``benchmark/reference.py``; the residuals, the
Jacobian and the solve are written here, independently of the program's
(which rolls out in closed form, takes the Jacobian by forward mode and
solves by Cholesky).

The refinement (*Gauss-Newton accelerated MPPI Control*, arXiv:2512.04579)
treats the trajectory cost as a sum of squared residuals r(u) of the control
sequence u ((T-1)·U unknowns) and steps

    u <- clamp(u - (J^T J + lam I)^-1 J^T r, u_min, u_max),   J = dr/du.

The residuals, each times the square root of its weight, are those whose
squares make the full-body cost (src/full_body_mppi.cpp:404-424): the path
distance sqrt(min_sq + 1e-12) of states 0 ... T-3 (the small constant keeps
the root differentiable at 0), v - v_ref, the lateral ZMP, the roll-rate
change, min(v, 0) over the same steps, and the first yaw error. The states
come from the sequential Euler rollout (src/full_body_mppi.cpp:445-486).
J is taken by reverse mode (``torch.func.jacrev``), the normal equations
are solved by ``torch.linalg.solve``.

Departures from the paper, as the program has them:

- the Levenberg-Marquardt guard: a step that does not lower the cost is
  rejected and the damping multiplied by 10, an accepted one halves it; the
  damping starts at 1e-3 (the program's ``gauss_newton_refine``);
- the backward term min(v, 0) has the derivative 1/2 at its tie v = 0, as
  ``torch.minimum`` gives it (a zero warm start sits on that tie);
- the step is clamped to the control box, the box of sampling.

``dtype`` is the precision of the sampled update and of the refinement
(float32 as configured; the readings' control computes in bfloat16).
``torch.linalg.solve`` takes no bfloat16: below float32 the normal
equations are formed in ``dtype``, solved in float32 and the step rounded
back to ``dtype``.

The damped normal equations are ill-conditioned: at T=30 J^T J's largest
eigenvalue is about 20 and most of its non-zero ones lie far under the
damping 1e-3 (down to 1e-8), so the damped system's condition number is
about 2e4; and an accepted step spans most of the box. So float32 rounding
moves a refined answer by up to about 2e-2 of the box, in this module as in
the program, each about as far from this module's float64 refinement (CPU,
T=30, K=2048: 1.28e-2 and 7.9e-3 on the worst of 48 answers). The cell's
``u_gap`` limit is set from that reading.

The module sets TF32 off: J^T J is a matrix product, which CUDA may
otherwise round to TF32.
"""

from __future__ import annotations

import torch

from benchmark import reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STEPS = 3          # REFINE_OPTS, scripts/torch_quality_matrix.py:149
DAMPING = 1e-3     # gauss_newton_refine's damping
EPS = 1e-12        # smooths sqrt(d^2) at d = 0

# An accept within rounding: |cost_new - cost| <= RHO * cost. Each cost is a
# float32 sum of m = 5(T-2)+1 = 141 squares at T=30; summed in any order its
# rounding error is at most (m-1)·2^-24 of the sum of the squares (each
# square's own rounding adds 2^-24 more). The program and this module may
# each be off by that much on each of the two costs compared, so a
# difference under 4·m·2^-24 = 3.4e-5 of the cost could fall either way.
RHO = 4 * 141 * 2.0**-24


def residuals(x: reference.Inputs, b: int, u):
    """The (m,) residuals of robot ``b``'s control sequence u (T-1, U)."""
    conf, c = x.config, x.cost
    s = [x.pose[b]]
    for t in range(x.tm1):
        s.append(reference.euler(conf["model"], s[-1], u[t], x.dt))
    states = torch.stack(s)
    tm2 = states.shape[0] - 2
    d2 = reference.min_sq_distance(states[None, :tm2, None, :2], x.ref_xy[b:b + 1])[0, :, 0]
    zmp = reference.zmp_y(states[None, :, None], u[None, :, None], x.dt, conf["body"])[0, :, 0]
    v = u[:tm2, 0]
    droll = u[1:tm2 + 1, 3] - u[:tm2, 3]
    back = torch.minimum(v, torch.zeros_like(v))
    yaw0 = states[0, 2] - x.ref_yaw[b, 0]
    return torch.cat([torch.sqrt(c["path_weight"]) * torch.sqrt(d2 + EPS),
                      torch.sqrt(c["v_weight"]) * (v - c["v_ref"]),
                      torch.sqrt(c["zmp_weight"]) * zmp,
                      torch.sqrt(c["roll_v_weight"]) * droll,
                      torch.sqrt(c["back_weight"]) * back,
                      torch.sqrt(c["yaw_weight"]) * yaw0[None]])


def refine(x: reference.Inputs, b: int, u, steps: int = STEPS):
    """(u, undecided): robot ``b``'s sequence u (T-1, U) after ``steps``
    guarded Gauss-Newton steps, and whether any step's accept lay within
    rounding of its threshold."""
    def f(v):
        return residuals(x, b, v)

    solve_dtype = torch.promote_types(x.dtype, torch.float32)
    n = u.numel()
    eye = torch.eye(n, dtype=x.dtype, device=u.device)
    r = f(u)
    cost = torch.sum(r * r)
    lam = torch.tensor(DAMPING, dtype=x.dtype, device=u.device)
    undecided = False
    for _ in range(steps):
        r = f(u)
        jac = torch.func.jacrev(f)(u).reshape(r.shape[0], n)
        lhs = jac.T @ jac + lam * eye
        rhs = jac.T @ r
        delta = torch.linalg.solve(lhs.to(solve_dtype), rhs.to(solve_dtype)).to(x.dtype)
        u_new = torch.clamp(u - delta.reshape(u.shape), x.lo, x.hi)
        r_new = f(u_new)
        cost_new = torch.sum(r_new * r_new)
        undecided |= bool(torch.abs(cost_new - cost) <= RHO * cost)
        if bool(cost_new < cost):
            u, cost, lam = u_new, cost_new, lam * 0.5
        else:
            lam = lam * 10.0
    if x.config["solver"]["steer_off"]:
        u = u.clone()
        u[:, reference.STEER] = 0.0
    return u, undecided


def update_marked(config: dict, path_xy, pose, u_prev, seed: int, step: int, robots=None,
                  dtype=torch.float32, steps: int = STEPS):
    """(u_opt (B, T-1, U), undecided (B,) bool) of one refined update of B
    robots: :func:`reference.update`'s sampled update, then :func:`refine`
    for each robot."""
    if config["model"] != "full_body":
        raise ValueError(f"the refined reference computes full_body, not {config['model']}")
    u = reference.update(config, path_xy, pose, u_prev, seed, step, robots, dtype=dtype)
    if not steps:
        return u, torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
    x = reference.Inputs(config, path_xy, pose, u_prev, dtype)
    out = [refine(x, b, u[b], steps) for b in range(u.shape[0])]
    return (torch.stack([o[0] for o in out]),
            torch.tensor([o[1] for o in out], dtype=torch.bool, device=u.device))


def update(config: dict, path_xy, pose, u_prev, seed: int, step: int, robots=None,
           dtype=torch.float32):
    """u_opt (B, T-1, U) of one refined update (:func:`update_marked`)."""
    return update_marked(config, path_xy, pose, u_prev, seed, step, robots, dtype)[0]


num_states = reference.num_states
plant = reference.plant
