"""Nearest-reference-point distance for the path-tracking cost (port of
``ops/mindist.py``).

Centered expanded form, as in the JAX package and the fused kernel: with
c = ref[0], xc = p - c and rc_j = ref_j - c,

    |p - ref_j|^2 = |xc|^2 + (|rc_j|^2 - 2 xc . rc_j)

so the min scan is two multiply-adds and a min per reference point. |xc|^2 is
added back after the min and the result clamped to [0, DIST_CAP^2]. Centering
bounds the rounding error by the window span (see the JAX module docstring).
"""

from __future__ import annotations

import torch

# min_distance initialization in the reference (src/diff_drive_mppi.cpp:185)
DIST_CAP = 100.0

# Positions x reference points per broadcast chunk: bounds the (N, R)
# temporary (10^7 float32 elements = 40 MB).
_CHUNK_ELEMS = 10**7


def center_ref(ref_xy: torch.Tensor):
    """(c, 2*(ref - c), |ref - c|^2) with c = ref[0]: shapes (2,), (R, 2),
    (R,). Shared by this op and the fused kernel's input packing."""
    c = ref_xy[..., 0, :]
    rc = ref_xy - ref_xy[..., 0:1, :]
    rn = rc[..., 0] * rc[..., 0] + rc[..., 1] * rc[..., 1]
    return c, 2.0 * rc, rn


def min_sq_distance(xy: torch.Tensor, ref_xy: torch.Tensor) -> torch.Tensor:
    """clamp(min_j |xy - ref_j|^2, 0, DIST_CAP^2).

    xy: (..., 2) positions; ref_xy: (R, 2). Returns (...,). Elementwise on
    purpose (not a matmul), chunked over positions to bound memory.
    """
    c, rc2, rn = center_ref(ref_xy)
    xc = (xy - c).reshape(-1, 2)
    chunk = max(1, _CHUNK_ELEMS // ref_xy.shape[0])
    out = []
    for p in torch.split(xc, chunk):
        pn = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
        t = rn - p[:, 0:1] * rc2[:, 0] - p[:, 1:2] * rc2[:, 1]
        m = torch.amin(t, dim=-1)
        out.append(torch.clamp(pn + m, 0.0, DIST_CAP * DIST_CAP))
    return torch.cat(out).reshape(xy.shape[:-1])
