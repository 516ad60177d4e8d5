"""PRNG policy: every random draw of a control cycle is a pure function of
the run's integer ``seed``, the cycle counter ``step`` and, in a fleet, the
robot index ``b``.

- The eager path draws its exploration noise from a ``torch.Generator``
  seeded by :func:`cycle_seed` (``stream`` 0); the plant's process noise
  uses ``stream`` 1. No global RNG state is read or written. A fleet's robot
  b seeds its own generator from (seed, step, stream, b); robot 0's seed is
  the single-robot one.
- The fused kernel draws its own normals with Philox4x32-10 keyed by
  ``(seed, step)`` at counter ``(k, t, pair, b)`` (b = 0 for one robot) and
  Box-Muller over the top 23 bits of words 0 and 1 (csrc/rollout_cost.cu).
  :func:`philox_normals` is the same generator in plain torch: its uint32
  arithmetic is emulated in int64 with ``& 0xFFFFFFFF``, so the kernel and
  its plain version draw the same samples. Robot 0 of a fleet draws the
  single-robot stream, and no normal depends on B or the block size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
# 2*pi rounded to float32, the constant the kernel multiplies by
TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def cycle_seed(seed: int, step: int, stream: int = 0, robot: int = 0) -> int:
    """A 63-bit generator seed derived from (seed, step, stream, robot).
    NumPy's SeedSequence pads its entropy with zeros to four words, so robot
    0 gives the seed of (seed, step, stream) alone."""
    state = np.random.SeedSequence([seed & _MASK, step & _MASK, stream, robot])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def cycle_generator(seed: int, step: int, device, stream: int = 0, robot: int = 0):
    """A fresh ``torch.Generator`` on ``device`` for one cycle's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cycle_seed(seed, step, stream, robot))
    return gen


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product m * x, with x holding
    uint32 values in int64. x is split into 16-bit halves so that no partial
    product leaves the int64 range."""
    a = m * (x >> 16)
    b = m * (x & 0xFFFF)
    c = a + (b >> 16)
    return c >> 16, ((c & 0xFFFF) << 16) | (b & 0xFFFF)


def philox4x32(counter, key):
    """Philox4x32-10 of four uint32 counter words (int64 tensors of one
    shape) under two uint32 key words (Python ints). Returns four words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK
        k1 = (k1 + PHILOX_W1) & _MASK
    return c0, c1, c2, c3


def philox_normals(seed: int, step: int, num_samples: int, tm1: int,
                   u_dim: int, robot=0, device=None, dtype=torch.float32):
    """Standard normals (T-1, K, U) of the kernel's RNG mode: entry
    (t, k, j) comes from counter (k, t, j // 2, robot) under key (seed,
    step), the cosine half of Box-Muller for even j and the sine half for
    odd j. ``robot`` is an int, or a 1-D tensor of robot indices: then the
    result is (B, T-1, K, U), row b the normals of robot ``robot[b]``."""
    n_pairs = (u_dim + 1) // 2
    rob = torch.as_tensor(robot, dtype=torch.int64, device=device)
    lead = tuple(rob.shape)
    t = torch.arange(tm1, dtype=torch.int64, device=device).view(tm1, 1, 1)
    k = torch.arange(num_samples, dtype=torch.int64, device=device).view(1, -1, 1)
    p = torch.arange(n_pairs, dtype=torch.int64, device=device).view(1, 1, -1)
    shape = lead + (tm1, num_samples, n_pairs)
    x0, x1, _, _ = philox4x32(
        (k.expand(shape), t.expand(shape), p.expand(shape),
         rob.view(lead + (1, 1, 1)).expand(shape)),
        (seed, step),
    )
    scale = 1.0 / (1 << 23)
    u1 = (x0 >> 9).to(torch.float32) * scale
    u2 = (x1 >> 9).to(torch.float32) * scale
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    theta = TWO_PI_F32 * u2
    normals = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return normals.reshape(shape[:-1] + (2 * n_pairs,))[..., :u_dim].to(dtype)
