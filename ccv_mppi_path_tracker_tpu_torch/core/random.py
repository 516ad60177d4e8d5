"""PRNG policy: every random draw of a control cycle is a pure function of
the run's integer ``seed``, the cycle counter ``step`` and, in a fleet, the
robot index ``b``.

- The eager path draws its exploration noise from a ``torch.Generator``
  seeded by :func:`cycle_seed` (``stream`` 0). No global RNG state is read
  or written. A fleet's robot b seeds its own generator from (seed, step,
  stream, b); robot 0's seed is the single-robot one.
- The fused kernel draws its own normals with Philox4x32-10 keyed by
  ``(seed, step)`` at counter ``(k, t, pair, b)`` (b = 0 for one robot) and
  Box-Muller over the top 23 bits of words 0 and 1 (csrc/rollout_cost.cu).
  A shard of a sample-sharded update starts its k at ``first_sample``, so
  its samples are those samples of the unsharded stream.
  :func:`philox_normals` is the same generator in plain torch: its uint32
  arithmetic is emulated in int64 with ``& 0xFFFFFFFF``, so the kernel and
  its plain version draw the same samples. Robot 0 of a fleet draws the
  single-robot stream, and no normal depends on B or the block size.
- The key (seed, step) may be a device tensor [seed, step]
  (``ControllerState.key``): the kernel reads it there, and a CUDA graph of
  a cycle draws anew at each replay. The plant's process noise is drawn
  from the same key by :func:`plant_normals`, at counter (p, 0,
  :data:`PLANT_PAIR`, 0): the kernel's pair word is below 3, so no control
  normal shares a counter with it.
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
# Counter word 2 of the plant's process noise (the kernel's pair index is
# below 3).
PLANT_PAIR = 0x80000000


def cycle_seed(seed: int, step: int, stream: int = 0, robot: int = 0,
               shard: int = 0) -> int:
    """A 63-bit generator seed derived from (seed, step, stream, robot) and,
    for shard s > 0 of a sample-sharded update, s. NumPy's SeedSequence pads
    its entropy with zeros to four words, so robot 0 gives the seed of
    (seed, step, stream) alone; shard 0 adds no word, so it draws the
    unsharded stream."""
    words = [seed & _MASK, step & _MASK, stream, robot] + ([shard] if shard else [])
    state = np.random.SeedSequence(words)
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def cycle_generator(seed: int, step: int, device, stream: int = 0, robot: int = 0,
                    shard: int = 0):
    """A fresh ``torch.Generator`` on ``device`` for one cycle's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cycle_seed(seed, step, stream, robot, shard))
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


def philox_normals(seed, step, num_samples: int, tm1: int,
                   u_dim: int, robot=0, device=None, dtype=torch.float32,
                   first_sample: int = 0):
    """Standard normals (T-1, K, U) of the kernel's RNG mode: entry
    (t, k, j) comes from counter (first_sample + k, t, j // 2, robot) under
    key (seed, step), the cosine half of Box-Muller for even j and the sine
    half for odd j, so the draw at ``first_sample`` s is samples s ... s+K-1
    of the draw at 0. ``robot`` is an int, or a 1-D tensor of robot indices:
    then the result is (B, T-1, K, U), row b the normals of robot
    ``robot[b]``. ``seed`` and ``step`` may be 0-d int64 tensors (an
    exported step draws its noise from its inputs)."""
    n_pairs = (u_dim + 1) // 2
    rob = torch.as_tensor(robot, dtype=torch.int64, device=device)
    lead = tuple(rob.shape)
    t = torch.arange(tm1, dtype=torch.int64, device=device).view(tm1, 1, 1)
    k = (torch.arange(num_samples, dtype=torch.int64, device=device)
         + first_sample).view(1, -1, 1) & _MASK
    p = torch.arange(n_pairs, dtype=torch.int64, device=device).view(1, 1, -1)
    shape = lead + (tm1, num_samples, n_pairs)
    x0, x1, _, _ = philox4x32(
        (k.expand(shape), t.expand(shape), p.expand(shape),
         rob.view(lead + (1, 1, 1)).expand(shape)),
        (seed, step),
    )
    normals = _box_muller(x0, x1)
    return normals.reshape(shape[:-1] + (2 * n_pairs,))[..., :u_dim].to(dtype)


def _box_muller(x0, x1):
    """(..., 2) normals, cosine then sine half, from two Philox words: the
    top 23 bits of each as uniforms, as the kernel computes them."""
    scale = 1.0 / (1 << 23)
    u1 = (x0 >> 9).to(torch.float32) * scale
    u2 = (x1 >> 9).to(torch.float32) * scale
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    theta = TWO_PI_F32 * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def plant_normals(key: torch.Tensor, shape, dtype=torch.float32):
    """Standard normals of ``shape`` for the plant's process noise of the
    cycle keyed by ``key`` [seed, step] (a (2,) int64 tensor), drawn on its
    device: normals 2p and 2p+1 (in row-major order) from counter (p, 0,
    PLANT_PAIR, 0). No host integer enters, so a CUDA graph of the cycle
    draws anew at each replay."""
    n = math.prod(shape)
    p = torch.arange((n + 1) // 2, dtype=torch.int64, device=key.device)
    zero = torch.zeros_like(p)
    x0, x1, _, _ = philox4x32((p, zero, zero + PLANT_PAIR, zero), (key[0], key[1]))
    return _box_muller(x0, x1).reshape(-1)[:n].reshape(shape).to(dtype)
