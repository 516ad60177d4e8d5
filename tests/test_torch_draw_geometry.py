"""The launch geometry of the eager arm's draw kernel (csrc/rollout_cost.cu
philox_normals_kernel), on the CPU: the kernel itself runs only on the card,
where chip_smoke.py phase 31 holds it against its plain version at these
shapes.

- :func:`philox_draw_geometry` at the shapes the port launches and at the
  edges: its blocks of ``rows_per_block`` rows cover every (b, t, k) row once,
  each block's output span is contiguous and starts 16-byte aligned, the tile
  fits 48 KB (none where a row is one 4-, 8- or 16-byte store), U = 1 ... 5
  take their unrolled instantiation and any other U the generic one, and
  past INT_MAX rows the 64-bit row split;
- the kernel's split of row r into (b, t, k), two divisions by the
  invariant K and T-1 as a multiply-high and a shift (csrc ``draw_div`` and
  ``draw_quot``, written out here in Python), is exact for every row below
  2^31 and puts entry (b, t, k, j) at its place, every float written once;
- ``SIGNATURE`` is the string csrc/rollout_cost.cu's
  ``rollout_cost_signature()`` returns, read from the source as text;
- the wrapper refuses a CPU device and shapes it cannot draw, before it
  builds anything; the ptxas report parser finds each draw instantiation.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from ccv_mppi_path_tracker_tpu_torch.core.types import make_key
from ccv_mppi_path_tracker_tpu_torch.kernels import build
from ccv_mppi_path_tracker_tpu_torch.kernels.rollout_cost import (
    DRAW_ROWS,
    DRAW_SMEM,
    INT_MAX,
    MAX_ROBOTS,
    SIGNATURE,
    SOURCE,
    DrawGeometry,
    draw_instantiations,
    instantiations,
    philox_draw_geometry,
    philox_normals_cuda,
)

ROOT = Path(__file__).resolve().parents[1]

# (B, T-1, K, U): the flagship full_body draw and its U=3, the fleet,
# meta_train's step, U=1 and U=4, the generic U=7 with a ragged float tail,
# K=1000, T-1 past the old grid's 65535, wide generic U
SHAPES = [
    (1, 29, 102_400, 5), (1, 29, 102_400, 3), (256, 14, 1024, 2), (64, 7, 64, 2),
    (1, 29, 102_400, 1), (1, 29, 102_400, 4), (2, 9, 999, 7), (1, 29, 1000, 5),
    (2, 70_001, 3, 5), (1, 1, 1, 1), (3, 5, 17, 48), (1, 2, 7, 100), (1, 1, 5, 3000),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_blocks_cover_every_row_once_in_aligned_spans(shape):
    robots, tm1, k, u_dim = shape
    g = philox_draw_geometry(robots, tm1, k, u_dim)
    assert isinstance(g, DrawGeometry)
    assert g.rows == robots * tm1 * k
    assert 1 <= g.rows_per_block <= DRAW_ROWS
    # blocks of rows_per_block rows, the last one ragged: every row once
    assert (g.blocks - 1) * g.rows_per_block < g.rows <= g.blocks * g.rows_per_block
    # block i writes floats [i * rows_per_block * U, ...): contiguous, and
    # its first float 16-byte aligned
    assert (g.rows_per_block * u_dim * 4) % 16 == 0
    # a row of U = 1, 2, 4 is one vector store; other U stage a tile
    tile = 4 * g.rows_per_block * u_dim
    assert g.smem == (0 if u_dim in (1, 2, 4) else tile) and tile <= DRAW_SMEM
    assert g.unrolled_u == (u_dim if u_dim <= 5 else 0)
    assert g.wide == 0
    if u_dim <= 48:
        assert g.rows_per_block == DRAW_ROWS
    assert g.blocks < 2**31


def test_meta_train_s_draw_fills_every_lane():
    # (64, 7, 64, 2): 28 672 rows, 112 full blocks of 256 rows, no tile
    g = philox_draw_geometry(64, 7, 64, 2)
    assert g == DrawGeometry(28_672, 256, 112, 0, 2, 0)


@pytest.mark.parametrize("shape", [(2, 1, 2**30 + 1, 1), (3, 7, 2**31 - 1, 5),
                                   (MAX_ROBOTS, 2**10, 2**12, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_past_int_max_rows_the_split_is_wide(shape):
    g = philox_draw_geometry(*shape)
    assert g.rows > INT_MAX and g.wide == 1
    assert (g.blocks - 1) * g.rows_per_block < g.rows <= g.blocks * g.rows_per_block
    assert philox_draw_geometry(1, 1, INT_MAX, 1).wide == 0


def _draw_div(d):
    """csrc draw_div: (mul, shr) of the division by d."""
    if d == 1:
        return 0, 0
    lg = (d - 1).bit_length()  # ceil(log2 d)
    return -(-(1 << (31 + lg)) // d), lg - 1


def _draw_quot(n, d):
    """csrc draw_quot: n // d as a multiply-high and a shift, n < 2^31."""
    mul, shr = _draw_div(d)
    return ((n * mul) >> 32) >> shr if d > 1 else n


@pytest.mark.parametrize("d", [1, 2, 3, 7, 14, 29, 64, 999, 1000, 1024, 102_400, 70_001,
                               2**20 + 1, 2**30 - 1, 2**30, 2**30 + 1, INT_MAX])
def test_the_division_by_an_invariant_is_exact_below_2_31(d):
    rng = np.random.default_rng(d)
    ns = [0, 1, d - 1, d, d + 1, INT_MAX, INT_MAX - 1, INT_MAX - d]
    ns += [q * d + r for q in (1, 2, INT_MAX // d) for r in (0, d - 1) if q * d + r <= INT_MAX]
    ns += rng.integers(0, INT_MAX, 2000, endpoint=True).tolist()
    mul, shr = _draw_div(d)
    assert 0 <= mul < 2**32 and 0 <= shr < 32
    for n in ns:
        if 0 <= n <= INT_MAX:
            assert _draw_quot(n, d) == n // d, (n, d)


def _rows_written(robots, tm1, k, u_dim):
    """The (b, t, k, j) the kernel writes at each output float: thread i of
    block blk takes row r = blk * rows_per_block + i, splits it by
    _draw_quot, and stores its U floats at r * U (directly, or through the
    block's tile, whose span is the block's rows)."""
    g = philox_draw_geometry(robots, tm1, k, u_dim)
    out = np.full((g.rows * u_dim, 4), -1, dtype=np.int64)
    writes = np.zeros(g.rows * u_dim, dtype=np.int64)
    for blk in range(g.blocks):
        row0 = blk * g.rows_per_block
        assert (row0 * u_dim) % 4 == 0
        for i in range(g.rows_per_block):
            r = row0 + i
            if r >= g.rows:
                break
            bt = _draw_quot(r, k)
            b = _draw_quot(bt, tm1)
            row = (b, bt - b * tm1, r - bt * k)
            for j in range(u_dim):
                out[r * u_dim + j] = row + (j,)
                writes[r * u_dim + j] += 1
    return out, writes


@pytest.mark.parametrize("shape", [(1, 3, 5, 5), (2, 9, 99, 7), (64, 7, 64, 2),
                                   (3, 4, 1, 1), (2, 700, 3, 5), (2, 3, 257, 3),
                                   (1, 2, 7, 100)],
                         ids=lambda s: "x".join(map(str, s)))
def test_the_row_split_puts_each_entry_in_its_place(shape):
    robots, tm1, k, u_dim = shape
    got, writes = _rows_written(robots, tm1, k, u_dim)
    assert (writes == 1).all()
    want = np.stack(np.meshgrid(np.arange(robots), np.arange(tm1), np.arange(k),
                                np.arange(u_dim), indexing="ij"), -1).reshape(-1, 4)
    assert (got == want).all()


def test_signature_is_the_source_s():
    text = (ROOT / SOURCE).read_text()
    body = re.search(r"const char\* rollout_cost_signature\(\) \{(.*?)\}", text, re.S)
    assert body is not None
    c_string = "".join(re.findall(r'"([^"]*)"', body.group(1)))
    assert c_string == ";".join(f"{name}:{letters}" for name, letters in SIGNATURE.items())
    # the draw's entry point: out, key, seed, step, K, T-1, U, B, robot_base,
    # first_sample, then the geometry (rows as long long), then the stream
    assert SIGNATURE["philox_normals"] == "ppuuiiiiuu" + "l" + "iiiii" + "p"
    assert len(DrawGeometry._fields) == 6


@pytest.mark.parametrize("bad", [
    dict(robots=0), dict(tm1=0), dict(num_samples=0), dict(u_dim=0),
    dict(robots=2**31), dict(u_dim=3073), dict(num_samples=2**31),
    dict(tm1=2**31),
])
def test_the_wrapper_refuses_shapes_it_cannot_draw(bad):
    kw = dict(num_samples=8, tm1=3, u_dim=2, robots=1) | bad
    # device "cuda" names the card: the shape is refused before any build
    with pytest.raises(ValueError):
        philox_normals_cuda(None, 1, 2, device="cuda", **kw)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_the_wrapper_refuses_a_device_that_is_not_the_card(device):
    with pytest.raises(ValueError):
        philox_normals_cuda(None, 1, 2, num_samples=8, tm1=3, u_dim=2, device=device)
    with pytest.raises(ValueError):
        philox_normals_cuda(make_key(1, 2, "cpu"), num_samples=8, tm1=3, u_dim=2)


@pytest.mark.parametrize("bad", [(0, 1, 1, 1), (1, 1, 1, 3073), (1, 2**31, 1, 1),
                                 (65_535, 2**20, 2**20, 1)])
def test_the_geometry_refuses_what_the_kernel_cannot_take(bad):
    with pytest.raises(ValueError):
        philox_draw_geometry(*bad)


def test_the_ptxas_report_names_each_draw_instantiation():
    log = "\n".join(
        f"ptxas info    : Compiling entry function "
        f"'_ZN12_GLOBAL__N_121philox_normals_kernelILi{u}ELb{w}EEEvPfPKxjjxi7DrawDivS3_jj' "
        f"for 'sm_90a'\n"
        f"ptxas info    : Function properties for "
        f"_ZN12_GLOBAL__N_121philox_normals_kernelILi{u}ELb{w}EEEvPfPKxjjxi7DrawDivS3_jj\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {30 + u + 10 * w} registers, 400 bytes cmem[0]"
        for u in range(6) for w in (0, 1))
    summary = build.ptxas_summary(log)
    draws = draw_instantiations(summary)
    assert sorted(draws) == [(u, w) for u in range(6) for w in (False, True)]
    assert draws[5, False] == dict(registers=35, smem=0, stack=0, spill_stores=0,
                                   spill_loads=0)
    assert draws[5, True]["registers"] == 45
    # the fused kernel's table does not take them for its own
    assert instantiations(summary) == {}
