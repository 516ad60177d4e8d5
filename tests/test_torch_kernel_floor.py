"""The SASS issue floor of scripts/torch_kernel_ab.py sass on synthetic
listings: the hot path with each loop body weighted by its trips (one
backward branch, a nested pair), the slow paths skipped, the count cut at
the fused kernel's finish, and the fused kernel's trips by what each loop
holds (the step loop, the reference scan and its remainder, the costs-in
pass, the noise-input loads in RNG mode). The card runs the real listing:
chip_smoke.py phase 35."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_kernel_ab as ab  # noqa: E402


def listing(*ops):
    """cuobjdump -sass lines, one instruction each, 16 bytes apart."""
    return "\n".join(f"        /*{16 * i:04x}*/                   {op} ;"
                     f"                /* 0x000000000000 */" for i, op in enumerate(ops))


ONE_LOOP = listing(
    "MOV R1, c[0x0][0x28]",            # 0x00
    "IADD3 R2, R2, 0x1, RZ",           # 0x10 <- the loop
    "FFMA R3, R3, R4, R5",             # 0x20
    "ISETP.NE.AND P0, PT, R2, 0x10, PT",
    "@P0 BRA 0x10",                    # 0x40 -> back to 0x10
    "EXIT",                            # 0x50
    "BRA 0x60",                        # 0x60, the trailing self-branch
)


def test_a_loop_body_counts_once_without_trips():
    assert ab.hot_path(ONE_LOOP) == (7, 6)


def test_each_loop_body_is_weighted_by_its_trips():
    loops = ab.sass_loops(ab.sass_instructions(ONE_LOOP))
    assert [(lp.start, lp.end, len(lp.own), lp.parent) for lp in loops] == [
        (0x10, 0x40, 4, None)]
    assert ab.hot_path(ONE_LOOP, trips=lambda loop, loops: 5) == (7, 1 + 4 * 5 + 1)
    assert ab.hot_path(ONE_LOOP, trips=lambda loop, loops: 0) == (7, 2)


def test_nested_loops_multiply_and_slow_paths_are_skipped():
    sass = listing(
        "MOV R1, c[0x0][0x28]",        # 0x00
        "IADD3 R2, R2, 0x1, RZ",       # 0x10 <- outer
        "IADD3 R6, R6, 0x1, RZ",       # 0x20 <- inner
        "@P1 BRA 0x60",                # 0x30 skips a slow path
        "LDL R7, [R1]",                # 0x40
        "STL [R1], R7",                # 0x50
        "@P0 BRA 0x20",                # 0x60 -> inner
        "FADD R3, R3, R4",             # 0x70
        "@P2 BRA 0x10",                # 0x80 -> outer
        "EXIT",                        # 0x90
    )
    loops = ab.sass_loops(ab.sass_instructions(sass))
    outer, inner = loops
    assert (outer.start, outer.end, inner.start, inner.end) == (0x10, 0x80, 0x20, 0x60)
    assert outer.nested == (inner,) and inner.parent == 0x10
    trips = {0x10: 3, 0x20: 7}
    # outer: 0x10, 0x70, 0x80 three times; inner: 0x20, 0x30, 0x60 21 times
    assert ab.hot_path(sass, lambda lp, all_: trips[lp.start]) == (10, 1 + 3 * 3 + 21 * 3 + 1)


def test_the_count_stops_at_the_finish():
    sass = listing("MOV R1, R2", "FADD R3, R3, R4", "ATOMG.E.ADD.STRONG.GPU PT, R5, "
                   "desc[UR8][R2.64], R5", "FADD R3, R3, R4", "EXIT")
    assert ab.hot_path(sass, until=r"\bATOM") == (5, 2)


# a fused kernel in miniature: the step loop draws (a Philox multiply), loads
# the noise on its other path, scans 16 rows an iteration in a nested loop
# with four-row remainder blocks, and an update column loop follows
FUSED = listing(
    "MOV R1, c[0x0][0x28]",                          # 0x000
    "@!P1 BRA 0x50",                                 # 0x010 the RNG path: skip the loads
    "LDG.E.CONSTANT R39, desc[UR8][R42.64]",         # 0x020
    "LDG.E.CONSTANT R41, desc[UR8][R32.64]",         # 0x030
    "BRA 0x60",                                      # 0x040
    "IMAD.WIDE.U32 R30, R30, -0x326172a9, RZ",       # 0x050 <- the step loop's draw
    "LDS.128 R28, [UR6]",                            # 0x060 <- the scan, 16 rows
    *["LDS.128 R32, [UR6+0x10]"] * 15,               # 0x070 ... 0x150
    "FFMA R28, R28, -R11, R30",                      # 0x160
    "FMNMX R113, R113, R28, PT",                     # 0x170
    "@P0 BRA 0x60",                                  # 0x180 -> scan
    "@!P2 BRA 0x200",                                # 0x190 the remainder blocks
    "LDS.128 R28, [UR6]",                            # 0x1a0
    "LDS.128 R32, [UR6+0x10]",                       # 0x1b0
    "LDS.128 R36, [UR6+0x20]",                       # 0x1c0
    "LDS.128 R40, [UR6+0x30]",                       # 0x1d0
    "FFMA R28, R28, -R11, R30",                      # 0x1e0
    "FMNMX R113, R113, R28, PT",                     # 0x1f0
    "FADD R120, R120, R113",                         # 0x200
    "@P3 BRA 0x50",                                  # 0x210 -> the step loop
    "LDS.128 R8, [R2]",                              # 0x220 <- an update column
    "LDS.128 R12, [R4]",                             # 0x230 <- its samples, 4 a float4
    "LDS R9, [R3]",                                  # 0x240
    "FFMA R10, R8, R9, R10",                         # 0x250
    "@P4 BRA 0x230",                                 # 0x260 -> samples
    "LDS.128 R20, [R6]",                             # 0x270 <- the normalizer's column
    "FADD R21, R21, R20",                            # 0x280
    "@P6 BRA 0x270",                                 # 0x290 -> the normalizer
    "@P5 BRA 0x220",                                 # 0x2a0 -> columns
    "ATOMG.E.ADD.STRONG.GPU PT, R5, desc[UR8][R2.64], R5",
    "EXIT",
)


@pytest.mark.parametrize("num_ref,expect_scan", [(30, 2), (15, 1), (4, 0)])
def test_the_fused_trips_weight_the_step_and_the_scan(num_ref, expect_scan):
    horizon, threads = 30, 96
    trips, also_skip = ab.fused_trips("unicycle", horizon, num_ref, threads)
    ins = ab.sass_instructions(FUSED)
    skip = ab.skipped_spans(ins, also_skip)
    assert {0x020, 0x030, 0x040} <= skip            # the noise loads: RNG mode
    assert ({0x1a0, 0x1f0} <= skip) == (num_ref in (30, 15))  # no remainder row left
    loops = {lp.start: lp for lp in ab.sass_loops(ins, skip)}
    assert ab.is_scan(loops[0x060]) and not ab.is_scan(loops[0x050])
    assert trips(loops[0x050], list(loops.values())) == horizon - 1
    assert trips(loops[0x060], list(loops.values())) == expect_scan
    # the samples of a column: threads over 4 a float4; the normalizer's
    # column (float4 loads only) runs in one thread a block: 0
    assert trips(loops[0x230], list(loops.values())) == threads // 4
    assert trips(loops[0x270], list(loops.values())) == 0
    assert trips(loops[0x220], list(loops.values())) == 1  # 59 columns over 96 threads
    steps = horizon - 1
    n, hot = ab.hot_path(FUSED, trips, also_skip, until=r"\bATOM")
    remainder = 0 if num_ref in (30, 15) else 6
    step = 1 + expect_scan * 19 + 1 + remainder + 2
    assert hot == 2 + steps * step + 2 + 4 * (threads // 4)


def test_the_costs_in_pass_runs_no_rollout():
    trips, _ = ab.fused_trips("full_body", 30, 30, 96, costs_in=True)
    loops = ab.sass_loops(ab.sass_instructions(FUSED))
    by_start = {lp.start: lp for lp in loops}
    assert trips(by_start[0x050], loops) == 0 and trips(by_start[0x060], loops) == 0


def test_the_committed_floor_and_ablation_come_from_one_card_run():
    rec = json.loads((ROOT / "artifacts" / "kernel_floor_torch.json").read_text())
    sass, ablate = rec["sass"], rec["ablate"]
    assert sass["card"] == ablate["card"] and "H100" in sass["card"] and " W" in sass["card"]
    assert [r["name"] for r in sass["fused"]] == list(ab.FUSED_ROWS)
    for row in sass["fused"]:
        model, k, t, b, m2, passes = ab.FUSED_ROWS[row["name"]]
        assert (row["model"], row["k"], row["t"], row["b"]) == (model, k, t, b)
        assert len(row["instructions_per_sample"]) == len(passes)
        assert row["issue_floor_ms"] > row["bound_ms"] > 0.0
    assert list(ablate["arms"]) == list(ab.ABLATE_ARMS)
    arms = ablate["arms"]
    assert ablate["derived_ms"]["update"] == pytest.approx(
        arms["base"]["ms"] - arms["no_update"]["ms"])
