"""A traced update's device time by program stage, for the ``stage_us.*``
readers.

The port marks the stages of its control step (``utils/profiling.py stage``:
prologue, draw, samples, rollout_cost, average, refine, finish). At the
capture of an update's CUDA graph each stage records the run of the graph's
device nodes that it launched, and the graph keeps them as its stage table
(``profiling.stage_tables()``: ``stages``, (name, first node, node count) in
node order, and ``kinds``, one letter a device node: K a kernel, C a copy, S
a set). A replay runs no host code; its device operations are the graph's
device nodes in capture order.

So in each traced unit (``obs["units"]["update"]``, ``trace.unit_ops``),
its device operations in start order, the replay is one block of as many
operations as the table has nodes, after the call's input copies and before
its output clones (every operation outside the block a ``Memcpy``). A unit
matches a table where exactly one place fits that and the block's copies and
sets fall on ``Memcpy`` and ``Memset`` operations and its kernels on neither.
A unit that does not match is skipped (a profiler started late drops its
first records). Of the process's tables, the one that the most units match
is read (``stage_matched.update`` reports the share it matched); with fewer
than half the units matched, or a port without stage tables, no stage is
read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MATCHED = 0.5          # the least share of the traced units matched for a reading
OUTSIDE = "outside"    # the unit's device time in no stage


def _letter(name: str) -> str:
    return "C" if name.startswith("Memcpy") else "S" if name.startswith("Memset") else "K"


def _tables() -> list:
    from ccv_mppi_path_tracker_tpu_torch.utils import profiling

    get = getattr(profiling, "stage_tables", None)
    return [] if get is None else get()


def _place(ops: str, kinds: str) -> Optional[int]:
    """Where the replay's block ``kinds`` starts among a unit's operations
    ``ops`` (letters in start order), or None where no place or several fit:
    every operation before and after it a copy, its letters equal."""
    m, n = len(ops), len(kinds)
    lead = m - len(ops.lstrip("C"))
    trail = m - len(ops.rstrip("C"))
    fits = [s for s in range(max(0, m - n - trail), min(lead, m - n) + 1)
            if ops[s:s + n] == kinds]
    return fits[0] if len(fits) == 1 else None


def split(units, table) -> tuple:
    """(the stage names, an (n, len(names) + 1) array: the device us of each
    matched unit in each stage, then outside every stage) of ``units``
    (``trace.unit_ops``) under ``table``; unmatched units are left out."""
    names = list(dict.fromkeys(name for name, _, _ in table.stages))
    letters = np.array([_letter(n) for n in units["names"]] or ["K"])
    per_op = letters[units["name"]] if len(units["name"]) else np.array([], dtype=str)
    bounds = np.searchsorted(units["unit"], np.arange(len(units["unit_us"]) + 1))
    rows = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        start = _place("".join(per_op[a:b]), table.kinds)
        if start is None:
            continue
        dur = units["dur_us"][a:b]
        row = [0.0] * (len(names) + 1)
        for name, first, count in table.stages:
            row[names.index(name)] += float(dur[start + first:start + first + count].sum())
        row[-1] = float(dur.sum()) - sum(row[:-1])
        rows.append(row)
    return names, np.array(rows, dtype=np.float64).reshape(-1, len(names) + 1)


def _matched(obs) -> Optional[tuple]:
    """(the stage names, the rows of :func:`split`, the number of traced
    units) under the table that the most units match (of two that match as
    many, the newer); None where no unit was traced or the port has no stage
    table."""
    units = obs["units"].get("update")
    tables = _tables()
    if units is None or not len(units["unit_us"]) or not tables:
        return None
    best = None
    for table in tables:          # oldest first
        names, rows = split(units, table)
        if best is None or len(rows) >= len(best[1]):
            best = names, rows
    return best + (len(units["unit_us"]),)


def stage_us(obs, stage: str) -> Optional[float]:
    """The mean device us a matched traced unit of ``stage`` (or of
    :data:`OUTSIDE`); None where :func:`_matched` is, fewer than
    :data:`MATCHED` of the units match, or the table has no such stage."""
    matched = _matched(obs)
    if matched is None:
        return None
    names, rows, n = matched
    if not len(rows) or len(rows) < MATCHED * n:
        return None
    if stage == OUTSIDE:
        return float(rows[:, -1].mean())
    if stage not in names:
        return None
    return float(rows[:, names.index(stage)].mean())


def matched_share(obs) -> Optional[float]:
    """The share of the traced units that the best table matches, in %;
    None where :func:`_matched` is."""
    matched = _matched(obs)
    return None if matched is None else 100.0 * len(matched[1]) / matched[2]
