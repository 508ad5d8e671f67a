"""Step-accurate simulation of a PIM subarray (default 1024x1024).

This is the *procedural* model used to verify step/cell counts and
operand preservation of the paper's FA (Fig. 3) and to count read / write /
search events for the cost model. The fast *functional* bit-plane arithmetic
lives in ``repro_torch.core.fp``; both are validated against each other.

A copy of the reference's ``repro/core/subarray.py`` (numpy; the write
logic comes from the port's ``core.logic``).

Conventions:
  * state is a numpy int8 grid ``[rows, cols]`` of stored bits;
  * one "step" = one row-parallel read followed by one row-parallel
    logic-write (the paper's Fig. 3 counts steps this way);
  * column-parallelism: an op applies to an arbitrary set of columns at once
    (the 1T-1R cell allows per-column write data within a row — §3.1);
  * reads/writes/searches are tallied per *row-parallel event* and per *cell*.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import logic


@dataclasses.dataclass
class OpTally:
    read_events: int = 0
    write_events: int = 0
    search_events: int = 0
    cells_read: int = 0
    cells_written: int = 0
    steps: int = 0

    def add(self, other: "OpTally") -> None:
        self.read_events += other.read_events
        self.write_events += other.write_events
        self.search_events += other.search_events
        self.cells_read += other.cells_read
        self.cells_written += other.cells_written
        self.steps += other.steps


class Subarray:
    """A single PIM subarray with event counting."""

    def __init__(self, rows: int = 1024, cols: int = 1024):
        self.rows = rows
        self.cols = cols
        self.state = np.zeros((rows, cols), dtype=np.int8)
        self.tally = OpTally()

    # -- primitive events ---------------------------------------------------

    def read_row(self, row: int, cols: np.ndarray | list[int]) -> np.ndarray:
        cols = np.asarray(cols)
        self.tally.read_events += 1
        self.tally.cells_read += int(cols.size)
        return self.state[row, cols].copy()

    def write_row(self, row: int, cols, values, mode: str = "store") -> None:
        """Row-parallel logic-write: per-column data within one row (§3.1)."""
        cols = np.asarray(cols)
        values = np.asarray(values, dtype=np.int8)
        b_i = self.state[row, cols]
        b_next = np.asarray(logic.mtj_write(values, b_i, mode))
        self.state[row, cols] = b_next.astype(np.int8)
        self.tally.write_events += 1
        self.tally.cells_written += int(cols.size)

    def step(self, read_row_idx: int, read_cols, write_row_idx: int,
             write_cols, mode: str) -> np.ndarray:
        """One FA-procedure step: parallel read then logic-write (Fig. 3)."""
        vals = self.read_row(read_row_idx, read_cols)
        self.write_row(write_row_idx, write_cols, vals, mode)
        self.tally.steps += 1
        return vals

    def search(self, row: int, cols, pattern) -> bool:
        """Associative 'search' (Fig. 4a): sense whether the stored bits on
        ``cols`` of ``row`` match ``pattern`` by the aggregate SL current.

        A mismatching bit path has low resistance -> high current; the match
        is declared when the total current stays below the all-match
        threshold. Functionally: all(stored == pattern).
        """
        cols = np.asarray(cols)
        pattern = np.asarray(pattern, dtype=np.int8)
        self.tally.search_events += 1
        stored = self.state[row, cols]
        # current contribution: mismatch -> R_on path -> high current (1)
        mismatch_current = (stored != pattern).sum()
        return bool(mismatch_current == 0)
