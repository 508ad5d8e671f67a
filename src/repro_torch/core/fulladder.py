"""The paper's 4-step operand-preserving full adder (Fig. 3) and the
FloatPIM 13-step NOR-based FA it is compared against.

1-bit FA (paper eq. (1)):
    S  = X xor Y xor Z
    Z' = X*Y + Z*(X xor Y)

The proposed procedure uses **4 steps** (each = one row-parallel read followed
by one row-parallel logic-write) and **4 cache cells**, and never modifies the
operand cells X, Y, Z — required for training, where operands are re-read by
the backward pass (the [16] FA destroys them; FloatPIM needs 13 steps and
12 cells).

Concrete schedule used here (functionally identical to Fig. 3; per-column
write *data* and per-column write *polarity* are both allowed by the 1T-1R
cell, §3.1):

    caches c1..c4 (zeroed)
    step 1: read {X, Z}        -> c1 <- X (store), c2 <- X (store),
                                  c3 <- Z (store), c4 <- Z (store)
    step 2: read {Y}           -> c1 <- xor Y   (= X^Y)
                                  c2 <- and Y   (= XY)
    step 3: read {c1 = X^Y}    -> c3 <- and X^Y (= Z(X^Y))
                                  c4 <- xor X^Y (= S)
    step 4: read {c3}          -> c2 <- or Z(X^Y) (= Z')

Result: S in c4, Z' in c2. 4 steps, 4 cells, operands intact.

A copy of the reference's ``repro/core/fulladder.py`` (numpy).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.subarray import OpTally, Subarray

# Proposed-FA published counts (paper §3.2).
PROPOSED_FA_STEPS = 4
PROPOSED_FA_CELLS = 4
# FloatPIM's NOR-based FA counts (paper §2, from [1]/[16] comparison).
FLOATPIM_FA_STEPS = 13
FLOATPIM_FA_CELLS = 12


@dataclasses.dataclass
class FAResult:
    s: np.ndarray
    carry: np.ndarray
    tally: OpTally


def proposed_fa(sub: Subarray, row_x: int, row_y: int, row_z: int,
                cache_rows: tuple[int, int, int, int],
                cols) -> FAResult:
    """Execute the 4-step FA on ``sub`` for all ``cols`` in parallel.

    X/Y/Z live at (row_x|row_y|row_z, cols). Caches are 4 rows reused across
    sequential 1-bit FAs of a multi-bit addition.
    """
    cols = np.asarray(cols)
    c1, c2, c3, c4 = cache_rows
    before = dataclasses.replace(sub.tally)

    # step 1 — parallel read of X and Z, store into the 4 caches.
    x = sub.read_row(row_x, cols)
    z = sub.read_row(row_z, cols)
    sub.write_row(c1, cols, x, "store")
    sub.write_row(c2, cols, x, "store")
    sub.write_row(c3, cols, z, "store")
    sub.write_row(c4, cols, z, "store")
    sub.tally.steps += 1
    # NOTE on counting: Fig. 3 counts step 1 as ONE read+write step — X, Y, Z
    # sit in one physical row (different column groups) so the copy is a
    # single row-parallel event. Our grid stores them on separate rows for
    # clarity, so we consolidate the tally below to the paper's event counts.

    # step 2 — read Y; XOR and AND it into c1/c2 in parallel.
    y = sub.read_row(row_y, cols)
    sub.write_row(c1, cols, y, "xor")      # X ^ Y
    sub.write_row(c2, cols, y, "and")      # X & Y
    sub.tally.steps += 1

    # step 3 — read X^Y; AND into c3, XOR into c4 in parallel.
    xy = sub.read_row(c1, cols)
    sub.write_row(c3, cols, xy, "and")     # Z & (X^Y)
    sub.write_row(c4, cols, xy, "xor")     # S = Z ^ X ^ Y
    sub.tally.steps += 1

    # step 4 — read Z(X^Y); OR into c2 -> carry out.
    zxy = sub.read_row(c3, cols)
    sub.write_row(c2, cols, zxy, "or")     # Z' = XY | Z(X^Y)
    sub.tally.steps += 1

    s = sub.read_row(c4, cols)
    carry = sub.read_row(c2, cols)
    after = sub.tally
    tally = OpTally(
        read_events=after.read_events - before.read_events,
        write_events=after.write_events - before.write_events,
        search_events=after.search_events - before.search_events,
        cells_read=after.cells_read - before.cells_read,
        cells_written=after.cells_written - before.cells_written,
        steps=after.steps - before.steps,
    )
    return FAResult(s=s, carry=carry, tally=tally)


def multibit_add(sub: Subarray, rows_x, rows_y, n_bits: int,
                 cache_rows, cols) -> tuple[np.ndarray, np.ndarray]:
    """Ripple-carry N-bit addition X+Y via sequential 1-bit FAs (LSB first).

    ``rows_x[k]`` holds bit k of X (idem Y). The carry is kept in a cache row
    that is reused (the paper: "MRAM cache can be reused in sequential 1-bit
    full additions"). Returns (sum bits [n_bits, len(cols)], carry-out).
    """
    cols = np.asarray(cols)
    carry_row = cache_rows[4]  # a 5th row to persist the running carry
    sub.write_row(carry_row, cols, np.zeros(cols.size, np.int8), "store")
    out_bits = []
    for k in range(n_bits):
        r = proposed_fa(sub, rows_x[k], rows_y[k], carry_row,
                        cache_rows[:4], cols)
        out_bits.append(r.s)
        sub.write_row(carry_row, cols, r.carry, "store")
    return np.stack(out_bits, axis=0), sub.read_row(carry_row, cols)


def floatpim_fa(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """FloatPIM's FA, functional model + published step/cell counts.

    FloatPIM realizes the FA as a fixed 13-cycle MAGIC-NOR schedule over 12
    cells (the exact gate netlist is in [1]; only the counts and the
    operand-destroying property matter for this paper's comparison — §2).
    Returns (s, carry, steps, cells).
    """
    x = np.asarray(x)
    y = np.asarray(y)
    z = np.asarray(z)
    s = x ^ y ^ z
    carry = (x & y) | (z & (x ^ y))
    return s, carry, FLOATPIM_FA_STEPS, FLOATPIM_FA_CELLS
