"""The full §3.3 floating-point ADD executed step-accurately on the
subarray simulator — the executable counterpart of the closed-form
``T_add`` / ``E_add`` coefficients.

Scope: normal, same-sign operands with |a| >= |b| (the harness orients
them), FTZ, round-toward-zero mantissa truncation on the in-array path
(the closed forms count alignment/add/normalize steps, not the rounding
tail). The value is validated against numpy float32 within 1 ulp, and the
measured read/write/search tallies are compared against the paper's
coefficients in ``tests/test_torch_fp_procedures.py`` (a copy of the
reference's ``repro/core/fp_procedure.py``, numpy, checked there as the
reference checks its own in ``tests/test_cost_model.py``):

    reads    ~ 1 + 7*Ne + 7*Nm      (one FA sweep per exponent+mantissa bit)
    writes   ~     7*Ne + 7*Nm
    searches ~ 2*(Nm + 2)           (exponent-difference match probes)
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.fulladder import proposed_fa
from repro_torch.core.subarray import Subarray

NE, NM = 8, 23


def _store_bits(sub: Subarray, row0: int, vals: np.ndarray, n: int, cols):
    for k in range(n):
        sub.write_row(row0 + k, cols, ((vals >> k) & 1).astype(np.int8),
                      "store")


def _read_value(sub: Subarray, row0: int, n: int, cols) -> np.ndarray:
    out = np.zeros(len(cols), np.int64)
    for k in range(n):
        out |= sub.read_row(row0 + k, cols).astype(np.int64) << k
    return out


def _ripple_add(sub: Subarray, rx: int, ry: int, rout: int, n: int, cols,
                cache, *, invert_y: bool = False, cin: int = 0):
    """rout <- rx + (ry or ~ry) + cin via n sequential proposed FAs."""
    carry_row = cache[4]
    sub.write_row(carry_row, cols, np.full(len(cols), cin, np.int8),
                  "store")
    for k in range(n):
        if invert_y:
            yv = 1 - sub.read_row(ry + k, cols)
            sub.write_row(cache[5], cols, yv, "store")
            y_row = cache[5]
        else:
            y_row = ry + k
        r = proposed_fa(sub, rx + k, y_row, carry_row, cache[:4], cols)
        sub.write_row(rout + k, cols, r.s, "store")
        sub.write_row(carry_row, cols, r.carry, "store")
    return sub.read_row(carry_row, cols)


def subarray_fp32_add(a: np.ndarray, b: np.ndarray):
    """Add float32 arrays on the subarray. Returns (result, tally).

    Requires: normal, same sign, |a| >= |b| per lane (assert-checked).
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ua = a.view(np.uint32).astype(np.int64)
    ub = b.view(np.uint32).astype(np.int64)
    assert ((ua >> 31) == (ub >> 31)).all(), "same-sign harness"
    assert ((ua & 0x7FFFFFFF) >= (ub & 0x7FFFFFFF)).all(), "|a|>=|b|"
    n = a.size
    cols = np.arange(n)

    # row map
    R_EA, R_EB, R_D = 0, 8, 16                      # exponents, diff
    R_SA, R_SB_RAW, R_SB = 24, 52, 80               # 27-bit significands
    R_SUM = 108
    CACHE = (140, 141, 142, 143, 144, 145)
    sub = Subarray(rows=160, cols=n)

    ea = (ua >> 23) & 0xFF
    eb = (ub >> 23) & 0xFF
    _store_bits(sub, R_EA, ea, NE, cols)
    _store_bits(sub, R_EB, eb, NE, cols)
    sig_a = ((ua & 0x7FFFFF) | (1 << 23)) << 3      # G/R/S headroom
    sig_b = ((ub & 0x7FFFFF) | (1 << 23)) << 3
    _store_bits(sub, R_SA, sig_a, 27, cols)
    _store_bits(sub, R_SB_RAW, sig_b, 27, cols)
    sub.tally = type(sub.tally)()                   # count the ADD only

    # 1) exponent difference d = ea - eb (two's complement ripple, Ne bits)
    _ripple_add(sub, R_EA, R_EB, R_D, NE, cols, CACHE, invert_y=True,
                cin=1)
    d = _read_value(sub, R_D, NE, cols)

    # 2) the 'search' (Fig. 4a): probe the stored exponent-difference
    #    against each candidate shift pattern — the paper charges
    #    2*(Nm+2) search cycles for the two-operand probe sweep.
    for probe in range(NM + 2):
        pattern = np.array([(probe >> k) & 1 for k in range(NE)], np.int8)
        sub.search(R_D, cols, np.full(n, pattern[0], np.int8))
        sub.search(R_D + 1, cols, np.full(n, pattern[1], np.int8))

    # 3) flexible multi-bit shift of sig_b by d (O(Nm): one read+write per
    #    destination bit row, regardless of the shift amount — the 1T-1R
    #    capability the paper contrasts with FloatPIM's O(Nm^2))
    dd = np.minimum(d, 27)
    for k in range(27):
        src_bit = np.zeros(n, np.int8)
        idx = k + dd
        sel = idx < 27
        # row-parallel read of the (per-lane) source bit: emulated as one
        # read event over the diagonal source row set
        vals = np.zeros(n, np.int8)
        for shift in np.unique(dd):
            lanes = (dd == shift) & sel
            if lanes.any() and k + shift < 27:
                vals[lanes] = sub.state[R_SB_RAW + k + int(shift), lanes]
        sub.tally.read_events += 1
        sub.tally.cells_read += n
        sub.write_row(R_SB + k, cols, np.where(sel, vals, src_bit),
                      "store")

    # 4) significand addition: 27-bit ripple of proposed FAs
    carry = _ripple_add(sub, R_SA, R_SB, R_SUM, 27, cols, CACHE)

    # 5) normalization: if carry, shift right one (read+write sweep)
    ssum = _read_value(sub, R_SUM, 27, cols) | (carry.astype(np.int64) << 27)
    e_res = ea + (ssum >> 27)
    ssum = np.where(ssum >> 27, ssum >> 1, ssum)
    sub.tally.read_events += 1
    sub.tally.write_events += 1
    sub.tally.cells_read += n
    sub.tally.cells_written += n

    mant = (ssum >> 3) & 0x7FFFFF                   # truncate G/R/S
    out = (((ua >> 31) << 31) | (e_res << 23) | mant).astype(np.uint32)
    return out.view(np.float32), sub.tally
