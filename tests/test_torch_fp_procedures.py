"""The port's bit-level FP procedures (paper §3.3, Figs. 3–5) against the
reference.

Twins of ``tests/test_fp_bitexact.py`` (hypothesis property tests over
normal-range float32 pairs), ``tests/test_logic_fa.py`` and
``tests/test_cost_model.py::test_executable_fp_add_procedure``, on the
port's ``core.fp`` (torch bit planes), ``core.logic`` (torch),
``core.fulladder``, ``core.subarray`` and ``core.fp_procedure`` (numpy
copies). Beyond the IEEE checks the reference makes, every lane is held
bit for bit against the reference's own procedure (NaN as NaN), subnormal
inputs included: the reference's contract under XLA is DAZ/FTZ.
"""

import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import fp as ref_fp
from repro.core.fp_procedure import subarray_fp32_add as ref_subarray_add
from repro_torch.core import fp, fulladder, logic
from repro_torch.core.fp_procedure import subarray_fp32_add
from repro_torch.core.subarray import Subarray

# float32 bit patterns restricted to normal range and away from
# overflow/subnormal-result territory for add/mul closure (the
# reference's own bounds)
_EXP_LO, _EXP_HI = 40, 215


def _floats(n, lo=_EXP_LO, hi=_EXP_HI):
    return st.lists(
        st.tuples(st.integers(0, 1), st.integers(lo, hi),
                  st.integers(0, 2 ** 23 - 1)),
        min_size=n, max_size=n)


def _pack(trips):
    u = np.array([(s << 31) | (e << 23) | m for s, e, m in trips],
                 np.uint32)
    return u.view(np.float32)


def _same(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _add(a, b):
    return fp.fp32_add_pim(_t(a), _t(b)).numpy()


def _mul(a, b):
    return fp.fp32_mul_pim(_t(a), _t(b)).numpy()


# ---------------------------------------------------------------------------
# tests/test_fp_bitexact.py twins
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(_floats(32), _floats(32))
def test_fp_add_bitexact(ta, tb):
    a, b = _pack(ta), _pack(tb)
    got = _add(a, b)
    want = a + b
    ok = (want == 0) | (np.abs(want) >= np.float32(2 ** -126))
    np.testing.assert_array_equal(got.view(np.uint32)[ok],
                                  want.view(np.uint32)[ok])
    assert _same(got, ref_fp.fp32_add_pim(a, b)).all()


@settings(max_examples=60, deadline=None)
@given(_floats(32), _floats(32))
def test_fp_mul_bitexact(ta, tb):
    a, b = _pack(ta), _pack(tb)
    got = _mul(a, b)
    with np.errstate(over="ignore"):
        want = a * b
    ok = ((want == 0) | (np.abs(want) >= np.float32(2 ** -126))) \
        & np.isfinite(want)
    np.testing.assert_array_equal(got.view(np.uint32)[ok],
                                  want.view(np.uint32)[ok])
    assert _same(got, ref_fp.fp32_mul_pim(a, b)).all()


@settings(max_examples=20, deadline=None)
@given(_floats(32, 0, 255), _floats(32, 0, 255))
def test_every_exponent_bitexact_vs_reference(ta, tb):
    """Every exponent field, 0 (zeros, subnormals) and 255 (inf, NaN)
    included: the port's add and mul equal the reference's lane for lane
    (the FTZ'd subnormal results and DAZ'd subnormal inputs too)."""
    a, b = _pack(ta), _pack(tb)
    assert _same(_add(a, b), ref_fp.fp32_add_pim(a, b)).all()
    assert _same(_mul(a, b), ref_fp.fp32_mul_pim(a, b)).all()


def test_subnormal_inputs_daz_bitexact_vs_reference():
    """Subnormal operands read as signed zeros in the native branches:
    ``1e-40 * inf`` is NaN, ``1e-40 * 1e10`` a zero, ``1e-40 + 1e-40`` a
    zero — where torch's IEEE ops give inf, 1e-30 and 2e-40."""
    sub = np.array([1e-40, -1e-40, 2 ** -149, -(2 ** -127)], np.float32)
    other = np.array([1e10, -5.0, 1.0, 1e-40, -1e-40, 0.0, -0.0, np.inf,
                      -np.inf, np.nan], np.float32)
    a = np.repeat(sub, other.size)
    b = np.tile(other, sub.size)
    for x, y in ((a, b), (b, a)):
        assert _same(_add(x, y), ref_fp.fp32_add_pim(x, y)).all()
        assert _same(_mul(x, y), ref_fp.fp32_mul_pim(x, y)).all()
    assert np.isnan(_mul(np.float32([1e-40]), np.float32([np.inf]))).all()
    assert _mul(np.float32([1e-40]), np.float32([1e10]))[0] == 0
    assert _add(np.float32([1e-40]), np.float32([1e-40]))[0] == 0


def test_add_edge_cases():
    a = np.array([1.0, 1.0, -1.0, 1.5, 1e38, -1e38, 0.0, -0.0, 1.0,
                  np.inf, -np.inf, np.nan], np.float32)
    b = np.array([-(1.0 + 2 ** -23), -1.0, 1.0 + 2 ** -23, 1.5, 3e38,
                  -3e38, 0.0, -0.0, -0.0, 1.0, np.inf, 1.0], np.float32)
    got = _add(a, b)
    with np.errstate(over="ignore", invalid="ignore"):
        want = a + b
    assert _same(got, want).all(), (got, want)
    assert _same(got, ref_fp.fp32_add_pim(a, b)).all()


def test_mul_overflow_underflow_inf_nan():
    a = np.array([1e30, 1e30, 1e-30, -1e30, np.inf, 0.0, np.nan],
                 np.float32)
    b = np.array([1e30, -1e30, 1e-30, 1e-30, 2.0, 5.0, 1.0], np.float32)
    got = _mul(a, b)
    with np.errstate(over="ignore"):
        want = a * b
    assert _same(got, want).all(), (got, want)
    assert _same(got, ref_fp.fp32_mul_pim(a, b)).all()


def test_rne_tie_rounding():
    """Exact ties must round to even (the G=1, R=S=0 branch)."""
    a = np.float32(1 + 2 ** -23)
    bs = np.array([1.5, 1 + 2 ** -23, 1 + 2 ** -22, 1.25], np.float32)
    got = _mul(np.full_like(bs, a), bs)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  (a * bs).view(np.uint32))


def test_exponent_alignment_all_shifts():
    """Alignment over every shift distance 0..30 (flexible multi-bit shift
    — the O(Nm) method)."""
    a = np.repeat(np.float32(1.7312543), 31)
    b = (np.float32(1.3991) * (2.0 ** -np.arange(31))).astype(np.float32)
    for x, y in ((a, b), (a, -b)):
        np.testing.assert_array_equal(_add(x, y).view(np.uint32),
                                      (x + y).view(np.uint32))


def test_mac_and_pim_dot():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    got = float(fp.pim_dot(_t(a), _t(b)))
    # sequential-MAC ordering == numpy sequential accumulation
    want = np.float32(0)
    for x, y in zip(a, b):
        want = np.float32(want + np.float32(x * y))
    assert got == float(want) == float(ref_fp.pim_dot(a, b))
    acc = rng.standard_normal(16).astype(np.float32)
    mac = fp.fp32_mac_pim(_t(a), _t(b), _t(acc)).numpy()
    np.testing.assert_array_equal(mac.view(np.uint32),
                                  (acc + a * b).view(np.uint32))


def test_pim_add_ripple_widths():
    """The FA-based ripple adder across widths (property: equals int add)."""
    rng = np.random.default_rng(2)
    for n in (4, 8, 17, 32):
        x = rng.integers(0, 2 ** (n - 1), 64).astype(np.uint32)
        y = rng.integers(0, 2 ** (n - 1), 64).astype(np.uint32)
        xb = fp.u32_to_bits(torch.from_numpy(x), n)
        yb = fp.u32_to_bits(torch.from_numpy(y), n)
        np.testing.assert_array_equal(xb.numpy(),
                                      np.asarray(ref_fp.u32_to_bits(x, n)))
        s, carry = fp.pim_add(xb, yb)
        got = fp.bits_to_u32(s).numpy() + (carry.numpy().astype(np.int64)
                                           << n)
        np.testing.assert_array_equal(got, x.astype(np.int64) + y)


def test_bit_plane_helpers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    k = rng.integers(0, 34, 64)
    bits = fp.u32_to_bits(torch.from_numpy(x), 32)
    rbits = ref_fp.u32_to_bits(x, 32)
    np.testing.assert_array_equal(fp.bits_to_u32(bits).numpy(),
                                  x.astype(np.int64))
    for got, want in (
            (fp.shift_right_sticky(bits, torch.from_numpy(k)),
             ref_fp.shift_right_sticky(rbits, k)),
            ((fp.shift_left(bits, torch.from_numpy(k)),),
             (ref_fp.shift_left(rbits, k),)),
            ((fp.msb_position(bits),), (ref_fp.msb_position(rbits),)),
            ((fp.pim_sub(bits, fp.u32_to_bits(torch.from_numpy(x // 3),
                                              32)),),
             (ref_fp.pim_sub(rbits, ref_fp.u32_to_bits(x // 3, 32)),))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# tests/test_logic_fa.py twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a", [0, 1])
@pytest.mark.parametrize("b", [0, 1])
def test_mtj_truth_tables(a, b):
    assert int(logic.mtj_and(a, b)) == (a & b)
    assert int(logic.mtj_or(a, b)) == (a | b)
    assert int(logic.mtj_xor(a, b)) == (a ^ b)
    assert int(logic.mtj_write(a, b, "store")) == a


def test_mtj_vectorized():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, 256).astype(np.int8)
    b = rng.integers(0, 2, 256).astype(np.int8)
    np.testing.assert_array_equal(np.asarray(logic.mtj_and(a, b)), a & b)
    np.testing.assert_array_equal(np.asarray(logic.mtj_or(a, b)), a | b)
    np.testing.assert_array_equal(np.asarray(logic.mtj_xor(a, b)), a ^ b)
    with pytest.raises(ValueError, match="unknown"):
        logic.mtj_write(a, b, "nand")


def test_proposed_fa_exhaustive_and_counts():
    """All 8 input cases: correct S/Z', 4 steps, 4 cache cells, operands
    preserved (the training requirement that rules out the [16] FA)."""
    for x, y, z in itertools.product([0, 1], repeat=3):
        sub = Subarray(rows=16, cols=4)
        cols = np.arange(4)
        sub.write_row(0, cols, np.full(4, x, np.int8), "store")
        sub.write_row(1, cols, np.full(4, y, np.int8), "store")
        sub.write_row(2, cols, np.full(4, z, np.int8), "store")
        sub.tally = type(sub.tally)()  # reset counting after setup
        r = fulladder.proposed_fa(sub, 0, 1, 2, (4, 5, 6, 7), cols)
        assert (r.s == x ^ y ^ z).all(), (x, y, z)
        assert (r.carry == (x & y) | (z & (x ^ y))).all(), (x, y, z)
        assert r.tally.steps == fulladder.PROPOSED_FA_STEPS == 4
        assert (sub.state[0] == x).all()
        assert (sub.state[1] == y).all()
        assert (sub.state[2] == z).all()
    assert fulladder.PROPOSED_FA_CELLS == 4
    assert fulladder.FLOATPIM_FA_STEPS == 13
    assert fulladder.FLOATPIM_FA_CELLS == 12


def test_floatpim_fa_function():
    for x, y, z in itertools.product([0, 1], repeat=3):
        s, c, steps, cells = fulladder.floatpim_fa(x, y, z)
        assert s == x ^ y ^ z
        assert c == (x & y) | (z & (x ^ y))
        assert steps == 13 and cells == 12


def test_multibit_add_matches_integer_addition():
    rng = np.random.default_rng(1)
    n_bits, n_cols = 8, 16
    sub = Subarray(rows=64, cols=n_cols)
    cols = np.arange(n_cols)
    xs = rng.integers(0, 2 ** n_bits, n_cols)
    ys = rng.integers(0, 2 ** n_bits, n_cols)
    rows_x = list(range(0, n_bits))
    rows_y = list(range(n_bits, 2 * n_bits))
    for k in range(n_bits):
        sub.write_row(rows_x[k], cols, (xs >> k) & 1, "store")
        sub.write_row(rows_y[k], cols, (ys >> k) & 1, "store")
    out_bits, carry = fulladder.multibit_add(
        sub, rows_x, rows_y, n_bits, (40, 41, 42, 43, 44), cols)
    got = sum((out_bits[k].astype(np.int64) << k) for k in range(n_bits))
    got = got + (carry.astype(np.int64) << n_bits)
    np.testing.assert_array_equal(got, xs + ys)


def test_search_method():
    """Fig. 4a: SL-current search detects exact pattern match."""
    sub = Subarray(rows=4, cols=8)
    cols = np.arange(8)
    pattern = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int8)
    sub.write_row(2, cols, pattern, "store")
    assert sub.search(2, cols, pattern)
    assert not sub.search(2, cols, 1 - pattern)
    assert sub.tally.search_events == 2


# ---------------------------------------------------------------------------
# tests/test_cost_model.py::test_executable_fp_add_procedure twin
# ---------------------------------------------------------------------------


def test_executable_fp_add_procedure():
    """The §3.3 FP add executed on the subarray sim: value within 1 ulp
    (truncation path), search count == 2(Nm+2) exactly, read/write events
    within 2x of the closed-form coefficients; value and every tally equal
    to the reference's run."""
    rng = np.random.default_rng(0)
    a = np.abs(rng.standard_normal(32)).astype(np.float32) * 8 + 1
    b = np.minimum(np.abs(rng.standard_normal(32)).astype(np.float32),
                   a * 0.9).astype(np.float32)
    got, tally = subarray_fp32_add(a, b)
    want = a + b
    ulp = np.abs(got.view(np.uint32).astype(np.int64)
                 - want.view(np.uint32).astype(np.int64))
    assert ulp.max() <= 1
    assert tally.search_events == 2 * (23 + 2)
    assert tally.read_events < 2 * (1 + 7 * 8 + 7 * 23)
    assert tally.write_events < 2 * (7 * 8 + 7 * 23)
    ref_got, ref_tally = ref_subarray_add(a, b)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  ref_got.view(np.uint32))
    assert vars(tally) == vars(ref_tally)
