"""K8's shift-and-add steps, emulated in numpy on the CPU.

The CUDA kernel (``csrc/pim_fp.cu``) computes the 48-bit significand
product with a right-shifting accumulator: step i adds sig_a into hi where
bit i of sig_b is set, then shifts (hi, lo) right by one, the bit leaving
hi entering lo, with lo kept top-aligned in 32 bits; it then normalizes
and rounds with funnel shifts; an input with exponent field 0 or 255
takes the native product of the DAZ'd inputs instead.
The emulation below writes those steps down in uint64 arithmetic, masked
to 32 bits where the kernel's registers are, and is held bit for bit,
NaN as NaN, against:

* the exact product's halves, P >> 24 and P & 0xFFFFFF, and the limbs
  of the reference's left-shifting loop (lo += bit * (sig_a << i), carry
  into hi), after every input pair's 24 steps, with hi < 2^24 after each
  step;
* the port's plain version ``ref.pim_fp32_mul_ref`` and the reference's
  Pallas ``pim_fp32_mul`` in interpret mode, on 2^16 random bit patterns,
  every exponent class (0: zeros and subnormals, 255: inf and NaN), the
  reference's edge table, subnormal products and products rounding across
  2^-126.

What this file cannot see: no line of the CUDA kernel runs here (on the
CPU the wrapper returns the plain version). ``chip_smoke.py`` holds the
kernel itself on the card against the plain version, the bit-plane
``core.fp.fp32_mul_pim`` and ``torch.mul``, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pim_fp import pim_fp32_mul as pallas_k8
from repro_torch.kernels.ref import pim_fp32_mul_ref

M23, M24, M32 = 0x7FFFFF, 0xFFFFFF, 0xFFFFFFFF
SIGN = 0x80000000
N_RANDOM = 1 << 16


def _fields(x):
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return u, (u >> 23) & 0xFF, (u & M23) | (1 << 23)


def right_shift_limbs(sig_a, sig_b):
    """The kernel's 24 steps: (hi, lo top-aligned in 32 bits)."""
    hi = np.zeros_like(sig_a)
    lo = np.zeros_like(sig_a)
    for i in range(24):
        hi = np.where((sig_b >> i) & 1, hi + sig_a, hi)
        lo = ((lo >> 1) | ((hi & 1) << 31)) & M32     # __funnelshift_r
        hi = hi >> 1
        assert (hi < 1 << 24).all()
    return hi, lo


def left_shift_limbs(sig_a, sig_b):
    """The reference's 24 steps (``_pim_fp32_mul_kernel``): (hi, lo)."""
    hi = np.zeros_like(sig_a)
    lo = np.zeros_like(sig_a)
    for i in range(24):
        bit = (sig_b >> i) & 1
        lo = lo + bit * ((sig_a & ((1 << (24 - i)) - 1)) << i)
        hi = hi + bit * (sig_a >> (24 - i))
        hi = hi + (lo >> 24)
        lo = lo & M24
    return hi, lo


def emulate(a, b):
    """K8's body, element by element, in numpy: float32 out."""
    ua, ea, sig_a = _fields(a)
    ub, eb, sig_b = _fields(b)
    special = ((ea - 1) & M32 >= 254) | ((eb - 1) & M32 >= 254)
    hi, lo = right_shift_limbs(sig_a, sig_b)
    top = hi >> 23
    sh = top ^ 1
    keep = ((hi << sh) | (lo >> (32 - sh))) & M32      # __funnelshift_l
    rest = (lo << sh) & M32
    guard = rest >> 31
    sticky = (((rest << 1) & M32) != 0).astype(np.uint64)
    keep = keep + (guard & (sticky | (keep & 1)))
    round_ovf = keep >> 24
    keep = keep >> round_ovf
    e = ea.astype(np.int64) + eb.astype(np.int64) - 127 + (
        top + round_ovf).astype(np.int64)
    sign = (ua ^ ub) & SIGN
    bits = np.where(e <= 0, sign,
                    np.where(e >= 255, sign | 0x7F800000,
                             sign | (np.clip(e, 0, 255).astype(np.uint64)
                                     << 23) | (keep & M23)))
    na = np.where(special, np.where(ea != 0, ua, ua & SIGN), 0)
    nb = np.where(special, np.where(eb != 0, ub, ub & SIGN), 0)
    with np.errstate(all="ignore"):
        native = (na.astype(np.uint32).view(np.float32)
                  * nb.astype(np.uint32).view(np.float32))
    return np.where(special, native,
                    bits.astype(np.uint32).view(np.float32))


def _same(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))


def _bits(rng, n, exp=None):
    u = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    if exp is not None:
        u = (u & np.uint32(0x807FFFFF)) | (np.uint32(exp) << np.uint32(23))
    return u.view(np.float32)


def _edge_table():
    a = np.array([1e30, 1e30, 1e-30, 1.0, -0.0, np.inf, 1.5, 3.0,
                  1 + 2 ** -23], np.float32)
    b = np.array([1e30, -1e30, 1e-30, 0.0, 2.0, 2.0, 1.5, 1 + 2 ** -23,
                  1 + 2 ** -23], np.float32)
    return a, b


def _subnormal_products(rng, n):
    a = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-100, -27, n)
         ).astype(np.float32)
    b = (2.0 ** rng.uniform(-150, -126, n) / a.astype(np.float64)
         ).astype(np.float32)
    return a, b


def _around_least_normal(rng, n):
    a = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-100, -27, n)
         ).astype(np.float32)
    b = (2.0 ** -126 / a.astype(np.float64)).astype(np.float32)
    b = (b.view(np.uint32).astype(np.int64) + rng.integers(-3, 4, n)
         ).astype(np.uint32).view(np.float32)
    return a, b


def _cases():
    rng = np.random.default_rng(19)
    yield "random bits", (_bits(rng, N_RANDOM), _bits(rng, N_RANDOM))
    for exp in (0, 1, 126, 127, 254, 255):
        a, b = _bits(rng, 2048, exp), _bits(rng, 2048)
        yield f"exponent {exp}", (np.concatenate([a, b]),
                                  np.concatenate([b, a]))
    yield "edge table", _edge_table()
    yield "subnormal products", _subnormal_products(rng, 4096)
    yield "around 2^-126", _around_least_normal(rng, 2048)


CASES = dict(_cases())


def test_limbs_are_the_exact_product_and_the_reference_loops():
    rng = np.random.default_rng(20)
    a, b = _bits(rng, N_RANDOM), _bits(rng, N_RANDOM)
    _, _, sig_a = _fields(a)
    _, _, sig_b = _fields(b)
    hi, lo = right_shift_limbs(sig_a, sig_b)
    assert not (lo & 0xFF).any()             # lo's limb is bits 8..31
    lo24 = lo >> 8
    exact = sig_a * sig_b                    # < 2^48: exact in uint64
    np.testing.assert_array_equal(hi, exact >> 24)
    np.testing.assert_array_equal(lo24, exact & M24)
    ref_hi, ref_lo = left_shift_limbs(sig_a, sig_b)
    np.testing.assert_array_equal(hi, ref_hi)
    np.testing.assert_array_equal(lo24, ref_lo)


@pytest.mark.parametrize("case", list(CASES))
def test_steps_equal_plain_version_and_pallas(case):
    a, b = CASES[case]
    got = emulate(a, b)
    plain = pim_fp32_mul_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert _same(got, plain.numpy()).all()
    pallas = np.asarray(pallas_k8(jnp.asarray(a), jnp.asarray(b)))
    assert _same(got, pallas).all()


def test_steps_equal_ieee_where_the_product_is_normal():
    """Normal x normal pairs whose exact product is normal and finite:
    the steps, the rounding and the exponent give IEEE's product, which
    ``chip_smoke.py`` holds the kernel to against ``torch.mul``."""
    rng = np.random.default_rng(21)
    a = _bits(rng, N_RANDOM, 127)
    b = (_bits(rng, N_RANDOM, 127).view(np.uint32)
         + (rng.integers(-100, 100, N_RANDOM) << 23).astype(np.uint32)
         ).view(np.float32)
    exact = np.abs(a.astype(np.float64) * b)
    normal = (exact >= 2.0 ** -126) & (exact < np.finfo(np.float32).max)
    assert normal.all()
    assert _same(emulate(a, b), a * b).all()
