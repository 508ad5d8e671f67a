"""The port's bit-serial float32 multiply (K8) against the reference.

Twins of ``tests/test_kernels.py``'s ``pim_fp32_mul`` tests, and beyond
them: the port's ``pim_fp32_mul`` (on CPU tensors, its plain version
``pim_fp32_mul_ref``) equals the reference's Pallas kernel in interpret
mode bit for bit, NaN compared as NaN, on random values, random bit
patterns over every exponent, the reference's edge table, subnormal
inputs, products whose exact value is subnormal or rounds across 2^-126,
and inf × subnormal — the reference's DAZ/FTZ contract under XLA, which
IEEE does not give there. It also equals the port's bit-plane
``core.fp.fp32_mul_pim``. Inputs are numpy-seeded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pim_fp import pim_fp32_mul as pallas_k8
from repro_torch.core import fp
from repro_torch.kernels import pim_fp32_mul, pim_fp32_mul_ref

TINY = np.float32(2.0 ** -126)      # the least normal float32


def _same(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))


def _port(a, b):
    return pim_fp32_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _reference(a, b, block=1024):
    return np.asarray(pallas_k8(jnp.asarray(a), jnp.asarray(b), block=block))


def _bits(rng, n, exp=None):
    u = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    if exp is not None:
        u = (u & np.uint32(0x807FFFFF)) | (np.uint32(exp) << np.uint32(23))
    return u.view(np.float32)


def _subnormal_result_pairs(rng, n):
    """Normal pairs whose exact product lies in [2^-150, 2^-126): the
    reference flushes them to signed zeros."""
    a = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-100, -27, n)
         ).astype(np.float32)
    target = 2.0 ** rng.uniform(-150, -126, n)
    b = (target / a.astype(np.float64)).astype(np.float32)
    sign = rng.choice(np.array([-1, 1], np.float32), n)
    return a * sign, b


def _around_least_normal_pairs(rng, n):
    """Normal pairs whose exact product is within a few ulps of 2^-126:
    rounding decides whether the result is the least normal or a
    flushed zero."""
    a = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-100, -27, n)
         ).astype(np.float32)
    b = (2.0 ** -126 / a.astype(np.float64)).astype(np.float32)
    step = rng.integers(-3, 4, n)          # ulps away from the quotient
    b = (b.view(np.uint32).astype(np.int64) + step).astype(np.uint32)
    return a, b.view(np.float32)


def test_random_values_bitexact_vs_kernel_and_ieee(rng):
    a = (rng.standard_normal(8192) * np.exp(rng.uniform(-30, 30, 8192))
         ).astype(np.float32)
    b = (rng.standard_normal(8192) * np.exp(rng.uniform(-30, 30, 8192))
         ).astype(np.float32)
    got = _port(a, b)
    assert _same(got, _reference(a, b)).all()
    assert _same(got, a * b).all()


def test_random_bit_patterns_bitexact_vs_kernel():
    rng = np.random.default_rng(5)
    a, b = _bits(rng, 8192), _bits(rng, 8192)
    assert _same(_port(a, b), _reference(a, b)).all()


@pytest.mark.parametrize("exp", [0, 1, 126, 127, 254, 255])
def test_every_exponent_class_bitexact_vs_kernel(exp):
    """One operand at a fixed exponent field (0: zeros and subnormals,
    255: inf and NaN), the other random bits."""
    rng = np.random.default_rng(exp)
    a, b = _bits(rng, 2048, exp), _bits(rng, 2048)
    assert _same(_port(a, b), _reference(a, b)).all()
    assert _same(_port(b, a), _reference(b, a)).all()


def test_edges_table():
    a = np.array([1e30, 1e30, 1e-30, 1.0, -0.0, np.inf, 1.5, 3.0,
                  1 + 2 ** -23], np.float32)
    b = np.array([1e30, -1e30, 1e-30, 0.0, 2.0, 2.0, 1.5, 1 + 2 ** -23,
                  1 + 2 ** -23], np.float32)
    got = _port(a, b)
    with np.errstate(over="ignore"):
        want = a * b
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _reference(a, b, block=16).view(np.uint32))


def test_subnormal_inputs_read_as_signed_zeros():
    """DAZ: a subnormal operand is a signed zero — including against inf
    (NaN, where IEEE gives inf) and against a huge normal (a signed zero,
    where IEEE gives a normal)."""
    sub = np.array([1e-40, -1e-40, 2 ** -149, -(2 ** -127), 1e-39],
                   np.float32)
    other = np.array([1e10, -5.0, np.inf, -np.inf, np.nan], np.float32)
    a = np.repeat(sub, other.size)
    b = np.tile(other, sub.size)
    got = _port(a, b)
    assert _same(got, _reference(a, b)).all()
    assert _same(_port(b, a), _reference(b, a)).all()
    with np.errstate(invalid="ignore"):
        daz = np.where(np.abs(a) < TINY, np.copysign(np.float32(0), a), a)
        assert _same(got, daz * b).all()
    assert np.isnan(got[np.isinf(b)]).all()       # 0 x inf


def test_subnormal_products_flush_to_signed_zeros():
    rng = np.random.default_rng(7)
    a, b = _subnormal_result_pairs(rng, 4096)
    got = _port(a, b)
    assert _same(got, _reference(a, b)).all()
    flushed = np.abs(a.astype(np.float64) * b) < 2.0 ** -126 * (1 - 2 ** -25)
    assert flushed.sum() > 3000
    np.testing.assert_array_equal(got[flushed].view(np.uint32),
                                  (np.signbit(a[flushed] * b[flushed])
                                   .astype(np.uint32) << 31))


def test_products_rounding_across_least_normal():
    rng = np.random.default_rng(8)
    a, b = _around_least_normal_pairs(rng, 2048)
    got = _port(a, b)
    assert _same(got, _reference(a, b)).all()
    # both sides of the boundary occur: flushed zeros and 2^-126 itself
    assert (got == 0).any() and (got == TINY).any()
    # IEEE where the exact product is normal; just below 2^-126 IEEE
    # rounds at the subnormal ulp and may reach 2^-126, where the
    # procedure rounds at 24 bits and flushes
    exact = a.astype(np.float64) * b
    normal = exact >= 2.0 ** -126
    assert _same(got[normal], (a * b)[normal]).all()
    assert ((a * b == TINY) & (got == 0)).any()


def test_equals_bit_plane_procedure():
    """K8 == ``core.fp.fp32_mul_pim``, the port's bit-plane twin (64
    lanes: the bit-plane procedure is slow on the CPU)."""
    rng = np.random.default_rng(9)
    pairs = [(_bits(rng, 32), _bits(rng, 32)),
             _subnormal_result_pairs(rng, 16),
             _around_least_normal_pairs(rng, 16)]
    a, b = (np.concatenate(side) for side in zip(*pairs))
    want = fp.fp32_mul_pim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _same(_port(a, b), want).all()


def test_shape_block_and_contract():
    rng = np.random.default_rng(10)
    a = torch.from_numpy(_bits(rng, 7 * 130).reshape(7, 130))
    b = torch.from_numpy(_bits(rng, 7 * 130).reshape(7, 130))
    got = pim_fp32_mul(a, b, block=128)
    assert got.shape == (7, 130) and got.dtype == torch.float32
    assert _same(got.numpy(), pim_fp32_mul(a, b, block=16).numpy()).all()
    assert _same(got.numpy(), pim_fp32_mul_ref(a, b).numpy()).all()
    with pytest.raises(ValueError, match="differ"):
        pim_fp32_mul(a, b[:3])
    with pytest.raises(TypeError, match="float32"):
        pim_fp32_mul(a.double(), b.double())
    with pytest.raises(ValueError, match="forward only"):
        pim_fp32_mul(a.clone().requires_grad_(True), b)
