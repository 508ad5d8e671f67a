"""The port's KV quantization grids against ``repro.core.quant``.

Same inputs on both sides: 2^20 float32 bit patterns drawn with numpy
from a seed (so every exponent, subnormals, infinities and NaNs occur),
and the edges of each grid — RNE ties at the grid's half-ulp, the carry
1.11…1 → 10.0…0, values around qmax and 2^emin, ±0, float32 subnormals,
±inf and NaN. Results must be bit-equal. NaNs are compared as NaN and not
by payload in one place only: a vector holding a NaN gets a NaN scale in
both packages, but torch's ``amax`` does not carry the NaN's payload
bits through as XLA's reduction does, so the codes of such a vector are
held to dequantizing to NaN on both sides instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fp as ref_fp
from repro.core import quant as ref_q
from repro_torch.core import fp
from repro_torch.core import quant

GRIDS = ("fp32", "fp16", "int8", "fp8_e4m3", "fp8_e5m2", "fp8")
FLOAT_GRIDS = ("fp16", "fp8_e4m3", "fp8_e5m2", "fp8")


def _sweep(seed: int = 0, n: int = 1 << 20) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return bits.view(np.float32)


def _f32(*values) -> np.ndarray:
    return np.asarray(values, np.float64).astype(np.float32)


def _edges(name: str) -> np.ndarray:
    """Inputs on each side of every rounding decision of the grid."""
    s = ref_q.spec(name)
    specials = np.array([0x00000000, 0x80000000, 0x00000001, 0x807FFFFF,
                         0x00400000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00001, 0x7F800001, 0x7F7FFFFF, 0xFF7FFFFF,
                         0x00800000, 0x80800000], np.uint32).view(np.float32)
    vals = [specials]
    if s.kind == "int":
        k = np.arange(-130, 131, dtype=np.float32)
        vals += [k, k + 0.5, k - 0.5, np.nextafter(k + 0.5, np.inf),
                 np.nextafter(k + 0.5, -np.inf)]
    elif s.name != "fp32":
        drop = ref_fp.N_MANT - s.n_mant
        ulp_bits = 1 << drop
        # every binade of the grid and one past each end
        exps = np.arange(s.emin - 2, s.emax + 2)
        for e in exps:
            base = np.uint32((int(e) + ref_fp.BIAS) << ref_fp.N_MANT)
            mants = np.arange(0, 1 << s.n_mant, dtype=np.uint32) * ulp_bits
            for off in (0, ulp_bits // 2 - 1, ulp_bits // 2,
                        ulp_bits // 2 + 1, ulp_bits - 1):
                m = (mants + np.uint32(off)) & np.uint32(0x7FFFFF)
                b = base | m
                vals += [b.view(np.float32), (b | np.uint32(1 << 31)
                                              ).view(np.float32)]
        qmax = np.float32(s.qmax)
        half = np.float32(2.0 ** (s.emax - s.n_mant - 1))
        vals.append(_f32(qmax, np.nextafter(qmax, np.inf), qmax + half,
                         np.nextafter(qmax + half, 0), qmax + 2 * half,
                         -qmax - half, 2.0 ** s.emin,
                         np.nextafter(np.float32(2.0 ** s.emin), 0),
                         2.0 ** (s.emin - 1), -(2.0 ** s.emin)))
    return np.concatenate([np.ravel(v) for v in vals]).astype(np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def assert_bit_equal(got: torch.Tensor, want, *, nan_as_nan=False):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype.itemsize == want.dtype.itemsize, (got.dtype, want.dtype)
    assert got.shape == want.shape
    bad = _bits(got) != _bits(want)
    if nan_as_nan:
        bad &= ~(np.isnan(got) & np.isnan(want))
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} differ; first "
                           f"inputs at {np.argwhere(bad)[:5].tolist()}")


def test_unpack_pack_f32_bit_equal():
    x = _sweep(1, 1 << 16)
    ref = ref_fp.unpack_f32(jnp.asarray(x))
    got = fp.unpack_f32(torch.from_numpy(x))
    for g, r in zip(got[1:], ref[1:]):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert np.array_equal(_bits(got[0].numpy()), np.asarray(ref[0]))
    assert_bit_equal(fp.pack_f32(*got[1:]), ref_fp.pack_f32(*ref[1:]))


def test_spec_registry_matches_reference():
    assert quant.dtype_names() == ref_q.dtype_names()
    for name in GRIDS:
        s, r = quant.spec(name), ref_q.spec(name)
        assert ((s.name, s.n_bits, s.n_mant, s.n_exp)
                == (r.name, r.n_bits, r.n_mant, r.n_exp))
        for prop in ("kind", "qmax", "inv_qmax"):
            assert getattr(s, prop) == getattr(r, prop), (name, prop)
        if s.kind == "float":
            for prop in ("bias", "emax", "emin"):
                assert getattr(s, prop) == getattr(r, prop), (name, prop)
    with pytest.raises(ValueError, match="unknown"):
        quant.spec("int7")


@pytest.mark.parametrize("name", GRIDS)
def test_round_to_grid_bit_equal_on_sweep(name):
    x = _sweep()
    assert_bit_equal(quant.round_to_grid(torch.from_numpy(x), name),
                     ref_q.round_to_grid(jnp.asarray(x), name))


@pytest.mark.parametrize("name", GRIDS)
def test_round_to_grid_bit_equal_on_edges(name):
    x = _edges(name)
    got = quant.round_to_grid(torch.from_numpy(x), name)
    assert_bit_equal(got, ref_q.round_to_grid(jnp.asarray(x), name))
    s = quant.spec(name)
    if s.kind == "float" and s.name != "fp32":
        # the rounding really was exercised: ties went both ways, values
        # saturated and flushed
        out = got.numpy()
        assert (np.abs(out) == np.float32(s.qmax)).any()
        assert (out == 0).sum() > 4
        assert len(np.unique(out[np.isfinite(out)])) > 2 << s.n_mant


@pytest.mark.parametrize("name", FLOAT_GRIDS)
def test_encode_decode_float_bit_equal(name):
    s = quant.spec(name)
    # every code of the grid
    codes = np.arange(1 << s.n_bits).astype(
        np.uint8 if s.n_bits <= 8 else np.uint16)
    port_codes = torch.from_numpy(
        codes.view(np.int16) if s.n_bits > 8 else codes)
    assert_bit_equal(quant.decode_float(port_codes, name),
                     ref_q.decode_float(jnp.asarray(codes), name))
    # encode: on-grid values of the sweep and the edges, and the raw
    # (off-grid) patterns as well
    x = np.concatenate([_sweep(2), _edges(name)])
    on_grid = np.array(ref_q.round_to_grid(jnp.asarray(x), name))
    for v in (on_grid, x):
        got = quant.encode_float(torch.from_numpy(v), name)
        assert got.dtype == quant.code_dtype(name)
        assert_bit_equal(got, ref_q.encode_float(jnp.asarray(v), name))
    # round trip on the grid's finite values
    finite = on_grid[np.isfinite(on_grid)]
    back = quant.decode_float(quant.encode_float(torch.from_numpy(finite),
                                                 name), name)
    assert np.array_equal(back.numpy(), np.where(finite == 0, 0, finite))


@pytest.mark.parametrize("name", GRIDS)
def test_quantize_dequantize_kv_bit_equal(name):
    rng = np.random.default_rng(3)
    normal = (rng.standard_normal((4096, 128)) * 3).astype(np.float32)
    normal[0] = 0.0                          # an all-zero vector
    normal[1, :] = 1e-30                     # below the scale floor
    for x in (_sweep(4).reshape(-1, 16), normal,
              np.resize(_edges(name), (64, 16))):
        codes, scale = quant.quantize_kv(torch.from_numpy(x), name)
        rc, rs = ref_q.quantize_kv(jnp.asarray(x), name)
        assert codes.dtype == quant.code_dtype(name)
        assert tuple(scale.shape) == x.shape[:-1] + (1,)
        assert_bit_equal(scale, rs, nan_as_nan=True)
        nan_rows = np.isnan(np.asarray(rs))[:, 0]
        assert_bit_equal(codes[~nan_rows], np.asarray(rc)[~nan_rows])
        dq = quant.dequantize_kv(codes, scale, name)
        want = ref_q.dequantize_kv(rc, rs, name)
        assert_bit_equal(dq, want, nan_as_nan=True)
        assert np.isnan(dq.numpy()[nan_rows]).all()
        if name != "fp32":
            # the port decodes the reference's own codes alike
            rc_t = torch.from_numpy(np.asarray(rc).view(
                np.int16) if quant.code_dtype(name) == torch.int16
                else np.asarray(rc))
            assert_bit_equal(quant.dequantize_kv(rc_t, scale, name), want,
                             nan_as_nan=True)


@pytest.mark.parametrize("name", GRIDS)
def test_code_dtype_and_error_budgets_match_reference(name):
    want = np.dtype(ref_q.code_dtype(name))
    got = quant.code_dtype(name)
    # the fp16 grid's uint16 codes are held as int16: same width and bits
    assert torch.empty(0, dtype=got).element_size() == want.itemsize
    assert (got == torch.int16) == (want == np.uint16)
    assert quant.layer_error_budget(name) == ref_q.layer_error_budget(name)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 32)) * 2).astype(np.float32)
    scale = np.abs(rng.standard_normal((64, 1))).astype(np.float32) + 0.1
    assert_bit_equal(
        quant.error_bound(torch.from_numpy(x), name, torch.from_numpy(scale)),
        ref_q.error_bound(jnp.asarray(x), name, jnp.asarray(scale)))
    # and the bound holds for the port's own round trip
    codes, sc = quant.quantize_kv(torch.from_numpy(x), name)
    err = (quant.dequantize_kv(codes, sc, name) - torch.from_numpy(x)).abs()
    assert bool((err <= quant.error_bound(torch.from_numpy(x), name,
                                          sc)).all())
