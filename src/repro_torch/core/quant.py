"""Storage grids of the quantized KV pool: the KV half of
``repro.core.quant``.

A grid is an ``(n_bits, nm, ne)`` shape (``spec``): ``fp32``, ``fp16``,
``int8`` (7 magnitude bits, ``ne=0``) and the fp8-style ``fp8_e4m3`` /
``fp8_e5m2``. The float grids are the reference's, not IEEE's or OCP's: a
code whose exponent field is 0 decodes to +0 (no subnormals), and the top
binade is finite (no inf or NaN codes), so ``fp8_e4m3``'s largest value is
480, not e4m3fn's 448. Hardware fp8 and half conversions do not compute
these grids; everything here is integer arithmetic on the float32 bit
pattern.

``round_to_grid`` is the same function as the reference's bit-plane
round-to-nearest-even (``repro/core/quant.py``: 23 mantissa planes and a
ripple increment), written as one integer add on the mantissa
(:func:`round_mantissa`): adding ``2^(drop-1) - 1`` plus the kept LSB and
truncating ``drop`` bits is RNE, and the carry out of the mantissa is
added to the exponent field as the reference's ``exp + carry``. The
results are bit-equal for every float32 input
(``tests/test_torch_quant.py``). The reference's graph prices its
``exp + carry`` and ``e_unb = exp_r - 127`` but none of its bit-plane
ops, so :func:`round_mantissa` is an op of its own (the mapper's capture
keeps it whole, unpriced) and the two field sums stay aten adds: the
mapper traces the reference's nodes here.

Storage: int8 codes for the int grid, uint8 ``sign|exp|mant`` codes for
the 8-bit float grids. The reference keeps fp16-grid codes in uint16;
torch has no ``index_put`` for uint16 on the CPU, and the pool is written
by index puts, so the port keeps the same 16 bits in an **int16** tensor
(``code_dtype``), and ``decode_float`` reads them back unsigned.

The weight half — ``quantize_axis``, the straight-through
``quantize_ste``, ``fake_quant``, ``layer_error`` and the blockwise 1-D
pack ``quantize_blockwise`` / ``dequantize_blockwise`` — does the
reference's arithmetic in its order: the scale is ``max(absmax *
inv_qmax, SCALE_FLOOR)`` (a multiply by the float32 reciprocal) and the
values ``round_to_grid(w / scale)`` with a correctly rounded division,
so codes and scales are bit-equal to the reference's on equal inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fp

# Scale floor: keeps all-zero vectors well-defined (q = 0, exact).
SCALE_FLOOR = 1e-20


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One storage grid: ``n_bits`` cells/value, (nm, ne) bit-serial shape."""

    name: str
    n_bits: int        # cells per stored value (row footprint)
    n_mant: int        # nm — mantissa bits (int grids: magnitude bits)
    n_exp: int         # ne — exponent bits; 0 => fixed-point integer grid

    @property
    def kind(self) -> str:
        return "int" if self.n_exp == 0 else "float"

    @property
    def bias(self) -> int:
        return (1 << (self.n_exp - 1)) - 1

    @property
    def emax(self) -> int:
        """Largest unbiased exponent (no inf/nan codes — we saturate)."""
        return (1 << self.n_exp) - 1 - self.bias

    @property
    def emin(self) -> int:
        """Smallest normal unbiased exponent (below it: flush to zero)."""
        return 1 - self.bias

    @property
    def qmax(self) -> float:
        """Largest representable magnitude on the grid."""
        if self.kind == "int":
            return float((1 << self.n_mant) - 1)
        return (2.0 - 2.0 ** (-self.n_mant)) * 2.0 ** self.emax

    @property
    def inv_qmax(self) -> float:
        """float32 reciprocal of ``qmax``: scales are ``amax * inv_qmax``,
        a multiply, as in the reference."""
        return float(np.float32(1.0) / np.float32(self.qmax))


DTYPES = {
    "fp32": QuantSpec("fp32", 32, 23, 8),
    "fp16": QuantSpec("fp16", 16, 10, 5),
    "int8": QuantSpec("int8", 8, 7, 0),
    "fp8_e4m3": QuantSpec("fp8_e4m3", 8, 3, 4),
    "fp8_e5m2": QuantSpec("fp8_e5m2", 8, 2, 5),
}
_ALIASES = {"fp8": "fp8_e4m3"}


def spec(dtype: str | QuantSpec) -> QuantSpec:
    """Resolve a dtype name (or pass a spec through)."""
    if isinstance(dtype, QuantSpec):
        return dtype
    s = DTYPES.get(_ALIASES.get(dtype, dtype))
    if s is None:
        raise ValueError(f"unknown weight dtype {dtype!r}; known: "
                         f"{sorted(DTYPES) + sorted(_ALIASES)}")
    return s


def dtype_names() -> list[str]:
    return sorted(DTYPES) + sorted(_ALIASES)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


# ---------------------------------------------------------------------------
# grid rounding and the packed float codes
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::round_mantissa", mutates_args=())
def round_mantissa(mant: torch.Tensor,
                   drop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Round a float32 mantissa field (int32, 23 bits) to nearest even at
    ``drop`` bits: ``(the rounded field, its low drop bits zero; the carry
    out of it, 0 or 1)``, both int32 — the reference's bit-plane ripple
    increment ``fp.pim_inc_at`` on the kept planes, whose boolean ops its
    graph does not price. An op of its own, so the mapper's capture keeps
    it whole (module docstring)."""
    m = mant.to(torch.int64)
    lsb = (m >> drop) & 1
    m = (m + ((1 << (drop - 1)) - 1) + lsb) >> drop
    return ((m << drop) & 0x7FFFFF).to(torch.int32), \
        (m >> (fp.N_MANT - drop)).to(torch.int32)


@round_mantissa.register_fake
def _round_mantissa_fake(mant, drop):
    return torch.empty_like(mant), torch.empty_like(mant)


def round_to_grid(x: torch.Tensor, dtype: str | QuantSpec) -> torch.Tensor:
    """Round float32 values to the dtype's grid (values stay float32).

    Float grids: RNE on the top ``nm`` mantissa bits, exponent clamped to
    [emin, emax] with flush-to-+0 below (float32 zeros and subnormals
    included) and saturation to ±qmax above; float32 NaN/Inf pass
    through unchanged. Int grids: round-to-nearest-even, then clip to
    ±qmax.
    """
    s = spec(dtype)
    x = _f32(x)
    if s.name == "fp32":
        return x
    if s.kind == "int":
        return torch.clamp(torch.round(x), -s.qmax, s.qmax)

    _, sign, exp, mant = fp.unpack_f32(x)
    mant_r, carry = round_mantissa(mant, fp.N_MANT - s.n_mant)
    exp_r = exp + carry                      # 1.11..1 + ulp -> 10.00..0
    e_unb = exp_r - fp.BIAS
    out = fp.pack_f32(sign, exp_r, mant_r)
    # scalars, not a tensor made from one: on CUDA that is a host-to-device
    # copy, which waits for the stream
    out = torch.where(e_unb > s.emax,
                      torch.where(sign == 1, -s.qmax, s.qmax), out)
    out = torch.where((exp == 0) | (e_unb < s.emin), 0.0, out)
    return torch.where(exp == 255, x, out)   # NaN/Inf propagate


def encode_float(v: torch.Tensor, dtype: str | QuantSpec) -> torch.Tensor:
    """On-grid float32 values -> packed ``sign|exp|mant`` integer codes
    (``code_dtype``; fields computed in int32 and narrowed modulo the
    storage width, as the reference narrows them)."""
    s = spec(dtype)
    _, sign, exp, mant = fp.unpack_f32(_f32(v))
    zero = exp == 0
    e_t = torch.where(zero, 0, exp - fp.BIAS + s.bias)
    m_t = torch.where(zero, 0, mant >> (fp.N_MANT - s.n_mant))
    code = (sign << (s.n_exp + s.n_mant)) | (e_t << s.n_mant) | m_t
    return code.to(code_dtype(s))


def decode_float(code: torch.Tensor, dtype: str | QuantSpec) -> torch.Tensor:
    """Packed integer codes -> float32 values (exact inverse of
    ``encode_float``). int16 storage is read as the unsigned 16 bits it
    holds."""
    s = spec(dtype)
    c = code.to(torch.int32)
    if code.dtype == torch.int16:
        c = c & 0xFFFF
    sign = (c >> (s.n_exp + s.n_mant)) & 1
    e_t = (c >> s.n_mant) & ((1 << s.n_exp) - 1)
    m_t = c & ((1 << s.n_mant) - 1)
    out = fp.pack_f32(sign, e_t - s.bias + fp.BIAS,
                      m_t << (fp.N_MANT - s.n_mant))
    return torch.where(e_t == 0, 0.0, out)


def _codes(v: torch.Tensor, s: QuantSpec) -> torch.Tensor:
    """On-grid values -> storage codes: int8 for the int grid (NaN maps
    to 0, as the reference's saturating float-to-int8 conversion maps
    it), packed ``sign|exp|mant`` codes for the float grids."""
    if s.kind == "int":
        return torch.where(torch.isnan(v), 0.0, v).to(torch.int8)
    return encode_float(v, s)


# ---------------------------------------------------------------------------
# blockwise 1-D pack/unpack (absmax block scales)
# ---------------------------------------------------------------------------

BLOCK = 256


def quantize_blockwise(x: torch.Tensor, dtype: str | QuantSpec = "int8",
                       block: int = BLOCK):
    """-> (codes [nblocks, block], scale float32 [nblocks, 1]).

    ``x`` is flattened and zero-padded to a block multiple; each block's
    scale is ``max(absmax * inv_qmax, SCALE_FLOOR)``. Int grids return
    int8 codes, float grids packed codes (``decode_float``)."""
    s = spec(dtype)
    flat = _f32(x).reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    scale = torch.clamp_min(
        blocks.abs().amax(dim=1, keepdim=True) * s.inv_qmax, SCALE_FLOOR)
    return _codes(round_to_grid(blocks / scale, s), s), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         like: torch.Tensor,
                         dtype: str | QuantSpec = "int8") -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`, cut and reshaped to
    ``like``."""
    s = spec(dtype)
    v = q.to(torch.float32) if s.kind == "int" else decode_float(q, s)
    return (v * scale).reshape(-1)[:like.numel()].reshape(like.shape)


# ---------------------------------------------------------------------------
# axis-wise fake-quant for the weight-stationary datapath
# ---------------------------------------------------------------------------


def quantize_axis(w: torch.Tensor, dtype: str | QuantSpec, axis: int = -2):
    """Split ``w ~= q * scale`` with absmax scales reduced over ``axis``.

    For a (K, N) weight block, ``axis=-2`` gives one scale per output
    column — the scale rides the block's peripheral register while the
    ``q`` values sit in the array at ``n_bits`` cells each. Returns
    ``(q, scale)`` with ``q`` the on-grid values in float32 and ``scale``
    keeping the reduced axis."""
    s = spec(dtype)
    w = _f32(w)
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax * s.inv_qmax, SCALE_FLOOR)
    return round_to_grid(w / scale, s), scale


class _QuantizeSTE(torch.autograd.Function):
    """``quantize_axis`` with the straight-through VJP ``dw = dq /
    scale``; the scale is a placement constant (no cotangent)."""

    @staticmethod
    def forward(ctx, w, dtype, axis):
        q, scale = quantize_axis(w, dtype, axis)
        ctx.save_for_backward(scale)
        ctx.mark_non_differentiable(scale)
        return q, scale

    @staticmethod
    def backward(ctx, dq, _dscale):
        (scale,) = ctx.saved_tensors
        return dq / scale, None, None


def quantize_ste(w: torch.Tensor, dtype: str | QuantSpec, axis: int = -2):
    """:func:`quantize_axis` with a straight-through gradient: ``dw = dq
    / scale``. Composed with a kernel whose weight cotangent is ``dq =
    (aᵀg) * scale``, the weight gradient is ``aᵀg`` — float32 gradient
    flow, so training under quantized storage keeps full-precision
    updates."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _QuantizeSTE.apply(w, dtype, axis)
    return quantize_axis(w, dtype, axis)


def fake_quant(w: torch.Tensor, dtype: str | QuantSpec,
               axis: int = -2) -> torch.Tensor:
    """Golden float32 reference: what the array stores, dequantized."""
    if spec(dtype).name == "fp32":
        return _f32(w)
    q, scale = quantize_axis(w, dtype, axis)
    return q * scale


# ---------------------------------------------------------------------------
# declared error budgets
# ---------------------------------------------------------------------------


def error_bound(x: torch.Tensor, dtype: str | QuantSpec,
                scale) -> torch.Tensor:
    """Per-element upper bound on ``|dequant(quant(x)) - x|`` given the
    scale. Int grids: half a quantization step. Float grids: RNE relative
    error (``2^-nm``, 2x slack over the tight ``2^-(nm+1)``) plus the FTZ
    absolute floor (``scale * 2^emin``)."""
    s = spec(dtype)
    x = _f32(x)
    if s.name == "fp32":
        return torch.zeros_like(x)
    scale = _f32(scale)
    if s.kind == "int":
        return torch.broadcast_to(0.5 * scale, x.shape).to(torch.float32)
    return x.abs() * 2.0 ** (-s.n_mant) + scale * 2.0 ** s.emin


def layer_error_budget(dtype: str | QuantSpec) -> float:
    """Declared max per-layer error, relative to each vector's absmax."""
    s = spec(dtype)
    if s.name == "fp32":
        return 0.0
    if s.kind == "int":
        return 0.5 / s.qmax
    return 2.0 ** (-s.n_mant) + 2.0 ** s.emin / s.qmax


def layer_error(w: torch.Tensor, dtype: str | QuantSpec,
                axis: int = -2) -> torch.Tensor:
    """Measured per-layer error: max over vectors of ``max|fake_quant -
    w| / vector absmax`` — comparable to :func:`layer_error_budget`
    (a 0-dim float32 tensor, 0 for fp32)."""
    s = spec(dtype)
    w = _f32(w)
    if s.name == "fp32":
        return w.new_zeros(())
    q, scale = quantize_axis(w, s, axis)
    err = (q * scale - w).abs()
    amax = w.abs().amax(dim=axis, keepdim=True)
    return (err / torch.clamp_min(amax, s.qmax * SCALE_FLOOR)).max()


# ---------------------------------------------------------------------------
# per-vector code/scale split for the KV datapath
# ---------------------------------------------------------------------------


def code_dtype(dtype: str | QuantSpec) -> torch.dtype:
    """Storage dtype of packed codes for a grid (float32 passthrough for
    fp32: the "codes" are the values themselves). The fp16 grid's uint16
    codes are held as int16 (module docstring)."""
    s = spec(dtype)
    if s.name == "fp32":
        return torch.float32
    if s.kind == "int":
        return torch.int8
    return torch.uint8 if s.n_bits <= 8 else torch.int16


def quantize_kv(x: torch.Tensor, dtype: str | QuantSpec):
    """Split ``x ~= codes * scale`` with one absmax scale per vector (the
    last axis: a (token, kv head) ``head_dim`` slice of the pool).

    Returns ``(codes, scale)``: int8 codes for the int grid (NaN maps to
    0, as the reference's saturating float-to-int8 conversion maps it),
    packed codes for the float grids; ``scale`` float32 with a trailing
    keepdim. fp32 passes through (codes = x, scale = 1)."""
    s = spec(dtype)
    x = _f32(x)
    if s.name == "fp32":
        return x, torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                             device=x.device)
    v, scale = quantize_axis(x, s, -1)
    return _codes(v, s), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype: str | QuantSpec) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (float32 out; fp32 passthrough)."""
    s = spec(dtype)
    if s.name == "fp32":
        return codes.to(torch.float32)
    v = (codes.to(torch.float32) if s.kind == "int"
         else decode_float(codes, s))
    return v * scale
