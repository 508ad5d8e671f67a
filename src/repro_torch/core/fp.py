"""Bit-plane IEEE-754 float32 add/mul built from the PIM full-adder
primitive: the port of ``repro.core.fp``, the functional reproduction of
the paper's §3.3 floating point computation.

  * a number is a **bit-plane** tensor ``[..., n]`` of {0,1} int32, LSB
    first, on the input's device — the batch dimensions are the
    subarray's column-parallelism (each lane is one column), and a Python
    loop over the bit index (the reference's ``lax.scan``) is the
    bit-serial row schedule;
  * every multi-bit addition ripples through the paper's FA equations
    (S = X^Y^Z, Z' = XY + Z(X^Y)) — the same boolean ops the 4-step FA
    executes in-array (``repro_torch.core.fulladder``);
  * exponent alignment uses a **flexible multi-bit shift** (the paper's
    O(Nm) method enabled by the 1T-1R cell, vs FloatPIM's bit-by-bit
    O(Nm^2));
  * mantissa multiplication is **shift-and-add** with a ping-pong
    accumulator (Fig. 4b).

Semantics: the reference's under XLA — IEEE-754 binary32,
round-to-nearest-even, with subnormal inputs treated as signed zeros
(DAZ) and subnormal results flushed to signed zeros (FTZ). NaN/Inf
propagate per IEEE. XLA flushes the native ``a + b`` / ``a * b`` the
reference takes for zero, Inf and NaN operands; torch does not, so the
port flushes those operands itself (:func:`flush_subnormal`). NaN bit
patterns follow the device (x86 gives ``0xFFC00000``, CUDA
``0x7FFFFFFF``): compare NaN as NaN.

Torch has no usable uint32 arithmetic, so the fields are split through
an int32 view (``Tensor.view``) and packed through int64 so no shift
overflows; :func:`bits_to_u32` returns a uint32 value as int64.
"""

from __future__ import annotations

import torch

N_MANT = 23
N_EXP = 8
BIAS = 127
_U32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# float32 unpack / pack
# ---------------------------------------------------------------------------


def unpack_f32(x: torch.Tensor):
    """float32 -> (bits, sign, exp, mant): ``bits`` the int32 view of the
    pattern, the three fields as non-negative int32."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    sign = (u >> 31) & 1
    exp = (u >> N_MANT) & 0xFF
    mant = u & 0x7FFFFF
    return u, sign, exp, mant


def pack_f32(sign: torch.Tensor, exp: torch.Tensor,
             mant: torch.Tensor) -> torch.Tensor:
    """The float32 of ``(sign << 31) | (exp << 23) | mant`` in uint32
    arithmetic, as the reference computes it: each integer tensor is
    taken modulo 2^32 and the shifted sum keeps its low 32 bits."""
    def u32(t):
        return t.to(torch.int64) & _U32

    u = ((u32(sign) << 31) | (u32(exp) << N_MANT) | u32(mant)) & _U32
    # the signed int32 of those bits: the high word filled with bit 31,
    # in bit operations alone (the reference's graph prices no op here)
    u = u | ((-(u >> 31)) << 32)
    return u.to(torch.int32).view(torch.float32)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with every subnormal replaced by a zero of its sign:
    the DAZ that XLA applies to the inputs of its native float ops."""
    u, _, exp, _ = unpack_f32(x)
    signed_zero = (u & -0x80000000).view(torch.float32)
    return torch.where(exp == 0, signed_zero, x.to(torch.float32))


def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# bit-plane helpers
# ---------------------------------------------------------------------------


def u32_to_bits(x: torch.Tensor, n: int) -> torch.Tensor:
    """Integer tensor (taken modulo 2^32) -> [..., n] int32 bit planes,
    LSB first."""
    x = torch.as_tensor(x).to(torch.int64) & _U32
    shifts = torch.arange(n, device=x.device)
    return ((x[..., None] >> shifts) & 1).to(torch.int32)


def bits_to_u32(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] bit planes -> their uint32 value (modulo 2^32), as int64."""
    n = bits.shape[-1]
    shifts = torch.arange(n, device=bits.device)
    return (bits.to(torch.int64) << shifts).sum(-1) & _U32


def fa_bit(x, y, z):
    """The paper's FA equations — the single PIM logic primitive (eq. 1)."""
    s = x ^ y ^ z
    carry = (x & y) | (z & (x ^ y))
    return s, carry


def pim_add(a_bits: torch.Tensor, b_bits: torch.Tensor, cin=None):
    """Ripple-carry addition of two bit-plane numbers, one FA per bit.

    Returns (sum_bits [..., n], carry_out [...]).
    """
    n = a_bits.shape[-1]
    assert b_bits.shape[-1] == n
    batch = a_bits.shape[:-1]
    carry = torch.broadcast_to(
        torch.as_tensor(0 if cin is None else cin, dtype=a_bits.dtype,
                        device=a_bits.device), batch)
    out = []
    for i in range(n):
        s, carry = fa_bit(a_bits[..., i], b_bits[..., i], carry)
        out.append(s)
    return torch.stack(out, dim=-1), carry


def pim_sub(a_bits: torch.Tensor, b_bits: torch.Tensor):
    """a - b (requires a >= b for an unsigned-correct result)."""
    s, _ = pim_add(a_bits, 1 - b_bits, cin=1)
    return s


def pim_inc_at(bits: torch.Tensor, inc: torch.Tensor):
    """bits + inc (inc in {0,1} per element) -> (bits, carry_out)."""
    one = torch.zeros_like(bits)
    one[..., 0] = inc.to(bits.dtype)
    return pim_add(bits, one)


def _per_lane(k, bits: torch.Tensor) -> torch.Tensor:
    """Shift amount ``k`` (scalar or per lane) as [..., 1] int64."""
    k = torch.as_tensor(k, device=bits.device).to(torch.int64)
    return torch.broadcast_to(k, bits.shape[:-1])[..., None]


def _gather(bits: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    n = bits.shape[-1]
    return torch.gather(bits, -1, src.clamp(0, n - 1))


def shift_right_sticky(bits: torch.Tensor, k):
    """Flexible multi-bit right shift (the 1T-1R 'flexible bits' shift, §3.3).

    ``k`` >= 0, per-element. Returns (shifted, sticky) where sticky = OR of
    the shifted-out bits.
    """
    n = bits.shape[-1]
    idx = torch.arange(n, device=bits.device)
    k = _per_lane(k, bits)
    src = idx + k
    shifted = torch.where(src < n, _gather(bits, src), 0)
    sticky = torch.where(idx < k, bits, 0).amax(-1)
    return shifted, sticky


def shift_left(bits: torch.Tensor, k):
    """Flexible multi-bit left shift, zeros in, drops overflowed bits."""
    n = bits.shape[-1]
    idx = torch.arange(n, device=bits.device)
    src = idx - _per_lane(k, bits)
    return torch.where(src >= 0, _gather(bits, src), 0)


def msb_position(bits: torch.Tensor) -> torch.Tensor:
    """Index of the most significant set bit; -1 if zero."""
    idx = torch.arange(bits.shape[-1], device=bits.device)
    return torch.where(bits > 0, idx, -1).amax(-1)


def _round_rne(keep_lsb, guard, rnd, sticky):
    """Round-to-nearest-even increment decision."""
    return (guard & (rnd | sticky | keep_lsb)).to(torch.int32)


def _set_bit(bits: torch.Tensor, i: int, value: torch.Tensor):
    out = bits.clone()
    out[..., i] = value
    return out


def _rounded(keep: torch.Tensor, inc: torch.Tensor):
    """RNE increment of a 24-bit significand; a carry out of bit 23 (the
    significand became 2.0) renormalizes it. Returns (keep, carry)."""
    keep_r, carry_r = pim_inc_at(keep, inc)
    keep_r = torch.where(carry_r[..., None] > 0,
                         shift_right_sticky(keep_r, 1)[0], keep_r)
    keep_r = _set_bit(keep_r, 23,
                      torch.where(carry_r > 0, 1, keep_r[..., 23]))
    return keep_r, carry_r


# ---------------------------------------------------------------------------
# floating point addition (paper §3.3 'Addition')
# ---------------------------------------------------------------------------

_W_ADD = N_MANT + 6  # 24 significand + 3 GRS + 1 carry headroom + 1 spare


def fp32_add_pim(a, b) -> torch.Tensor:
    """IEEE-754 f32 addition through the PIM bit-plane procedure."""
    a, b = torch.broadcast_tensors(_as_f32(a), _as_f32(b))
    _, sa, ea, ma = unpack_f32(a)
    _, sb, eb, mb = unpack_f32(b)

    # DAZ on inputs: subnormals (exp==0, mant!=0) treated as zero.
    a_zero = ea == 0
    b_zero = eb == 0

    # order so |x| >= |y| (compare biased exp then mantissa).
    mag_a = (ea << 23) | ma
    mag_b = (eb << 23) | mb
    swap = mag_b > mag_a
    sx = torch.where(swap, sb, sa)
    ex = torch.where(swap, eb, ea)
    mx = torch.where(swap, mb, ma)
    sy = torch.where(swap, sa, sb)
    ey = torch.where(swap, ea, eb)
    my = torch.where(swap, ma, mb)

    # significands with implicit 1, pre-shifted by 3 for G/R/S headroom.
    bx = u32_to_bits(((1 << 23) | mx) << 3, _W_ADD)
    by = u32_to_bits(((1 << 23) | my) << 3, _W_ADD)

    # exponent alignment — the 'search' + flexible shift (cost: O(Nm)).
    d = (ex - ey).clamp(0, _W_ADD)
    by_sh, sticky_align = shift_right_sticky(by, d)
    # OR the sticky into bit 0 so effective-subtract borrows correctly.
    by_sh = _set_bit(by_sh, 0, by_sh[..., 0] | sticky_align)

    eff_sub = sx != sy
    # width 29 has headroom: operands peak at bit 26, the add-path carry
    # lands in bit 27 inside the ripple sum itself (carry_out always 0).
    sum_add, _ = pim_add(bx, by_sh)
    sum_sub = pim_sub(bx, by_sh)
    v = torch.where(eff_sub[..., None], sum_sub, sum_add)

    # normalize so MSB sits at position 26 (= N_MANT + 3).
    p = msb_position(v)
    target = N_MANT + 3
    is_zero_res = p < 0
    shl = (target - p).clamp(0, _W_ADD)
    shr = (p - target).clamp(0, 1)        # at most 1 (carry case)
    v_n, sticky_n = shift_right_sticky(shift_left(v, shl), shr)
    e_res = ex + (p - target)

    keep = v_n[..., 3:3 + 24]
    inc = _round_rne(keep[..., 0], v_n[..., 2], v_n[..., 1],
                     v_n[..., 0] | sticky_n)
    keep_r, carry_r = _rounded(keep, inc)
    e_res = e_res + carry_r

    mant_res = bits_to_u32(keep_r) & 0x7FFFFF
    # result sign: sign of the larger-magnitude operand; exact-zero result
    # gets +0 (RNE rule).
    s_res = torch.where(is_zero_res, 0, sx)
    e_out = torch.where(is_zero_res, 0, e_res)
    m_out = torch.where(is_zero_res, 0, mant_res)
    # underflow -> FTZ; overflow -> inf.
    underflow = e_out <= 0
    overflow = e_out >= 255
    e_out = torch.where(underflow, 0, torch.where(overflow, 255, e_out))
    m_out = torch.where(underflow | overflow, 0, m_out)
    res = pack_f32(s_res, e_out, m_out)

    # special cases, resolved with XLA's own semantics where IEEE mandates
    # (its native add reads subnormals as zeros):
    naive = flush_subnormal(a) + flush_subnormal(b)
    res = torch.where(a_zero & b_zero, naive, res)
    res = torch.where(a_zero & ~b_zero, b, res)
    res = torch.where(b_zero & ~a_zero, a, res)
    special = a.isnan() | b.isnan() | a.isinf() | b.isinf()
    return torch.where(special, naive, res)


# ---------------------------------------------------------------------------
# floating point multiplication (paper §3.3 'Multiplication', Fig. 4b)
# ---------------------------------------------------------------------------

_W_MUL = 2 * (N_MANT + 1) + 1  # 49: 48-bit product + headroom


def fp32_mul_pim(a, b) -> torch.Tensor:
    """IEEE-754 f32 multiplication via PIM shift-and-add (ping-pong acc)."""
    a, b = torch.broadcast_tensors(_as_f32(a), _as_f32(b))
    _, sa, ea, ma = unpack_f32(a)
    _, sb, eb, mb = unpack_f32(b)

    bits_a = u32_to_bits((1 << 23) | ma, _W_MUL)     # multiplicand
    bits_b = u32_to_bits((1 << 23) | mb, N_MANT + 1)  # multiplier bits

    # shift-and-add: acc += (A << k) if B_k — Fig. 4b. The two
    # intermediate columns of the ping-pong scheme are ``acc`` and the
    # freshly written partial sum.
    acc = torch.zeros_like(bits_a)
    shifted_a = bits_a
    for k in range(N_MANT + 1):
        acc, _ = pim_add(acc, shifted_a * bits_b[..., k, None])
        shifted_a = shift_left(shifted_a, 1)

    # normalize: product of two [1,2) significands is in [1,4): MSB at 46
    # or 47.
    top = acc[..., 47]
    e_res = ea + eb - BIAS + top

    # select the 24-bit significand + G + sticky depending on `top`.
    idx = torch.arange(_W_MUL, device=acc.device)

    def extract(hi):
        keep = acc[..., hi - 23:hi + 1]
        guard = acc[..., hi - 24]
        sticky = torch.where(idx < hi - 24, acc, 0).amax(-1)
        return keep, guard, sticky

    keep1, g1, s1 = extract(47)
    keep0, g0, s0 = extract(46)
    keep = torch.where(top[..., None] > 0, keep1, keep0)
    guard = torch.where(top > 0, g1, g0)
    sticky = torch.where(top > 0, s1, s0)

    # with only G and S available, R's bit is part of the sticky OR above
    # — equivalent for RNE.
    inc = _round_rne(keep[..., 0], guard, torch.zeros_like(guard), sticky)
    keep_r, carry_r = _rounded(keep, inc)
    e_res = e_res + carry_r

    mant_res = bits_to_u32(keep_r) & 0x7FFFFF
    s_res = sa ^ sb
    underflow = e_res <= 0
    overflow = e_res >= 255
    e_out = torch.where(underflow | overflow,
                        torch.where(overflow, 255, 0), e_res)
    m_out = torch.where(underflow | overflow, 0, mant_res)
    res = pack_f32(s_res, e_out, m_out)

    naive = flush_subnormal(a) * flush_subnormal(b)
    special = ((ea == 0) | (eb == 0) | a.isnan() | b.isnan() | a.isinf()
               | b.isinf())
    return torch.where(special, naive, res)


def fp32_mac_pim(a, b, acc) -> torch.Tensor:
    """One PIM MAC: acc + a*b (the unit benchmarked in Fig. 5)."""
    return fp32_add_pim(fp32_mul_pim(a, b), acc)


def pim_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product via sequential PIM MACs (reference for kernels/pim_fp)."""
    a, b = _as_f32(a), _as_f32(b)
    assert a.dim() == 1 and b.dim() == 1
    acc = torch.zeros((), dtype=torch.float32, device=a.device)
    for x, y in zip(a, b):
        acc = fp32_mac_pim(x, y, acc)
    return acc
