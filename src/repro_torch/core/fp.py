"""IEEE-754 float32 bit fields: the part of ``repro.core.fp`` that the
KV quantizer needs.

The reference splits a float32 into sign, biased exponent and mantissa
through a uint32 bitcast. Torch has no usable uint32 arithmetic, so the
port bitcasts to int32 (``Tensor.view``), masks the fields out of that,
and packs through int64 so no shift overflows. The bit-plane adders and
the FP procedures of the reference are not ported yet (ROADMAP.md, port
queue item 3).
"""

from __future__ import annotations

import torch

N_MANT = 23
N_EXP = 8
BIAS = 127
_U32 = 0xFFFFFFFF


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
    u = u - ((u >> 31) << 32)          # the signed int32 of those bits
    return u.to(torch.int32).view(torch.float32)
