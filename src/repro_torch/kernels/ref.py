"""Plain PyTorch versions of the port's kernels (the correctness contract):
K4 and K6 (paged decode attention), K1, K2 and K3 (the PIM matmul and
MAC), K5 (the PIM matmul over quantized stored weights), K7 (causal GQA
flash attention) and K8 (the bit-serial float32 multiply).

Each CUDA kernel of the port is held against its plain version here: the
CPU tests compare these with the reference's Pallas kernels, and
``chip_smoke.py`` compares each kernel with its plain version on the
card. A kernel wrapper calls its plain version only for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import fp, quant

NEG_INF = -1e30


def paged_decode_attention_ref(q: torch.Tensor, k_store: torch.Tensor,
                               v_store: torch.Tensor,
                               block_table: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode attention over a paged KV pool.

    q: [B, H, D]; k/v_store: [N, bs, G, D]; block_table: [B, W] physical
    block ids (entries past a slot's position point at the scratch
    block); pos: [B] per-slot positions. Returns [B, H, D] in q's dtype.

    Gathers every table entry (the reference's XLA path,
    ``repro/models/attention.py`` paged decode), scores in float32 scaled
    by 1/sqrt(D), masks keys past ``pos[b]``, softmaxes, rounds the
    probabilities to v's dtype (as the Pallas kernel does before its PV
    product) and takes the PV product in float32. Query head ``h`` reads
    kv head ``h // (H // G)``.
    """
    tbl = block_table.long()
    return _attend(q, _gathered(k_store[tbl]), _gathered(v_store[tbl]), pos)


def paged_decode_attention_q_ref(q: torch.Tensor, k_store: torch.Tensor,
                                 k_scale: torch.Tensor,
                                 v_store: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 block_table: torch.Tensor, pos: torch.Tensor,
                                 kv_dtype: str) -> torch.Tensor:
    """:func:`paged_decode_attention_ref` over a quantized pool (K6).

    k/v_store: [N, bs, G, D] packed codes (``quant.code_dtype``);
    k/v_scale: [N, bs, G, 1] float32 per-(token, kv head) scales. Gathers
    every table entry's codes and scales, dequantizes them with
    ``quant.dequantize_kv`` to float32 and applies K4's plain math. Since
    v is float32, the probabilities are not rounded before the PV product
    — the reference kernel casts them to v's dtype too. Returns [B, H, D]
    in q's dtype.
    """
    tbl = block_table.long()
    k = quant.dequantize_kv(k_store[tbl], k_scale[tbl], kv_dtype)
    v = quant.dequantize_kv(v_store[tbl], v_scale[tbl], kv_dtype)
    return _attend(q, _gathered(k), _gathered(v), pos)


def _gathered(blocks: torch.Tensor) -> torch.Tensor:
    """[B, W, bs, G, D] gathered blocks -> [B, W * bs, G, D] keys."""
    b, w, bs, g, d = blocks.shape
    return blocks.reshape(b, w * bs, g, d)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pos: torch.Tensor) -> torch.Tensor:
    """q [B, H, D] over each slot's keys k/v [B, L, G, D], positions
    0..pos[b] valid."""
    b, h, d = q.shape
    length, g = k.shape[1], k.shape[2]
    qg = q.reshape(b, g, h // g, d)
    scores = torch.einsum("bgrd,blgd->bgrl", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(d))
    valid = (torch.arange(length, device=q.device)[None]
             <= pos.long()[:, None])                       # [B, L]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrl,blgd->bgrd", probs.float(), v.float())
    return out.reshape(b, h, d).to(q.dtype)


def pim_mac_ref(a, b, acc):
    """Elementwise float32 MAC ``acc + a*b`` (K3): two eager ops, so two
    roundings — the product, then the sum — as the paper's MAC unit and
    the CUDA kernel compute it. Each operand is a float32 tensor (they
    broadcast) or a number, read as float32 (rounded to nearest); a
    product or sum of two numbers is rounded to float32 as well."""
    prod = (_f32(_f32(a) * _f32(b)) if not isinstance(a, torch.Tensor)
            and not isinstance(b, torch.Tensor) else _num(a) * _num(b))
    if not isinstance(acc, torch.Tensor) and not isinstance(prod,
                                                            torch.Tensor):
        return _f32(_f32(acc) + prod)
    return _num(acc) + prod


def pim_mac_wave_ref(members) -> list[torch.Tensor]:
    """K3 over a wave (one launch of the kernel): for each member ``(shape,
    a, b, acc, stride)`` (``kernels.pim_mac.MacMember``),
    :func:`pim_mac_ref` over its shape, a fresh tensor, laid out in
    ``stride`` (a dense layout of the shape) where that is given."""
    outs = []
    for shape, a, b, acc, *rest in members:
        out = pim_mac_ref(a, b, acc)
        stride = rest[0] if rest else None
        if stride is not None and (tuple(out.shape) != tuple(shape)
                                   or out.stride() != tuple(stride)):
            out = torch.empty_strided(shape, stride, dtype=torch.float32,
                                      device=out.device).copy_(out)
        elif tuple(out.shape) != tuple(shape):
            out = out.expand(shape).contiguous()
        outs.append(out)
    return outs


def _f32(x) -> float:
    """A number rounded to float32 (to nearest), as a Python float."""
    return ctypes.c_float(x).value


def _num(x):
    return x if isinstance(x, torch.Tensor) else _f32(x)


def pim_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                   bk: int = 128) -> torch.Tensor:
    """Blocked float32 ``a @ b`` (K2, one placed block): a zero float32
    accumulator plus one ``torch.matmul`` per ``bk``-deep K tile, in
    ascending order, as the Pallas kernel accumulates its scratch tile."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], bk):
        acc += torch.matmul(a[:, k0:k0 + bk], b[k0:k0 + bk])
    return acc


def pim_matmul_grouped_ref(a: torch.Tensor, b: torch.Tensor, *,
                           col_groups: int = 1,
                           bk: int = 128) -> torch.Tensor:
    """``C[g] = A[g // col_groups] @ B[g]`` (K1): every group through
    :func:`pim_matmul_ref`, so the grouped product equals the per-block
    one bit for bit on the CPU too. (A CPU ``bmm`` may sum in another
    order than ``mm``.)"""
    return torch.stack([pim_matmul_ref(a[g // col_groups], b[g], bk=bk)
                        for g in range(b.shape[0])])


def pim_matmul_grouped_q_ref(a: torch.Tensor, q: torch.Tensor,
                             s: torch.Tensor, *, col_groups: int = 1,
                             bk: int = 128) -> torch.Tensor:
    """``C[g] = A[g // col_groups] @ (Q[g] * S[g])`` (K5): the stored
    on-grid values dequantized by their per-(group, column) scale, then
    :func:`pim_matmul_grouped_ref` — K5 equals K1 on ``q * s`` bit for
    bit."""
    return pim_matmul_grouped_ref(a, q * s, col_groups=col_groups, bk=bk)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention (K7). q [B, S, H, D]; k/v [B, S, G, D] ->
    [B, S, H, D] in q's dtype.

    The reference's oracle step by step: K/V repeated to H heads, the
    score einsum in q's dtype (bf16 scores are rounded to bf16 before
    the float32 softmax), scaled by 1/sqrt(D), -1e30 above the diagonal,
    softmax in float32, the probabilities cast to q's dtype before the
    PV einsum.
    """
    s = q.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    return _masked_attention(q, k, v, causal)


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      keep: torch.Tensor) -> torch.Tensor:
    """``flash_attention_ref``'s body under any mask: ``keep`` [S, S] is
    True where query row i reads key j."""
    rep = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(rep, dim=2)
    vv = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk).float()
    scores = scores / math.sqrt(q.shape[3])
    scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vv)


_M23, _M24 = 0x7FFFFF, 0xFFFFFF


def pim_fp32_mul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise float32 ``a * b`` by the paper's bit-serial
    shift-and-add (K8, Fig. 4b), in int64 arithmetic (torch has no usable
    uint32).

    24 steps over b's significand bits add the shifted multiplicand into
    two 24-bit limbs (lo, hi) with carry propagation; the product is
    normalized on bit 47 and rounded to nearest even from the guard and
    sticky bits, renormalized when the rounding overflows; the exponent
    is ``ea + eb - 127 + top + overflow``. A result exponent <= 0 gives a
    signed zero (FTZ), >= 255 a signed inf. An input whose exponent field
    is 0 or 255 takes the native product of the inputs with subnormals
    read as signed zeros (DAZ): the reference's contract under XLA.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)

    def fields(x):
        u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return u >> 31, (u >> 23) & 0xFF, (u & _M23) | (1 << 23)

    sa, ea, sig_a = fields(a)
    sb, eb, sig_b = fields(b)
    lo = torch.zeros_like(sig_a)
    hi = torch.zeros_like(sig_a)
    for i in range(24):
        bit = (sig_b >> i) & 1
        lo = lo + bit * ((sig_a & ((1 << (24 - i)) - 1)) << i)
        hi = hi + bit * (sig_a >> (24 - i))
        hi = hi + (lo >> 24)              # carry propagate
        lo = lo & _M24

    # product in [2^46, 2^48): normalize by top bit (47)
    top = (hi >> 23) & 1
    keep = torch.where(top == 1, hi, ((hi << 1) | (lo >> 23)) & _M24)
    guard = torch.where(top == 1, (lo >> 23) & 1, (lo >> 22) & 1)
    sticky = torch.where(top == 1, (lo & _M23) != 0, (lo & 0x3FFFFF) != 0)
    keep = keep + (guard & (sticky.to(torch.int64) | (keep & 1)))
    round_ovf = (keep >> 24) & 1
    keep = torch.where(round_ovf == 1, keep >> 1, keep)

    e = ea + eb - 127 + top + round_ovf
    sign = (sa ^ sb) << 31
    out = sign | (e.clamp(0, 255) << 23) | (keep & _M23)
    out = torch.where(e <= 0, sign, out)
    out = torch.where(e >= 255, sign | 0x7F800000, out)
    out = out - ((out >> 31) << 32)       # the signed int32 of those bits
    res = out.to(torch.int32).view(torch.float32)

    special = (ea == 0) | (eb == 0) | (ea == 255) | (eb == 255)
    native = fp.flush_subnormal(a) * fp.flush_subnormal(b)
    return torch.where(special, native, res)
