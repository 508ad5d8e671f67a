"""Plain PyTorch versions of the port's kernels (the correctness contract):
K4 and K6 (paged decode attention), K1, K2 and K3 (the PIM matmul and
MAC).

Each CUDA kernel of the port is held against its plain version here: the
CPU tests compare these with the reference's Pallas kernels, and
``chip_smoke.py`` compares each kernel with its plain version on the
card. A kernel wrapper calls its plain version only for tensors on the
CPU.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import quant

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


def pim_mac_ref(a: torch.Tensor, b: torch.Tensor,
                acc: torch.Tensor) -> torch.Tensor:
    """Elementwise float32 MAC ``acc + a*b`` (K3): two eager ops, so two
    roundings — the product, then the sum — as the paper's MAC unit and
    the CUDA kernel compute it."""
    return acc + a * b


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
