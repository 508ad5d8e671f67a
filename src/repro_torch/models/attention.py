"""GQA attention over a paged KV pool: decode and whole-prompt prefill.

Port of the paged paths of ``repro.models.attention``. The KV pool of the
whole model is one stacked tensor per leaf, ``[n_layers, num_blocks,
block_size, G, head_dim]``; an attention site reads and writes its layer's
slice ``[num_blocks, block_size, G, head_dim]``. Where the reference
returns an updated copy of the pool (``.at[].set``), the port writes the
pool in place.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import paged_decode_attention_grouped
from repro_torch.models import layers

NEG_INF = ref.NEG_INF


class Attention(nn.Module):
    """The q/k/v/o projections of one attention site (``[in, out]``
    weights, as in the reference's ``init_attention``)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype, device, *, qkv_bias: bool = False,
                 qk_norm: bool = False):
        super().__init__()
        if qkv_bias or qk_norm:
            raise NotImplementedError(
                "qkv_bias / qk_norm attention is not ported yet (ROADMAP.md, "
                "port queue item 5: remaining model families)")
        hq, hkv = n_heads * head_dim, n_kv * head_dim
        self.wq = layers.empty_param((d_model, hq), dtype, device)
        self.wk = layers.empty_param((d_model, hkv), dtype, device)
        self.wv = layers.empty_param((d_model, hkv), dtype, device)
        self.wo = layers.empty_param((hq, d_model), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            layers.dense_init_(w, generator)


def init_attention(cfg: ArchConfig, dtype, device) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim, dtype, device,
                     qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)


def _project_qkv(x, attn: Attention, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ attn.wq).reshape(b, s, cfg.n_heads, hd)
    k = (x @ attn.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ attn.wv).reshape(b, s, cfg.n_kv_heads, hd)
    q = layers.apply_rope(q, positions, theta=cfg.rope_theta,
                          style=cfg.rope_style)
    k = layers.apply_rope(k, positions, theta=cfg.rope_theta,
                          style=cfg.rope_style)
    return q, k, v


def init_paged_kv_cache(n_layers: int, num_blocks: int, block_size: int,
                        n_kv: int, head_dim: int, dtype,
                        device) -> dict[str, torch.Tensor]:
    """The paged KV pool of ``n_layers`` attention sites: position ``p``
    of a slot lives at ``[layer, table[p // block_size], p % block_size]``.
    Only unquantized storage (the reference's ``kv_dtype="fp32"``, which
    stores in the model dtype) is ported."""
    shape = (n_layers, num_blocks, block_size, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_decode_attention(x, attn: Attention, cfg: ArchConfig,
                           k_store: torch.Tensor, v_store: torch.Tensor,
                           block_table: torch.Tensor, pos: torch.Tensor, *,
                           use_kernel: bool = False) -> torch.Tensor:
    """x: [B, 1, D]; k/v_store: this site's pool [num_blocks, block_size,
    G, hd], written in place; block_table: [B, W] int32 (invalid entries
    clamped to the scratch block); pos: [B] int32 per-slot positions.
    Returns out [B, 1, D].

    The new token's K/V are written into each slot's tail block *before*
    the attention pass. ``use_kernel=True`` runs the pass through the
    paged decode kernel (one launch for every slot); otherwise through
    the gather path, the kernel's plain version.
    """
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    bs = k_store.shape[1]
    q, k_new, v_new = _project_qkv(x, attn, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    blk = block_table[rows, (pos // bs).long()].long()      # [B] tail blocks
    off = (pos % bs).long()
    # in place; the reference returns a copy (cache.at[blk, off].set)
    k_store[blk, off] = k_new[:, 0].to(k_store.dtype)
    v_store[blk, off] = v_new[:, 0].to(v_store.dtype)
    q1 = q[:, 0].contiguous()
    if use_kernel:
        att = paged_decode_attention_grouped(q1, k_store, v_store,
                                             block_table, pos)
    else:
        att = ref.paged_decode_attention_ref(q1, k_store, v_store,
                                             block_table, pos)
    return att.reshape(b, 1, cfg.n_heads * hd) @ attn.wo


def paged_prefill_attention(x, attn: Attention, cfg: ArchConfig,
                            k_store: torch.Tensor, v_store: torch.Tensor,
                            table_row: torch.Tensor, p0: int,
                            n_new: int) -> torch.Tensor:
    """Whole-prompt attention for one slot over the paged pool.

    x: [1, T, D] — T new prompt tokens (padded; entries past ``n_new``
    are don't-cares) at global positions ``p0 .. p0+n_new-1``;
    ``table_row``: [W] the slot's physical block ids. Returns att
    [1, T, D]; the new tokens' K/V are written into the pool in place
    (the reference returns a copy), padded entries into the scratch
    block 0. Queries attend causally over the cached prefix and the new
    tokens through a gather of the slot's table, as the reference does;
    this is plain PyTorch because the reference's prefill is XLA code,
    outside any Pallas kernel.
    """
    t = x.shape[1]
    hd = cfg.resolved_head_dim
    bs = k_store.shape[1]
    w = table_row.shape[0]
    g = cfg.n_kv_heads
    gpos = p0 + torch.arange(t, device=x.device)             # [T]
    q, k_new, v_new = _project_qkv(x, attn, cfg, gpos[None])
    new_valid = torch.arange(t, device=x.device) < n_new
    tbl = table_row.long()
    blk = torch.where(new_valid, tbl[torch.clamp(gpos // bs, 0, w - 1)], 0)
    off = torch.where(new_valid, gpos % bs, 0)
    # in place; the reference returns a copy (cache.at[blk, off].set)
    k_store[blk, off] = k_new[0].to(k_store.dtype)
    v_store[blk, off] = v_new[0].to(v_store.dtype)
    k = k_store[tbl].reshape(1, w * bs, g, hd)
    v = v_store[tbl].reshape(1, w * bs, g, hd)
    qg = q.reshape(1, t, g, cfg.n_heads // g, hd)             # [1,T,G,R,D]
    scores = (torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
              / math.sqrt(hd))
    # causal over global positions; keys past the written region are
    # excluded by the same bound
    valid = (torch.arange(w * bs, device=x.device)[None]
             <= gpos[:, None])                                # [T, L]
    scores = scores.masked_fill(~valid[None, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(1, t, cfg.n_heads * hd) @ attn.wo
