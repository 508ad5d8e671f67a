"""Decoder-only LM on the paged KV path: the port of
``repro.models.transformer.DecoderLM`` for ``block_pattern="attn"`` with
dense SwiGLU MLPs (llama3-8b).

The reference stacks the layers on a leading axis and scans over them;
the port keeps one ``nn.Module`` per layer and loops. The KV pool stays
one stacked tensor per leaf, ``[n_layers, num_blocks, block_size, G,
head_dim]``, so a block copy or swap is one index operation across every
layer. Parameters are created empty on the model's device; ``init(seed)``
fills them from a seeded ``torch.Generator`` on that device (the
reference's distributions, not its numbers).

Entry points:
  * ``decode_step_paged(cache, token, block_table, pos)`` -> logits
    ``[B, V]``, one token for every slot;
  * ``prefill_paged(cache, tokens, table_row, p0, n_new)`` writes one
    slot's prompt KV in one call.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers


class Block(nn.Module):
    """Pre-norm attention + SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.norm1 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = attention.init_attention(cfg, dtype, device)
        self.norm2 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, *,
                 device: str | torch.device | None = None):
        super().__init__()
        unported = []
        if cfg.block_pattern != "attn":
            unported.append(f"block_pattern={cfg.block_pattern!r}")
        if cfg.n_experts:
            unported.append("MoE layers")
        if cfg.tie_embeddings:
            unported.append("tied embeddings")
        if cfg.input_embed_stub:
            unported.append("embedding inputs")
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)} not ported yet (ROADMAP.md, port "
                f"queue item 5: remaining model families)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        dt, dev = self.dtype, self.device
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dt, dev)
        self.layers = nn.ModuleList(Block(cfg, dt, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dt, dev)
        self.lm_head = layers.LMHead(cfg.d_model, cfg.vocab_size, dt, dev)

    def init(self, seed: int = 0) -> "DecoderLM":
        """Fill every parameter from one seeded generator on the model's
        device: projections normal × fan_in^-0.5, embeddings × 0.02, norm
        scales ones. Returns ``self``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "init"):
                m.init(gen)
        return self

    # -- paged KV ------------------------------------------------------------

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         kv_dtype: str = "fp32") -> dict[str, torch.Tensor]:
        """The KV pool shared by all slots: ``{"k", "v"}``, each
        ``[n_layers, num_blocks, block_size, n_kv, head_dim]`` in the
        model dtype (block axis addressed through per-slot block tables —
        see ``repro_torch.serve.kv``); a quantized ``kv_dtype`` stores
        codes and adds ``k_scale``/``v_scale`` leaves
        (``attention.init_paged_kv_cache``)."""
        cfg = self.cfg
        return attention.init_paged_kv_cache(
            cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
            cfg.resolved_head_dim, self.dtype, self.device,
            kv_dtype=kv_dtype)

    @staticmethod
    def _site(cache, i: int) -> dict:
        """Layer ``i``'s slice of every pool leaf, as the attention
        functions take them (views: writes land in the pool)."""
        return {"k_store": cache["k"][i], "v_store": cache["v"][i],
                **{name: cache[name][i] for name in ("k_scale", "v_scale")
                   if name in cache}}

    @torch.no_grad()
    def decode_step_paged(self, cache, token, block_table, pos, *,
                          kernel: bool = False, kv_dtype: str = "fp32"):
        """token: [B] int; block_table: [B, W] int32; pos: [B] int32
        per-slot positions (recycled slots restart at 0). Writes each
        slot's new K/V into ``cache`` in place and returns (logits
        [B, V], cache). ``kernel=True`` runs every site's attention
        through the paged decode kernel (K4, or K6 over a quantized
        pool), one launch for all slots; ``kv_dtype`` must be the
        cache's storage grid."""
        cfg = self.cfg
        x = self.embed(token[:, None])
        for i, blk in enumerate(self.layers):
            x = x + attention.paged_decode_attention(
                blk.norm1(x), blk.attn, cfg, block_table=block_table,
                pos=pos, use_kernel=kernel, kv_dtype=kv_dtype,
                **self._site(cache, i))
            x = x + blk.mlp(blk.norm2(x))
        logits = self.lm_head(self.final_norm(x))
        return logits[:, 0], cache

    @torch.no_grad()
    def prefill_paged(self, cache, tokens, table_row, p0: int, n_new: int,
                      *, kv_dtype: str = "fp32"):
        """Admit a prompt by writing whole KV blocks in one call.

        tokens: [T] — the uncached prompt tokens of one slot, padded to a
        block-size multiple (entries past ``n_new`` are don't-cares), at
        global positions ``p0 .. p0+n_new-1``; table_row: [W] the slot's
        physical block ids. Writes ``cache`` in place and returns it — no
        logits: the decode tick that feeds the final prompt token samples
        the first output."""
        cfg = self.cfg
        x = self.embed(tokens[None])                          # [1, T, D]
        for i, blk in enumerate(self.layers):
            x = x + attention.paged_prefill_attention(
                blk.norm1(x), blk.attn, cfg, table_row=table_row, p0=p0,
                n_new=n_new, kv_dtype=kv_dtype, **self._site(cache, i))
            x = x + blk.mlp(blk.norm2(x))
        return cache
