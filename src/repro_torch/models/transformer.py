"""Decoder-only LM: the port of ``repro.models.transformer.DecoderLM``
for ``block_pattern="attn"`` with dense SwiGLU MLPs (llama3-8b), on a
paged KV pool and against a contiguous cache.

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
    slot's prompt KV in one call;
  * ``decode_step(params, cache, token, pos)`` -> (logits ``[B, V]``,
    cache): one token against a contiguous cache (``init_cache``), a
    function of the reference's parameter tree (``stacked_params``,
    ``param_tree``) — the layers stacked on a leading axis, as the
    reference scans them — so the mapper can trace it on meta tensors
    (``launch.steps.make_serve_step``). Each layer runs in a ``"scan"``
    region (``core.estimator.region``), which the mapper's graph folds
    back into the reference's scanned nodes.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimator
from repro_torch.models import attention, layers

# the reference's per-layer leaves (``layers/block0/<name>``, stacked on a
# leading axis) and the port's per-layer module attribute of each
LAYER_LEAVES = {"norm1/scale": "norm1.scale", "norm2/scale": "norm2.scale",
                "attn/wq": "attn.wq", "attn/wk": "attn.wk",
                "attn/wv": "attn.wv", "attn/wo": "attn.wo",
                "mlp/w_gate": "mlp.w_gate", "mlp/w_up": "mlp.w_up",
                "mlp/w_down": "mlp.w_down"}


def leaf_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Every leaf of the reference's parameter tree by its '/'-joined key
    path (``checkpoint/ckpt.py:_flatten``'s), with its shape."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    per_layer = {"norm1/scale": (d,), "norm2/scale": (d,),
                 "attn/wq": (d, hq), "attn/wk": (d, hkv),
                 "attn/wv": (d, hkv), "attn/wo": (hq, d),
                 "mlp/w_gate": (d, f), "mlp/w_up": (d, f),
                 "mlp/w_down": (f, d)}
    return {"embed/table": (v, d), "final_norm/scale": (d,),
            "lm_head/w": (d, v),
            **{f"layers/block0/{k}": (cfg.n_layers, *shape)
               for k, shape in per_layer.items()}}


def param_tree(flat: dict) -> dict:
    """The nested parameter tree of '/'-joined key paths, in the order of
    ``leaf_shapes`` (the order a traced step's arguments flatten in)."""
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor):
    """The reference's ``DecoderLM.decode_step``: token [B] int; pos a
    0-d int tensor, the current position; ``params`` the reference's
    tree (``param_tree``), ``cache`` ``{"layers": {"block0": {"k",
    "v"}}}``, leaves ``[L, B, max_len, G, hd]``. Returns (logits [B, V],
    the updated cache, written out of place). Each layer is one
    iteration of a ``"scan"`` region."""
    x = layers.embed(token[:, None], params["embed"]["table"])
    lp = params["layers"]["block0"]
    lc = cache["layers"]["block0"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        with estimator.region("scan", "layers"):
            h = layers.rms_norm(x, lp["norm1"]["scale"][i], cfg.norm_eps)
            att, kv = attention.decode_attention(
                h, {name: w[i] for name, w in lp["attn"].items()}, cfg,
                {"k": lc["k"][i], "v": lc["v"][i]}, pos)
            x = x + att
            ks.append(kv["k"])
            vs.append(kv["v"])
            h = layers.rms_norm(x, lp["norm2"]["scale"][i], cfg.norm_eps)
            x = x + layers.mlp(h, lp["mlp"]["w_gate"][i],
                               lp["mlp"]["w_up"][i], lp["mlp"]["w_down"][i])
    x = layers.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = layers.lm_head(x, params["lm_head"]["w"])
    return logits[:, 0], {"layers": {"block0": {"k": torch.stack(ks),
                                                "v": torch.stack(vs)}}}


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

    # -- the reference's parameter tree, a contiguous cache ------------------

    def stacked_params(self) -> dict:
        """The module's parameters as the reference's tree: the layers'
        leaves stacked on a leading axis (a copy), the rest as they are —
        what ``decode_step`` and a mapped step take
        (``checkpoint.bridge.params_into`` is the inverse)."""
        flat = {"embed/table": self.embed.table,
                "final_norm/scale": self.final_norm.scale,
                "lm_head/w": self.lm_head.w}
        for key, attr in LAYER_LEAVES.items():
            flat[f"layers/block0/{key}"] = torch.stack([
                blk.get_parameter(attr) for blk in self.layers])
        return param_tree({k: flat[k] for k in leaf_shapes(self.cfg)})

    def init_cache(self, batch: int, max_len: int) -> dict:
        """The contiguous KV cache ``decode_step`` takes: ``{"layers":
        {"block0": {"k", "v"}}}``, each ``[n_layers, batch, max_len,
        n_kv, head_dim]`` of zeros in the model dtype."""
        cfg = self.cfg
        site = attention.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                       cfg.resolved_head_dim, self.dtype,
                                       self.device)
        return {"layers": {"block0": {
            name: t.expand(cfg.n_layers, *t.shape).clone()
            for name, t in site.items()}}}

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    pos: torch.Tensor):
        """One decode step against a contiguous cache, on ``params`` (the
        reference's tree, ``stacked_params()`` for this module's own):
        module-level ``decode_step`` with this model's config."""
        return decode_step(self.cfg, params, cache, token, pos)

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
