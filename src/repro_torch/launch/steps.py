"""Step functions and meta-device stand-ins for their inputs: the port of
``repro.launch.steps``.

``make_train_step(cfg)`` is one optimizer step, ``(params, opt_state,
batch) -> (params, opt_state, loss)``: the fused LM-head cross-entropy
of ``make_loss_fn``, its gradient by ``torch.func.grad_and_value`` (the
reference's ``jax.value_and_grad``) and the AdamW update.
``make_serve_step(cfg)`` is one decode step against a contiguous cache,
``(params, cache, token, pos) -> (logits, cache)``. Both run on the
reference's parameter tree; ``abstract_params``, ``abstract_opt_state``,
``input_specs``, ``abstract_cache`` and ``decode_input_specs`` are their
arguments on the meta device (shapes and dtypes, nothing allocated),
which the mapper traces (``mapper.map_arch``).

Not ported yet: ``grad_accum > 1`` (a scan over microbatches; ROADMAP.md,
queue item 3.8), ``make_prefill_step`` (item 3.9), embedding inputs and
position grids (item 5) and the sharding rules (item 7).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch._device import torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import layers, transformer
from repro_torch.optim import make_optimizer


def token_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in float32, chunked over the sequence
    in chunks of 2048 where it divides (the reference's ``token_xent``)."""
    def chunk_loss(lg, lb):
        lg32 = lg.float()
        gold = torch.take_along_dim(lg32, lb[..., None].long(), -1)[..., 0]
        return layers.logsumexp(lg32) - gold

    b, s, v = logits.shape
    n_chunks = max(1, s // 2048)
    if s % n_chunks == 0 and n_chunks > 1:
        lg = logits.reshape(b, n_chunks, s // n_chunks, v).movedim(1, 0)
        lb = labels.reshape(b, n_chunks, s // n_chunks).movedim(1, 0)
        return torch.stack([chunk_loss(lg[c], lb[c])
                            for c in range(n_chunks)]).mean()
    return chunk_loss(logits, labels).mean()


def make_loss_fn(cfg: ArchConfig) -> Callable:
    """(params, batch) -> loss: the hidden states, then the fused LM head
    and cross entropy over chunks of 512 tokens (``layers.fused_xent_head``;
    the float32 logits never exist whole)."""
    if cfg.input_embed_stub or cfg.needs_position_grid:
        raise NotImplementedError(
            "embedding inputs and position grids are not ported yet "
            "(ROADMAP.md, queue item 5: remaining model families)")

    def loss_fn(params, batch):
        x = transformer.hidden_states(cfg, params, batch["tokens"])
        n_chunks = max(1, x.shape[1] // 512)
        return layers.fused_xent_head(x, params["lm_head"]["w"],
                                      batch["labels"], n_chunks)

    return loss_fn


def make_train_step(cfg: ArchConfig, *, optimizer_name: str = "adamw",
                    lr: float = 3e-4) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, loss): one step
    of ``optimizer_name`` on the loss of ``make_loss_fn``. ``grad_accum
    > 1`` raises."""
    if cfg.grad_accum > 1:
        raise NotImplementedError(
            "grad_accum > 1 (a scan over microbatches) is not ported yet "
            "(ROADMAP.md, queue item 3.8)")
    opt = make_optimizer(optimizer_name, lr=lr,
                         state_dtype=cfg.opt_state_dtype)
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        grads, loss = torch.func.grad_and_value(loss_fn)(params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """(params, cache, token, pos) -> (logits, cache): one decode step."""

    def serve_step(params, cache, token, pos):
        return transformer.decode_step(cfg, params, cache, token, pos)

    return serve_step


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The batch of a train step of ``shape`` on the meta device:
    ``{"tokens", "labels"}``, each [B, S] int32 (the keys in
    ``data.pipeline.TokenStream``'s order, which a traced step's batch
    must keep)."""
    b, s = shape.global_batch, shape.seq_len
    return {name: torch.empty((b, s), dtype=torch.int32, device="meta")
            for name in ("tokens", "labels")}


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    """(token, pos) stand-ins for one serve_step with a ``seq_len`` cache:
    token [B] int32, pos a 0-d int32."""
    token = torch.empty((shape.global_batch,), dtype=torch.int32,
                        device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return token, pos


def abstract_params(cfg: ArchConfig) -> dict:
    """The reference's parameter tree on the meta device."""
    dtype = torch_dtype(cfg.dtype)
    return transformer.param_tree({
        key: torch.empty(shape, dtype=dtype, device="meta")
        for key, shape in transformer.leaf_shapes(cfg).items()})


def abstract_cache(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``DecoderLM.init_cache(batch, seq_len)`` on the meta device."""
    return transformer.DecoderLM(cfg, device="meta").init_cache(
        shape.global_batch, shape.seq_len)


def abstract_opt_state(cfg: ArchConfig, params_shapes,
                       optimizer_name: str = "adamw") -> dict:
    """The optimizer's initial state for ``params_shapes`` on their
    (meta) device."""
    opt = make_optimizer(optimizer_name, lr=1e-3,
                         state_dtype=cfg.opt_state_dtype)
    return opt.init(params_shapes)
