"""Step functions and meta-device stand-ins for their inputs: the port of
``repro.launch.steps``.

``make_train_step(cfg)`` is one optimizer step, ``(params, opt_state,
batch) -> (params, opt_state, loss)``: the fused LM-head cross-entropy
of ``make_loss_fn``, its gradient by ``torch.func.grad_and_value`` (the
reference's ``jax.value_and_grad``) and the AdamW update; with
``cfg.grad_accum > 1`` the batch is split into that many microbatches,
one iteration of the ``"scan"`` region ``"microbatches"`` each, their
gradients summed in float32 and divided by their number (the reference's
``lax.scan`` over microbatches). ``make_prefill_step(cfg)`` is the
inference prefill, ``(params, batch) -> the last position's logits``.
``make_serve_step(cfg)`` is one decode step against a contiguous cache,
``(params, cache, token, pos) -> (logits, cache)``. All run on the
reference's parameter tree; ``abstract_params``, ``abstract_opt_state``,
``input_specs``, ``abstract_cache`` and ``decode_input_specs`` are their
arguments on the meta device (shapes and dtypes, nothing allocated),
which the mapper traces (``mapper.map_arch``).

A config with ``input_embed_stub`` takes ``batch["embeds"]`` [B, S, D]
(a modality frontend's output) where the others take ``batch["tokens"]``,
one with ``needs_position_grid`` ``batch["positions"]`` [3, B, S] besides,
and a tied head reads the embedding table's transpose. The
mixture-of-experts configs train as the dense ones do. Not ported yet:
the sharding rules (ROADMAP.md, queue item 7).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch._device import torch_dtype
from repro_torch._tree import tree_map
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import estimator
from repro_torch.models import attention, layers, transformer
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


def _model_inputs(cfg: ArchConfig, batch: dict) -> dict:
    """What ``transformer.hidden_states`` takes of ``batch``: ``tokens``
    or (``input_embed_stub``) ``embeds``, and ``positions`` where the
    config needs a position grid (the reference's ``loss_fn`` kwargs)."""
    kwargs = ({"embeds": batch["embeds"]} if cfg.input_embed_stub
              else {"tokens": batch["tokens"]})
    if cfg.needs_position_grid:
        kwargs["positions"] = batch["positions"]
    return kwargs


def make_loss_fn(cfg: ArchConfig) -> Callable:
    """(params, batch) -> loss: the hidden states, then the fused LM head
    and cross entropy over chunks of 512 tokens (``layers.fused_xent_head``;
    the float32 logits never exist whole); a tied head's weight is the
    embedding table's transpose. Every block pattern trains: the
    recurrent ones through ``transformer._RecurrentStack``."""

    def loss_fn(params, batch):
        head = transformer.head_weight(cfg, params)
        if cfg.tie_embeddings and not cfg.input_embed_stub:
            # the table read by the lookup and the head: its two
            # cotangents summed as the reference's add_any, unpriced
            table, tied = layers.fork(params["embed"]["table"])
            params = {**params, "embed": {**params["embed"], "table": table}}
            head = tied.t()
        x = transformer.hidden_states(cfg, params,
                                      **_model_inputs(cfg, batch))
        n_chunks = max(1, x.shape[1] // 512)
        return layers.fused_xent_head(x, head, batch["labels"], n_chunks)

    return loss_fn


def _microbatches(batch: dict, accum: int) -> dict:
    """Each leaf split along the batch axis into ``accum`` microbatches,
    stacked on a new leading axis (``positions`` [3, B, S] ->
    [A, 3, B/A, S], as the reference splits it)."""
    def split(key, x):
        if key == "positions":
            return x.reshape(3, accum, x.shape[1] // accum, -1).movedim(1, 0)
        return x.reshape(accum, x.shape[0] // accum, *x.shape[1:])

    return {k: split(k, v) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, *, optimizer_name: str = "adamw",
                    lr: float = 3e-4) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, loss): one step
    of ``optimizer_name`` on the loss of ``make_loss_fn``. ``grad_accum
    > 1`` splits the batch into microbatches run one after another, the
    gradients accumulated in float32 (activations shrink with the
    microbatch; the module docstring)."""
    opt = make_optimizer(optimizer_name, lr=lr,
                         state_dtype=cfg.opt_state_dtype)
    loss_fn = make_loss_fn(cfg)
    accum = max(cfg.grad_accum, 1)

    def train_step(params, opt_state, batch):
        if accum == 1:
            grads, loss = torch.func.grad_and_value(loss_fn)(params, batch)
        else:
            n = batch["labels"].shape[0]
            assert n % accum == 0, (
                f"global batch {n} not divisible by grad_accum={accum}")
            micro = _microbatches(batch, accum)
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
            for i in range(accum):
                with estimator.region("scan", "microbatches"):
                    mb = {k: v[i] for k, v in micro.items()}
                    g, l = torch.func.grad_and_value(loss_fn)(params, mb)
                    g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
                    loss = loss + l
                    del g          # not alive beside the next one's
            loss = loss / accum
            grads = tree_map(lambda g, p: (g / accum).to(p.dtype), g_acc,
                             params)
            # the float32 sums go before the update makes its new state
            del g_acc
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def _last_position(logits: torch.Tensor) -> torch.Tensor:
    """``logits[:, -1]`` as the reference indexes it: the index -1
    normalized by jnp (the add its graph prices), then a dynamic slice."""
    at = attention._wrapped(torch.full((), -1, dtype=torch.int32,
                                       device=logits.device),
                            logits.shape[1])
    return estimator.dynamic_slice(logits, at, 1, 1)[:, 0]


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(params, batch) -> the last position's logits [B, V] (inference
    prefill): ``transformer.apply`` on ``batch["tokens"]`` (or ``embeds``,
    and ``positions``, as ``make_loss_fn`` reads them), its stack the
    undifferentiated one (every block pattern), under ``torch.no_grad``."""

    def prefill_step(params, batch):
        with torch.no_grad():
            return _last_position(transformer.apply(
                cfg, params, **_model_inputs(cfg, batch)))

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """(params, cache, token, pos) -> (logits, cache): one decode step."""

    def serve_step(params, cache, token, pos):
        return transformer.decode_step(cfg, params, cache, token, pos)

    return serve_step


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The batch of a train (or prefill) step of ``shape`` on the meta
    device: ``{"tokens", "labels"}``, each [B, S] int32 (the keys in
    ``data.pipeline.TokenStream``'s order, which a traced step's batch
    must keep); under ``input_embed_stub`` ``{"embeds", "labels"}``, the
    embeddings [B, S, D] in the model dtype; with
    ``needs_position_grid`` the grid ``positions`` [3, B, S] int32 last
    (the reference's keys, in their sorted order)."""
    b, s = shape.global_batch, shape.seq_len

    def ints(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if cfg.input_embed_stub:
        batch = {"embeds": torch.empty((b, s, cfg.d_model),
                                       dtype=torch_dtype(cfg.dtype),
                                       device="meta"),
                 "labels": ints(b, s)}
    else:
        batch = {"tokens": ints(b, s), "labels": ints(b, s)}
    if cfg.needs_position_grid:
        batch["positions"] = ints(3, b, s)
    return batch


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
