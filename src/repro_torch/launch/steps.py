"""Step functions and meta-device stand-ins for their inputs: the serve
parts of ``repro.launch.steps``.

``make_serve_step(cfg)`` is one decode step against a contiguous cache,
``(params, cache, token, pos) -> (logits, cache)``, on the reference's
parameter tree; ``abstract_params``, ``abstract_cache`` and
``decode_input_specs`` are its arguments on the meta device (shapes and
dtypes, nothing allocated), which the mapper traces
(``mapper.map_arch``). Not ported yet: the train step, its loss and
input specs (ROADMAP.md, queue item 3.2, the train half) and the
sharding rules (item 7).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch._device import torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer


def make_serve_step(cfg: ArchConfig) -> Callable:
    """(params, cache, token, pos) -> (logits, cache): one decode step."""

    def serve_step(params, cache, token, pos):
        return transformer.decode_step(cfg, params, cache, token, pos)

    return serve_step


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
