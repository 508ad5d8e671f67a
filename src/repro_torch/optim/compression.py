"""Gradient compression for the data-parallel all-reduce: the port of
``repro.optim.compression`` onto ``torch.distributed``.

int8 blockwise quantization with **error feedback** (the residual from
quantization is carried into the next step's gradient), the standard trick
that keeps compressed-SGD convergence on par with full precision: the
data-parallel all-reduce moves int codes where it would move float32
gradients.

The blockwise int8 pack/unpack lives in ``repro_torch.core.quant`` (one
implementation shared with the PIM weight datapath); this module keeps
the collective choreography and re-exports the helpers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.core import quant

BLOCK = quant.BLOCK


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8 [nblocks, BLOCK], scale f32 [nblocks, 1]); g flattened
    and zero-padded."""
    return quant.quantize_blockwise(g, "int8", BLOCK)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    like: torch.Tensor) -> torch.Tensor:
    return quant.dequantize_blockwise(q, scale, like, "int8")


def compressed_psum(grads, group=None, error=None):
    """Quantize -> all-reduce (int32 sum) -> dequantize, with error
    feedback, over the ranks of ``group`` (the default group when None).

    ``grads`` is this rank's gradient tree (plain tensors, the same
    structure on every rank); ``error`` the residual tree of the previous
    step (or None). Returns (reduced_grads, new_error): the reduced
    gradients are the ranks' mean, equal on every rank. Per leaf, in the
    reference's order: the block scales all-reduced by MAX (every rank
    quantizes against the same scales, so the int32 sum is exact), the
    codes all-reduced by SUM, the ranks counted by a SUM of ones; the mean
    is ``total * scale / n``."""

    def one(g, e):
        g32 = g.float()
        if e is not None:
            g32 = g32 + e
        _, scale = compress_int8(g32)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        flat = g32.reshape(-1)
        pad = (-flat.numel()) % BLOCK
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        q = torch.clamp(torch.round(flat.reshape(-1, BLOCK) / scale),
                        -127, 127).to(torch.int8)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        n = torch.ones((), dtype=torch.float32, device=g.device)
        dist.all_reduce(n, op=dist.ReduceOp.SUM, group=group)
        mean = total.float() * scale / n
        reduced = mean.reshape(-1)[:g.numel()].reshape(g.shape)
        # error feedback: what quantization dropped locally
        recon = (q.float() * scale).reshape(-1)[:g.numel()].reshape(g.shape)
        return reduced.to(g.dtype), g32 - recon

    if error is None:
        out = tree_map(lambda g: one(g, None), grads)
    else:
        out = tree_map(one, grads, error)
    is_pair = lambda t: isinstance(t, tuple)             # noqa: E731
    return (tree_map(lambda t: t[0], out, is_leaf=is_pair),
            tree_map(lambda t: t[1], out, is_leaf=is_pair))
