"""Shared neural-net layers: RMS norm, RoPE, SwiGLU MLP, embeddings.

Port of ``repro.models.layers``. The apply functions are plain tensor
functions with the reference's arithmetic (norm statistics in float32,
matmuls in the compute dtype); small ``nn.Module``s hold the weights in
the reference's layout (``x @ w``, weights ``[in, out]``), so the
checkpoint bridge copies leaves across without transposing. Sharding
constraints are dropped: the port runs on one device.

The functions are spelled as the reference's jaxpr has them, so that the
mapper traces the same priced ops (``repro_torch.core.estimator``): the
norm's mean as a sum divided by its length, RoPE's inverse frequencies
as a division, and ``rms_norm`` inside a ``"call"`` region, as the
reference's custom-VJP ``rms_norm`` is a call of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import estimator


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float | None = None) -> torch.Tensor:
    """Fill ``w`` in place with normal × ``scale`` (default fan_in^-0.5,
    fan_in = the leading dim) drawn in float32, then cast — the
    reference's ``_dense_init``. Different generator, so different
    numbers from the same seed."""
    fan_in = w.shape[0] if w.dim() > 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=torch.float32) * scale)
    return w


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    with estimator.region("call", "rms_norm"):
        x32 = x.float()
        var = x32.square().sum(-1, keepdim=True) / x32.shape[-1]
        y = x32 * torch.rsqrt(var + eps)
        return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    p = theta ** (ar / head_dim)
    return torch.full_like(p, 1.0) / p             # [head_dim / 2]


def _rotate(x, cos, sin):
    """Rotate pairs split by halves: x [..., rd]."""
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half: 2 * half]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               style: str = "full") -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]. Only the ``"full"`` style
    (llama) is ported; cos and sin are cast to ``x.dtype`` before the
    rotation, as in the reference."""
    if style != "full":
        raise NotImplementedError(
            f"rope_style={style!r} is not ported yet (ROADMAP.md, port "
            f"queue item 5: remaining model families)")
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * inv         # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
        w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.w_gate = empty_param((d_model, d_ff), dtype, device)
        self.w_up = empty_param((d_model, d_ff), dtype, device)
        self.w_down = empty_param((d_ff, d_model), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.w_gate, self.w_up, self.w_down)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype, device):
        super().__init__()
        self.table = empty_param((vocab, d_model), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        dense_init_(self.table, generator, scale=0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(tokens, self.table)


class LMHead(nn.Module):
    def __init__(self, d_model: int, vocab: int, dtype, device):
        super().__init__()
        self.w = empty_param((d_model, vocab), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        dense_init_(self.w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lm_head(x, self.w)
