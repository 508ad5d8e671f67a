"""Shared neural-net layers: RMS norm, RoPE, SwiGLU MLP, embeddings.

Port of ``repro.models.layers``. The apply functions are plain tensor
functions with the reference's arithmetic (norm statistics in float32,
matmuls in the compute dtype); small ``nn.Module``s hold the weights in
the reference's layout (``x @ w``, weights ``[in, out]``), so the
checkpoint bridge copies leaves across without transposing. The MLP's
hidden activation and the head's logits carry the reference's layout
hints (``parallel.sharding.constrain``: a no-op without rules and a mesh).

The functions are spelled as the reference's jaxpr has them, so that the
mapper traces the same priced ops (``repro_torch.core.estimator``): the
norm's mean as a sum divided by its length, RoPE's inverse frequencies
as a division, and ``rms_norm`` inside a ``"call"`` region, as the
reference's custom-VJP ``rms_norm`` is a call of its own. ``rms_norm``
and ``fused_xent_head`` are ``autograd.Function``s whose backward passes
are the reference's custom VJPs, op for op.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import estimator
from repro_torch.parallel import sharding


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


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """The norm's forward, in its ``"call"`` region (the reference's
    custom-VJP ``rms_norm`` is a call of its own)."""
    with estimator.region("call", "rms_norm"):
        x32 = x.float()
        var = x32.square().sum(-1, keepdim=True) / x32.shape[-1]
        y = x32 * torch.rsqrt(var + eps)
        return (y * scale.float()).to(x.dtype)


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                 eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_rms_bwd`` op for op: (dx, dscale) from the saved
    input alone. Outside any region: the reference's transpose inlines the
    custom VJP's backward where the cotangent flows, so its edges run on
    into the ops around it."""
    x32 = x.float()
    g32 = g.float()
    s32 = scale.float()
    n = x.shape[-1]
    r = torch.rsqrt(x32.square().sum(-1, keepdim=True) / n + eps)
    gs = g32 * s32
    dot = (gs * x32).sum(-1, keepdim=True)
    dx = r * gs - r.pow(3) * x32 * (dot / n)
    rows = tuple(range(x.dim() - 1))
    dscale = sharding.mergeable(g32 * x32 * r, rows).reshape(-1, n).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    """``rms_norm`` with the reference's custom VJP (``rms_norm_bwd``)."""

    @staticmethod
    def forward(x, scale, eps):
        return rms_norm_fwd(x, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, ctx.eps = inputs
        ctx.save_for_backward(x, scale)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return (*rms_norm_bwd(x, scale, g, ctx.eps), None)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    return _RMSNorm.apply(x, scale, eps)


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


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Per-head q/k norm (qwen3) over the last (head_dim) axis, in float32
    and cast back: the reference's ``head_rms_norm``, which has no custom
    VJP (its ops are the ones its graph prices: the mean as a sum divided
    by its length, then the two products)."""
    return head_rms_norm_parts(x, scale, eps)[0]


def head_rms_norm_parts(x: torch.Tensor, scale: torch.Tensor, eps: float,
                        lin: bool = False) -> tuple[torch.Tensor, dict]:
    """``head_rms_norm`` and what its VJP reads (the written-out stack's,
    ``models.transformer._head_norm_bwd``): ``a`` the float32 input, ``j``
    its rsqrt, ``m = a·j``. ``lin``: the forward of a differentiated
    layer, spelled as the reference's linearization emits it, with ``e =
    2·a`` (the square's derivative) and ``l = -0.5·j/i`` (rsqrt's), each
    where its rule runs, priced; else both None."""
    a = x.float()
    sq = a.square()
    e = a * 2.0 if lin else None
    i = sq.sum(-1, keepdim=True) / x.shape[-1] + eps
    j = torch.rsqrt(i)
    l = (j / i) * -0.5 if lin else None
    m = a * j
    return (m * scale.float()).to(x.dtype), dict(a=a, e=e, j=j, l=l, m=m)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device,
               rotary_dim: int | None = None) -> torch.Tensor:
    """The inverse frequencies [rd / 2] of a rotation over the first
    ``rd = rotary_dim or head_dim`` dims (the exponent divided by ``rd``,
    as the reference's ``rope_freqs``)."""
    rd = rotary_dim or head_dim
    ar = torch.arange(0, rd, 2, dtype=torch.float32, device=device)
    p = theta ** (ar / rd)
    return torch.full_like(p, 1.0) / p             # [rd / 2]


def rotary_dim(head_dim: int, style: str) -> int:
    """The dims a ``style`` rotation turns: all of them, or the first half
    under ``"half"`` (chatglm's 2d RoPE), the rest passed through."""
    return head_dim // 2 if style == "half" else head_dim


def rotate(x, cos, sin):
    """Rotate pairs split by halves: x [..., rd]."""
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half: 2 * half]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rotate_partial(x, cos, sin):
    """``rotate`` over the first ``rd = 2 * cos.shape[-1]`` dims of x, the
    rest passed through (the reference's ``"half"`` branch: the rotated
    dims concatenated with the others); ``rotate`` itself where rd is the
    whole head."""
    rd = 2 * cos.shape[-1]
    if rd == x.shape[-1]:
        return rotate(x, cos, sin)
    return torch.cat([rotate(x[..., :rd], cos, sin), x[..., rd:]], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               style: str = "full",
               sections: tuple[int, ...] = ()) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S], or [3, B, S] under ``"mrope"``
    (qwen2-vl's temporal / height / width grid). ``"full"`` rotates every
    dim (llama), ``"half"`` the first D/2 (chatglm), ``"mrope"`` every dim,
    each section of the frequencies turned by its own grid row, ``"none"``
    none; cos and sin are cast to ``x.dtype`` before the rotation, as in
    the reference."""
    table = rope_table_for(x.shape[-1], positions, x.dtype, theta=theta,
                           style=style, sections=sections)
    return x if table is None else rotate_partial(x, *table)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
        w_down: torch.Tensor) -> torch.Tensor:
    return _constrain_hidden(F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _constrain_hidden(h: torch.Tensor) -> torch.Tensor:
    """The MLP's hidden activation on the model axis, rank-agnostic:
    [B, S, F] in blocks, [T, F] in the MoE shared expert."""
    return sharding.constrain(
        h, ("batch",) + (None,) * (h.dim() - 2) + ("mlp",))


def mlp_parts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor
              ) -> dict:
    """``mlp``'s forward up to the down projection: what its VJP reads
    (``mlp_bwd``)."""
    gate = x @ w_gate
    up = x @ w_up
    sg = F.silu(gate)
    return dict(gate=gate, up=up, sg=sg, hm=_constrain_hidden(sg * up))


def weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``w`` in ``x @ w``: ``xᵀg`` over the flattened
    rows, [in, out] (the reference's ``dot_general(g, x)`` transposed;
    ``estimator.mm_transposed``)."""
    rows = tuple(range(x.dim() - 1))
    x, g = sharding.mergeable(x, rows), sharding.mergeable(g, rows)
    return x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])


def mlp_bwd(ct: torch.Tensor, x: torch.Tensor, r: dict, w_gate, w_up,
            w_down) -> tuple[torch.Tensor, dict]:
    """``mlp``'s VJP from its input ``x`` and ``mlp_parts``' values ``r``:
    (the cotangent of ``x``, ``{"w_down", "w_up", "w_gate"}``), the ops
    in the order the reference's transpose emits them (the down
    projection first, each weight's cotangent before its input's, the
    sum unpriced: ``estimator.add_any``)."""
    grads = {"w_down": weight_grad(r["hm"], ct)}
    dhm = ct @ w_down.t()
    ct_up = r["sg"] * dhm
    ct_sg = dhm * r["up"]
    ct_gate = estimator.silu_vjp(ct_sg, r["gate"])
    grads["w_up"] = weight_grad(x, ct_up)
    dx_up = ct_up @ w_up.t()
    grads["w_gate"] = weight_grad(x, ct_gate)
    dx_gate = ct_gate @ w_gate.t()
    return estimator.add_any(dx_up, dx_gate), grads


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


class _Fork(torch.autograd.Function):
    """``x`` read by two consumers: two views of it, whose cotangents sum
    unpriced (``estimator.add_any``), as JAX sums a value's cotangents,
    where autograd would accumulate them at ``x`` with an ``add``."""

    @staticmethod
    def forward(x):
        return x.view_as(x), x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ga, gb):
        if ga is None or gb is None:
            return gb if ga is None else ga
        with torch.no_grad():
            return estimator.add_any(ga, gb)


def fork(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two views of ``x`` for two consumers (``_Fork``): a tied
    embedding table, read by the lookup and by the LM head."""
    return _Fork.apply(x)


def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return sharding.constrain(x @ w, ("batch", None, "vocab"))


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


# ---------------------------------------------------------------------------
# fused LM head + cross-entropy (the reference's custom VJP)
# ---------------------------------------------------------------------------
# The float32 logits [tokens, vocab] never exist whole: the forward keeps
# each sequence chunk's logsumexp, the backward recomputes the chunk's
# logits and feeds dx and dw from them. Each chunk is one iteration of a
# "scan" region ("xent" forward, "xent.T" backward: two loops, two names),
# so the mapper folds them as the reference's two scans, even at one
# chunk, and its lowering runs them natively.


def _xent_chunks(x, labels, n_chunks: int):
    """x [B, S, D] and labels [B, S] as n_chunks chunks along S:
    ([C, B, S/C, D], [C, B, S/C])."""
    b, s, d = x.shape
    sc = s // n_chunks
    return (x.reshape(b, n_chunks, sc, d).movedim(1, 0),
            labels.reshape(b, n_chunks, sc).movedim(1, 0))


def _chunk_logits(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The chunk's logits in float32 (the reference's einsum with
    ``preferred_element_type=float32``: bfloat16 products are exact in
    float32, so the operands are widened first)."""
    return xc.float() @ w.float()


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.logsumexp`` over the last axis as its jaxpr spells it: a
    max that is 0 where not finite, subtracted and added back."""
    m = x.amax(-1)
    m = torch.where(m.abs() < math.inf, m, torch.zeros_like(m))
    s = torch.exp(x - m[..., None]).sum(-1)
    return torch.log(s.abs()) + m


class _FusedXentHead(torch.autograd.Function):
    """``fused_xent_head`` with the reference's custom VJP: outputs the
    loss and each chunk's logsumexp (saved for the backward, not
    differentiable)."""

    @staticmethod
    def forward(x, w, labels, n_chunks):
        b, s, _ = x.shape
        # a DTensor x split along the sequence gathered whole first (the
        # chunks' views split it); again in the backward, from the input
        xr, lr = _xent_chunks(sharding.unshard(x, 1), labels, n_chunks)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for c in range(n_chunks):
            with estimator.region("scan", "xent"):
                logits = _chunk_logits(xr[c], w)
                lse = logsumexp(logits)
                # the gather reads whole vocab rows: DTensor's rule for
                # a gather along a sharded dim fails on the [..., 0]
                gold = torch.take_along_dim(
                    sharding.unshard(logits, -1), lr[c][..., None].long(),
                    -1)[..., 0]
                total = total + (lse - gold).sum()
                lses.append(lse)
        return total / (b * s), torch.stack(lses)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, labels, ctx.n_chunks = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, labels, output[1])

    @staticmethod
    def backward(ctx, g, _):
        x, w, labels, lses = ctx.saved_tensors
        x = sharding.unshard(x, 1)
        b, s, d = x.shape
        n_tok = b * s
        xr, lr = _xent_chunks(x, labels, ctx.n_chunks)
        vocab = w.shape[1]
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dxs = []
        for c in range(ctx.n_chunks):
            with estimator.region("scan", "xent.T"):
                xc = xr[c]
                logits = _chunk_logits(xc, w)
                p = torch.exp(logits - lses[c][..., None])
                onehot = (lr[c][..., None] == torch.arange(
                    vocab, device=w.device)).float()
                dlogits = (p - onehot) * (g / n_tok)
                dxs.append(dlogits.to(x.dtype) @ w.t())
                # dw as the reference's dot_general(xc, dlogits): the
                # product dlogitsᵀ·xc, transposed (estimator.mm_transposed)
                dw = dw + (dlogits.reshape(-1, vocab).t()
                           @ xc.float().reshape(-1, d)).t()
        dx = torch.stack(dxs).movedim(0, 1).reshape(b, s, d).to(x.dtype)
        return dx, dw.to(w.dtype), None, None


def fused_xent_head(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    n_chunks: int = 8) -> torch.Tensor:
    """mean_t [logsumexp(x_t W) - (x_t W)[label_t]]; x [B, S, D], w [D, V],
    labels [B, S] int: the reference's ``fused_xent_head``, its custom VJP
    included."""
    return _FusedXentHead.apply(x, w, labels, n_chunks)[0]


def rope_table(head_dim: int, theta: float, positions: torch.Tensor,
               dtype, rotary_dim: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``apply_rope``'s (cos, sin), each [B, S, 1, rd / 2] in ``dtype``,
    for a rotation over the first ``rd = rotary_dim or head_dim`` dims."""
    inv = rope_freqs(head_dim, theta, positions.device, rotary_dim)
    ang = positions[..., None].float() * inv
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def mrope_table(head_dim: int, theta: float, positions: torch.Tensor,
                dtype, sections: tuple[int, ...]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE's (cos, sin), each [B, S, 1, head_dim / 2] in ``dtype``, from
    the grid ``positions`` [3, B, S]: the inverse frequencies of the whole
    head split at the sections' running sums, each chunk times its own grid
    row, the angles concatenated (the reference's ``"mrope"`` branch)."""
    if positions.dim() != 3:
        raise ValueError(f"mrope needs [3, B, S] positions, got "
                         f"{tuple(positions.shape)}")
    inv = rope_freqs(head_dim, theta, positions.device)
    splits = list(itertools.accumulate(sections))[:-1]
    ang = torch.cat([positions[i][..., None].float() * chunk
                     for i, chunk in enumerate(torch.tensor_split(inv,
                                                                  splits))],
                    -1)
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def rope_table_for(head_dim: int, positions: torch.Tensor, dtype, *,
                   theta: float, style: str,
                   sections: tuple[int, ...] = ()):
    """The (cos, sin) a ``style`` rotation turns a head by (``rope_table``,
    or ``mrope_table`` over a position grid); None under ``"none"``."""
    if style == "none":
        return None
    if style == "mrope":
        return mrope_table(head_dim, theta, positions, dtype, sections)
    if style not in ("full", "half"):
        raise ValueError(f"rope_style={style!r}")
    return rope_table(head_dim, theta, positions, dtype,
                      rotary_dim(head_dim, style))
