"""Mixture-of-experts layer: the port of ``repro.models.moe`` — a top-k
router and grouped, capacity-bounded dispatch (GShard-style groups).

The tokens are split into ``G`` groups; each group dispatches to a
per-group capacity buffer ``[G, E, C, D]``. The slot -> token map is a
small flat int32 scatter (``G·E·C`` ints and one dump lane for the
assignments past capacity), and the activations move with fixed-shape
gathers: no shape depends on the data and nothing is read back to the
host, so a mapped step runs with no host sync.

The ops are spelled so that a trace (``core.estimator.capture``) holds
the reference's priced nodes in its order: the softmax as its ``sub``
and ``div``; the integer ``sub``/``mul``/``add`` of the positions and
slots as aten ops (the estimator prices them whatever their dtype, as
the reference's does); each scatter's indices normalized as jnp's
``.at[].set`` normalizes them (``attention._wrapped``, its priced add);
and each expert product as the ``bmm`` ``[E, F, D] @ [E, D, G·C]``, the
reference's ``dot_general(w, buf)`` with the weight as the lhs, so the
dispatch buffer is the product's stationary operand. Top-k keeps the
reference's tie order (the lower index first among equal
probabilities): a stable descending sort, then the first ``k``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers


def experts_init_(w: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """Fill an expert leaf ``[E, ...]`` in place with normal ×
    fan_in^-0.5, the fan-in its leading dim (``E``, as the reference's
    ``_dense_init`` reads it), drawn one expert at a time: a whole float32
    draw of llama4-maverick's ``[128, 5120, 8192]`` would hold 21 GB
    twice on the card."""
    for e in range(w.shape[0]):
        layers.dense_init_(w[e], generator, w.shape[0] ** -0.5)
    return w


def init_moe(generator: torch.Generator, d_model: int, n_experts: int,
             d_ff: int, dtype, device, *, shared_expert: bool = False,
             shared_d_ff: int = 0) -> dict:
    """The reference's ``init_moe`` tree, drawn from ``generator``: the
    router normal × 0.02, the experts by ``experts_init_``, an optional
    shared SwiGLU expert (normal × fan_in^-0.5)."""
    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    p = {"router": layers.dense_init_(empty(d_model, n_experts), generator,
                                      0.02),
         **{name: experts_init_(empty(n_experts, *shape), generator)
            for name, shape in (("w_gate", (d_model, d_ff)),
                                ("w_up", (d_model, d_ff)),
                                ("w_down", (d_ff, d_model)))}}
    if shared_expert:
        f = shared_d_ff or d_ff
        p["shared_expert"] = {
            name: layers.dense_init_(empty(*shape), generator)
            for name, shape in (("w_gate", (d_model, f)),
                                ("w_up", (d_model, f)),
                                ("w_down", (f, d_model)))}
    return p


def capacity(tokens_per_group: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert and group: ``ceil(TL·k / E · factor)`` rounded up
    to a multiple of 8, at least 8."""
    c = int(math.ceil(tokens_per_group * top_k / n_experts
                      * capacity_factor))
    return max(8, -(-c // 8) * 8)


def _n_groups(cfg: ArchConfig, t: int) -> int:
    return math.gcd(getattr(cfg, "moe_groups", 32), t)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: (values, int32 indices), the
    lower index first among ties (``torch.topk`` does not promise it)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def route(x: torch.Tensor, router: torch.Tensor, cfg: ArchConfig) -> dict:
    """The router and the dispatch maps of ``moe_block`` for ``x`` [B, S,
    D]: ``xg`` [G, TL, D], ``gate_w`` [G, TL, k] float32 (renormalized),
    ``flat_e`` [G, TL·k] int32 expert of each assignment (token-major,
    k-minor), ``keep`` [G, TL·k] (within capacity), ``pos_c`` (its slot in
    the expert, 0 where dropped), ``slot_token`` / ``slot_valid`` [G,
    E·C] (the token a slot holds, whether it holds one) and the sizes
    ``grp``, ``tl``, ``c``."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    grp = _n_groups(cfg, t)
    tl = t // grp
    c = capacity(tl, e, k, cfg.capacity_factor)
    dev = x.device

    xg = x.reshape(grp, tl, d)
    logits = (xg @ router).float()                          # [G,TL,E]
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = ex / ex.sum(-1, keepdim=True)
    gate_w, gate_idx = top_k(probs, k)                      # [G,TL,k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)

    # position of each assignment within its expert, per group
    flat_e = gate_idx.reshape(grp, tl * k)                  # [G,TL*k]
    oh = (flat_e[..., None] == torch.arange(
        e, dtype=torch.int32, device=dev)).to(torch.int32)  # [G,TL*k,E]
    pos = ((torch.cumsum(oh, 1, dtype=torch.int32) - 1) * oh).sum(
        -1, dtype=torch.int32)                              # [G,TL*k]
    keep = pos < c
    pos_c = torch.where(keep, pos, 0)

    # slot -> token map: a flat int32 scatter with a dump lane
    n_slots = grp * e * c
    g_ids = torch.arange(grp, dtype=torch.int32, device=dev)[:, None]
    slot = (g_ids * (e * c) + flat_e * c + pos_c).reshape(-1)
    slot = torch.where(keep.reshape(-1), slot, n_slots)
    token_ids = (torch.arange(tl * k, dtype=torch.int32, device=dev)
                 // k)[None].expand(grp, tl * k).reshape(-1)
    slot_token = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    slot_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    slot_token = slot_token.scatter(
        0, attention._wrapped(slot, n_slots + 1).long(), token_ids)
    slot_valid = slot_valid.scatter(
        0, attention._wrapped(slot, n_slots + 1).long(), True)
    return dict(xg=xg, gate_w=gate_w, flat_e=flat_e, keep=keep, pos_c=pos_c,
                slot_token=slot_token[:-1].reshape(grp, e * c),
                slot_valid=slot_valid[:-1].reshape(grp, e * c),
                grp=grp, tl=tl, c=c)


def _experts(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("gecd,edf->gecf", buf, w)`` as the reference traces it:
    the batched product ``[E, F, D] @ [E, D, G·C]`` (the weight the lhs),
    its value viewed ``[E, F, G, C]``, then laid out ``[G, E, C, F]``."""
    g, e, c, d = buf.shape
    rhs = buf.permute(1, 3, 0, 2).reshape(e, d, g * c)
    out = torch.bmm(w.transpose(1, 2), rhs).view(e, w.shape[2], g, c)
    return out.permute(2, 0, 3, 1)


def moe_block(x: torch.Tensor, params: dict, cfg: ArchConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]; ``params`` the reference's tree
    (``router``, ``w_gate``, ``w_up``, ``w_down``, optional
    ``shared_expert``). Assignments past an expert's capacity are
    dropped (their token gets nothing from that expert)."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    r = route(x, params["router"], cfg)
    grp, tl, c, keep = r["grp"], r["tl"], r["c"], r["keep"]

    # dispatch: a gather over the group's tokens
    buf = torch.take_along_dim(r["xg"], r["slot_token"][..., None].long(),
                               dim=1)
    buf = torch.where(r["slot_valid"][..., None], buf, 0)
    buf = buf.reshape(grp, e, c, d)

    # expert FFN (SwiGLU), batched over experts
    g_ = _experts(buf, params["w_gate"])
    u_ = _experts(buf, params["w_up"])
    h = F.silu(g_) * u_
    out_buf = _experts(h, params["w_down"])                 # [G,E,C,D]

    # combine: gather back by (expert, position), weight, sum over k
    comb_idx = r["flat_e"] * c + r["pos_c"]                 # [G,TL*k]
    gathered = torch.take_along_dim(out_buf.reshape(grp, e * c, d),
                                    comb_idx[..., None].long(), dim=1)
    gathered = torch.where(keep[..., None], gathered, 0)    # [G,TL*k,D]
    gathered = gathered.reshape(grp, tl, k, d)
    out = (gathered * r["gate_w"][..., None].to(x.dtype)).sum(2)

    if "shared_expert" in params:
        se = params["shared_expert"]
        out = out + layers.mlp(r["xg"], se["w_gate"], se["w_up"],
                               se["w_down"])
    return out.reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, gate_idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (optional, train time):
    ``E · sum(mean prob · share of assignments)`` per expert."""
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, n_experts)
    me = probs.mean(0)
    ce = torch.bincount(gate_idx.reshape(-1).long(),
                        minlength=n_experts)[:n_experts].float()
    ce = ce / torch.clamp_min(ce.sum(), 1.0)
    return n_experts * torch.sum(me * ce)


class MoE(nn.Module):
    """The MoE FFN of one block: ``router`` [D, E], ``w_gate`` / ``w_up``
    [E, D, F], ``w_down`` [E, F, D] and, with ``cfg.shared_expert``, a
    ``shared_expert`` SwiGLU MLP at ``cfg.d_ff``; ``forward`` is
    ``moe_block`` on them."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.cfg = cfg
        self.router = layers.empty_param((d, e), dtype, device)
        self.w_gate = layers.empty_param((e, d, f), dtype, device)
        self.w_up = layers.empty_param((e, d, f), dtype, device)
        self.w_down = layers.empty_param((e, f, d), dtype, device)
        self.shared_expert = (layers.MLP(d, cfg.d_ff, dtype, device)
                              if cfg.shared_expert else None)

    def init(self, generator: torch.Generator) -> None:
        layers.dense_init_(self.router, generator, 0.02)
        for w in (self.w_gate, self.w_up, self.w_down):
            experts_init_(w, generator)

    def tree(self) -> dict:
        """The parameters as the reference's ``moe`` subtree."""
        p = {"router": self.router, "w_gate": self.w_gate,
             "w_up": self.w_up, "w_down": self.w_down}
        if self.shared_expert is not None:
            se = self.shared_expert
            p["shared_expert"] = {"w_gate": se.w_gate, "w_up": se.w_up,
                                  "w_down": se.w_down}
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_block(x, self.tree(), self.cfg)
