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

The block trains: ``moe_forward`` keeps what the VJP reads (with the
reference's linearized forward: the clamped sum's tie factor, a priced
``div``), and ``moe_block_bwd`` is the reference's transpose written out
op for op. Each gather's transpose (the combine's into the capacity
buffer, the dispatch's into the tokens, top-k's into the router's
probabilities) is ``estimator.scatter_add``: a sum over duplicate
indices in a fixed order, so a step gives the same bits on every run,
and unpriced, as the reference's ``scatter-add``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimator
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


def group_offsets(cfg: ArchConfig, t: int, device) -> torch.Tensor:
    """``g_ids * (E·C)`` [G, 1] int32, each group's first slot for ``t``
    tokens: the slot map's one term that reads no input, which the
    reference's linearization hoists out of its layer scan (a train
    step's stack takes it from outside, ``route(g_off=...)``)."""
    grp = _n_groups(cfg, t)
    c = capacity(t // grp, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    return torch.arange(grp, dtype=torch.int32, device=device)[:, None] * (
        cfg.n_experts * c)


def route(x: torch.Tensor, router: torch.Tensor, cfg: ArchConfig, *,
          lin: bool = False, g_off: torch.Tensor | None = None) -> dict:
    """The router and the dispatch maps of ``moe_block`` for ``x`` [B, S,
    D]: ``xg`` [G, TL, D], ``gate_w`` [G, TL, k] float32 (renormalized),
    ``flat_e`` [G, TL·k] int32 expert of each assignment (token-major,
    k-minor), ``keep`` [G, TL·k] (within capacity), ``pos_c`` (its slot in
    the expert, 0 where dropped), ``slot_token`` / ``slot_valid`` [G,
    E·C] (the token a slot holds, whether it holds one) and the sizes
    ``grp``, ``tl``, ``c``; and what the VJP reads: the softmax's ``ex``
    and ``ssum``, top-k's ``vals`` and ``idx``, the clamped sum ``m``.
    ``lin``: also ``factor``, the share of the sum's cotangent that
    ``max(sum, 1e-9)`` passes (JAX's balanced tie rule: 1, ½ at a tie, 0
    clamped), a priced ``div`` of the reference's linearized forward.
    ``g_off``: ``group_offsets``, made outside (None: here)."""
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
    ssum = ex.sum(-1, keepdim=True)
    probs = ex / ssum
    vals, gate_idx = top_k(probs, k)                        # [G,TL,k]
    tot = vals.sum(-1, keepdim=True)
    m = torch.clamp_min(tot, 1e-9)
    r = dict(ex=ex, ssum=ssum, vals=vals, idx=gate_idx, m=m)
    if lin:
        r["factor"] = (tot == m).float() / torch.where(m == 1e-9, 2.0, 1.0)
    gate_w = vals / m

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
    if g_off is None:
        g_off = group_offsets(cfg, t, dev)
    slot = (g_off + flat_e * c + pos_c).reshape(-1)
    slot = torch.where(keep.reshape(-1), slot, n_slots)
    token_ids = (torch.arange(tl * k, dtype=torch.int32, device=dev)
                 // k)[None].expand(grp, tl * k).reshape(-1)
    slot_token = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    slot_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    slot_token = slot_token.scatter(
        0, attention._wrapped(slot, n_slots + 1).long(), token_ids)
    slot_valid = slot_valid.scatter(
        0, attention._wrapped(slot, n_slots + 1).long(), True)
    return dict(r, xg=xg, gate_w=gate_w, flat_e=flat_e, keep=keep,
                pos_c=pos_c, slot_token=slot_token[:-1].reshape(grp, e * c),
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


# what the VJP reads of a block without a shared expert (``moe_forward``
# with ``lin``); the shared expert's are ``layers.mlp_parts``'
RESIDUALS = ("ex", "ssum", "vals", "idx", "m", "factor", "w", "keep", "comb",
             "gathered", "valid", "tok", "buf", "g", "sg", "u", "h")
SHARED_RESIDUALS = ("s_gate", "s_up", "s_sg", "s_hm")


def residuals(cfg: ArchConfig) -> tuple[str, ...]:
    """The keys of ``moe_forward``'s values that ``moe_block_bwd`` reads."""
    return RESIDUALS + (SHARED_RESIDUALS if cfg.shared_expert else ())


def moe_forward(x: torch.Tensor, params: dict, cfg: ArchConfig, *,
                lin: bool = False, parts: bool = False,
                g_off: torch.Tensor | None = None,
                full: bool = True) -> dict:
    """``moe_block``'s forward, returning its output ``out`` (``full``)
    and what its VJP reads (``RESIDUALS``). ``lin``: the reference's
    linearized forward (``route``'s ``factor``). ``parts``: the two
    gathers and their selections as the calls the reference traces
    (``estimator.take_parts``, ``estimator.select_parts``: the indices,
    masks and zeros their transposes read then draw edges from their
    inputs), as its recomputing (remat) body has them. ``full=False``
    stops where the VJP stops reading: before the combine's product and
    the shared expert's down projection. ``g_off``: ``route``'s."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    r = route(x, params["router"], cfg, lin=lin, g_off=g_off)
    grp, tl, c, keep = r["grp"], r["tl"], r["c"], r["keep"]
    xg = r["xg"]

    # dispatch: a gather over the group's tokens
    if parts:
        buf, tok = estimator.take_parts(xg, r["slot_token"])
        buf, valid, valid_zero = estimator.select_parts(
            r["slot_valid"][..., None], buf, 0.0)
        r.update(valid_zero=valid_zero)
    else:
        tok, valid = r["slot_token"], r["slot_valid"][..., None]
        buf = torch.take_along_dim(xg, tok[..., None].long(), dim=1)
        buf = torch.where(valid, buf, 0)
    buf = buf.reshape(grp, e, c, d)

    # expert FFN (SwiGLU), batched over experts
    g_ = _experts(buf, params["w_gate"])
    u_ = _experts(buf, params["w_up"])
    sg = F.silu(g_)
    h = sg * u_
    out_buf = _experts(h, params["w_down"]).reshape(grp, e * c, d)

    # combine: gather back by (expert, position), weight, sum over k
    comb_idx = r["flat_e"] * c + r["pos_c"]                 # [G,TL*k]
    if parts:
        gathered, comb = estimator.take_parts(out_buf, comb_idx)
        gathered, kept, keep_zero = estimator.select_parts(
            keep[..., None], gathered, 0.0)
        r.update(keep_zero=keep_zero)
    else:
        comb, kept = comb_idx, keep[..., None]
        gathered = torch.take_along_dim(out_buf, comb[..., None].long(),
                                        dim=1)
        gathered = torch.where(kept, gathered, 0)           # [G,TL*k,D]
    gathered = gathered.reshape(grp, tl, k, d)
    r.update(w=r["gate_w"], keep=kept, comb=comb, gathered=gathered,
             valid=valid, tok=tok, buf=buf, g=g_, sg=sg, u=u_, h=h)
    if full:
        r["out"] = (gathered * r["gate_w"][..., None].to(x.dtype)).sum(2)

    if "shared_expert" in params:
        se = params["shared_expert"]
        if lin:
            sp = layers.mlp_parts(xg, se["w_gate"], se["w_up"])
            r.update({f"s_{name}": t for name, t in sp.items()})
            shared = sp["hm"] @ se["w_down"] if full else None
        else:
            shared = layers.mlp(xg, se["w_gate"], se["w_up"], se["w_down"])
        if full:
            r["out"] = r["out"] + shared
    if full:
        r["out"] = r["out"].reshape(b, s, d)
    return r


def moe_block(x: torch.Tensor, params: dict, cfg: ArchConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]; ``params`` the reference's tree
    (``router``, ``w_gate``, ``w_up``, ``w_down``, optional
    ``shared_expert``). Assignments past an expert's capacity are
    dropped (their token gets nothing from that expert)."""
    return moe_forward(x, params, cfg)["out"]


def _experts_bwd(ct: torch.Tensor, w: torch.Tensor, rhs: torch.Tensor):
    """The VJPs of ``_experts(rhs, w)`` for its output's cotangent ``ct``
    [G, E, C, F]: (the cotangent of ``rhs`` [G, E, C, D], of ``w`` [E, D,
    F]), the reference's transposes of ``dot_general(w, rhs)``: the
    products ``ctᵀ @ wᵀ`` [E, G·C, D] and ``ct @ rhs`` [E, F, D], batched
    over experts."""
    g, e, c, f = ct.shape
    d = w.shape[1]
    ctt = ct.permute(1, 3, 0, 2).reshape(e, f, g * c)       # [E,F,G*C]
    drhs = torch.bmm(ctt.transpose(1, 2), w.transpose(1, 2)).view(
        e, g, c, d).permute(1, 0, 2, 3)
    dw = torch.bmm(ctt, rhs.permute(1, 0, 2, 3).reshape(e, g * c, d))
    return drhs, dw.transpose(1, 2)


def _softmax_bwd(ct: torch.Tensor, ex: torch.Tensor,
                 ssum: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``z`` in ``p = exp(z) / sum(exp(z))`` for ``p``'s
    ``ct``, as JAX's transpose spells it (the softmax not a custom JVP:
    ``div``, ``integer_pow(-2)``, ``mul``, ``neg``, ``add_any``)."""
    t = ct * ssum.pow(-2)
    t = t * ex
    neg = t.sum(-1, keepdim=True).neg()
    return estimator.add_any(ct / ssum, neg) * ex


def combine_bwd(ct: torch.Tensor, r: dict, n_slots: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The VJP of the combine, ``out = sum_k where(keep, out_buf[comb], 0)
    · w``, for ``out``'s cotangent ``ct`` [G, TL, D]: (the cotangent of
    ``w`` [G, TL, k] float32, of ``out_buf`` [G, E·C, D]). A dropped
    assignment adds a zero at its expert's slot 0; a slot that no kept
    assignment holds gets zeros only."""
    grp, tl, k, d = r["gathered"].shape
    ctb = ct[:, :, None, :]
    ct_w = (r["gathered"] * ctb).sum(-1).float()
    ct_gath = (ctb * r["w"][..., None].to(ct.dtype)).reshape(grp, tl * k, d)
    ct_gath = torch.where(r["keep"], ct_gath, r.get("keep_zero", 0.0))
    return ct_w, estimator.scatter_add(ct_gath, r["comb"], n_slots)


def moe_block_bwd(ct: torch.Tensor, r: dict, params: dict,
                  cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """``moe_block``'s VJP from ``moe_forward``'s values ``r`` (``lin``)
    and its input ``r["x"]``, for the output's cotangent ``ct`` [B, S,
    D]: (the input's cotangent, the gradients of ``params``' leaves by
    their '/'-joined keys). The ops and their order are the reference's
    transpose: the shared expert's MLP (``layers.mlp_bwd``), the combine's
    weighted sum over k, its selection and gather, the down, up and gate
    products (each the input's cotangent before the weight's), the
    dispatch's selection and gather, the gate's renormalization, top-k,
    the router's softmax and product. Each gather's transpose is
    ``estimator.scatter_add`` (a sum in a fixed order); the cotangent
    sums are unpriced (``estimator.add_any``)."""
    b, s, d = ct.shape
    e = cfg.n_experts
    add = estimator.add_any
    grp, tl = r["gathered"].shape[:2]
    c = r["buf"].shape[2]
    xg = r["x"].reshape(grp, tl, d)
    ctg = ct.reshape(grp, tl, d)
    grads = {}
    dx = None
    if "shared_expert" in params:
        se = params["shared_expert"]
        dx, sgrads = layers.mlp_bwd(
            ctg, xg, {name: r[f"s_{name}"] for name in ("gate", "up", "sg",
                                                        "hm")},
            se["w_gate"], se["w_up"], se["w_down"])
        grads.update({f"shared_expert/{n}": g for n, g in sgrads.items()})

    ct_w, ct_out = combine_bwd(ctg, r, e * c)

    # the experts: down, then up and gate
    ct_h, grads["w_down"] = _experts_bwd(
        ct_out.view(grp, e, c, d), params["w_down"], r["h"])
    ct_u = r["sg"] * ct_h
    ct_sg = ct_h * r["u"]
    ct_g = estimator.silu_vjp(ct_sg, r["g"])
    dbuf_u, grads["w_up"] = _experts_bwd(ct_u, params["w_up"], r["buf"])
    dbuf_g, grads["w_gate"] = _experts_bwd(ct_g, params["w_gate"], r["buf"])
    ct_buf = add(dbuf_u, dbuf_g).reshape(grp, e * c, d)

    # dispatch: buf = xg[slot_token], selected by slot_valid
    ct_buf = torch.where(r["valid"], ct_buf, r.get("valid_zero", 0.0))
    dxg = estimator.scatter_add(ct_buf, r["tok"], tl)        # [G,TL,D]

    # gate_w = vals / max(sum(vals), 1e-9)
    m = r["m"]
    t = ct_w * m.pow(-2)
    t = t * r["vals"]
    neg = t.sum(-1, keepdim=True).neg()
    ct_vals = ct_w / m
    ct_vals = add(ct_vals, neg * r["factor"])
    # top-k, then the router's softmax and product
    ct_probs = estimator.scatter_add(ct_vals, r["idx"], e)   # [G,TL,E]
    ct_logits = _softmax_bwd(ct_probs, r["ex"], r["ssum"]).to(ct.dtype)
    grads["router"] = layers.weight_grad(xg, ct_logits)
    dxg = add(dxg, ct_logits @ params["router"].t())
    dx = dxg if dx is None else add(dx, dxg)
    return dx.reshape(b, s, d), grads


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
