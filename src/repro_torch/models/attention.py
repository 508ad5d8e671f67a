"""GQA attention: full and chunked (flash) causal attention over a
sequence, decode against a contiguous KV cache, and decode and
whole-prompt prefill over a paged KV pool.

``full_causal_attention`` and the chunked path above seq 2048
(``chunked_causal_attention``: the pair scan ``flash_attention_pair`` and
the rectangular ``flash_attention_xla``, each an ``autograd.Function``
whose backward is the reference's custom VJP written out) are the
reference's train and prefill attention; see the chunked section below.

``decode_attention`` is the port of the reference's decode path against
a contiguous cache ``[B, max_len, G, head_dim]``, a function of the
reference's attention params (``{"wq", "wk", "wv", "wo"}``, with
``q_bias``/``k_bias``/``v_bias`` and ``q_norm``/``k_norm`` where the
config has them: ``_project_qkv``) that returns
the updated cache, as the reference does; the mapper traces it
(``launch.steps.make_serve_step``) and its grouped einsums are spelled
as the reference's ``dot_general`` products (operand order, batch dims,
output layout), so the traced products are the reference's nodes.

Port of the paged paths of ``repro.models.attention``. The KV pool of the
whole model is one stacked tensor per leaf, ``[n_layers, num_blocks,
block_size, G, head_dim]``; an attention site reads and writes its layer's
slice ``[num_blocks, block_size, G, head_dim]``. Where the reference
returns an updated copy of the pool (``.at[].set``), the port writes the
pool in place.

A quantized pool (``kv_dtype`` other than fp32) holds packed codes
(``core.quant.quantize_kv``) in ``k``/``v`` and one float32 scale per
(token, kv head) in ``k_scale``/``v_scale`` leaves ``[..., G, 1]``. A new
token's K/V are quantized on scatter and dequantized to float32 on
gather. In the reference, that float32 K/V promotes the attention output
of a bfloat16 model to float32 on the gather decode path and in batch
prefill, and its layer scan then raises on the changed carry type; only
the kernel path (K6, output in q's dtype) runs such a model. The port
raises a ``TypeError`` in the same places rather than compute a function
the reference does not.
"""

from __future__ import annotations

import itertools
import math

import torch
from torch import nn
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimator, quant
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    paged_decode_attention_grouped, paged_decode_attention_grouped_q,
    paged_decode_op, paged_decode_q_op)
from repro_torch.models import layers
from repro_torch.parallel import sharding

NEG_INF = ref.NEG_INF


def _require_f32_for_gather(dtype: torch.dtype, kv_dtype: str,
                            where: str) -> None:
    if dtype != torch.float32:
        raise TypeError(
            f"{where} over a {kv_dtype} KV pool needs a float32 model, got "
            f"{dtype}: the dequantized float32 K/V would promote the "
            f"attention output and the residual to float32, which the "
            f"reference rejects (its layer scan's carry changes type). A "
            f"{dtype} model with a quantized pool decodes through the "
            f"kernel (use_kernel=True / attn_kernel=True) with "
            f"prefill='replay'")


class Attention(nn.Module):
    """The q/k/v/o projections of one attention site (``[in, out]``
    weights, as in the reference's ``init_attention``), with qwen2.5's
    q/k/v biases (``qkv_bias``: ``q_bias`` [H·hd], ``k_bias``, ``v_bias``
    [G·hd], zeros at init) and qwen3's per-head norm scales (``qk_norm``:
    ``q_norm``, ``k_norm`` [hd], ones at init). ``site["wq"]`` reads a
    parameter by the reference's leaf name, so the attention functions
    take this module or the reference's dict alike."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype, device, *, qkv_bias: bool = False,
                 qk_norm: bool = False):
        super().__init__()
        hq, hkv = n_heads * head_dim, n_kv * head_dim
        self.wq = layers.empty_param((d_model, hq), dtype, device)
        self.wk = layers.empty_param((d_model, hkv), dtype, device)
        self.wv = layers.empty_param((d_model, hkv), dtype, device)
        self.wo = layers.empty_param((hq, d_model), dtype, device)
        if qkv_bias:
            self.q_bias = layers.empty_param((hq,), dtype, device)
            self.k_bias = layers.empty_param((hkv,), dtype, device)
            self.v_bias = layers.empty_param((hkv,), dtype, device)
        if qk_norm:
            self.q_norm = layers.empty_param((head_dim,), dtype, device)
            self.k_norm = layers.empty_param((head_dim,), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            layers.dense_init_(w, generator)
        with torch.no_grad():
            for name, value in (("q_bias", 0.0), ("k_bias", 0.0),
                                ("v_bias", 0.0), ("q_norm", 1.0),
                                ("k_norm", 1.0)):
                if hasattr(self, name):
                    getattr(self, name).fill_(value)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


def init_attention(cfg: ArchConfig, dtype, device) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim, dtype, device,
                     qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)


def _project_qkv(x, p, cfg: ArchConfig, positions):
    """x [B, S, D] -> q [B, S, H, hd], k, v [B, S, G, hd]: the reference's
    ``_project_qkv`` on the site's params ``p`` (its dict or an
    ``Attention``), in its order: the products, the biases (``qkv_bias``),
    the heads split, the per-head norms (``qk_norm``), the rotation."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["q_bias"]
        k = k + p["k_bias"]
        v = v + p["v_bias"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, theta=cfg.rope_theta,
                          style=cfg.rope_style, sections=cfg.mrope_sections)
    k = layers.apply_rope(k, positions, theta=cfg.rope_theta,
                          style=cfg.rope_style, sections=cfg.mrope_sections)
    return constrain_qkv(q, k, v)


def constrain_qkv(q, k, v):
    """The heads of q, k, v [B, S, heads, hd] on the model axis (the
    reference's constraints at the end of ``_project_qkv``)."""
    return (sharding.constrain(q, ("batch", None, "heads", None)),
            sharding.constrain(k, ("batch", None, "kv_heads", None)),
            sharding.constrain(v, ("batch", None, "kv_heads", None)))


def site_positions(cfg: ArchConfig, pos: torch.Tensor) -> torch.Tensor:
    """A site's positions ``pos`` [B, S] as its rotation takes them:
    broadcast to the [3, B, S] grid under ``"mrope"`` (every row the same,
    as the reference's decode and prefill sites broadcast theirs), as
    they are otherwise."""
    if cfg.rope_style == "mrope":
        return pos[None].expand(3, *pos.shape)
    return pos


# ---------------------------------------------------------------------------
# full causal attention over a sequence (train / prefill)
# ---------------------------------------------------------------------------


def causal_mask(s: int, device) -> torch.Tensor:
    """[S, S] bool, True on and below the diagonal."""
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, D], k [B, S, G, D] -> scores [B, G, R, S_q, S_k] in q's
    dtype, unscaled: the reference's ``dot_general(k, q)`` over (b, g),
    ``bmm`` of k [B·G, S_k, D] by q [B·G, D, S_q·R]."""
    b, s, h, d = q.shape
    g = k.shape[2]
    r = h // g
    # the views merge (b, g) and (s, r): g and r are parts of dim 2
    q = sharding.mergeable(q, (0, 2), (1, 2))
    k = sharding.mergeable(k, (0, 2))
    out = torch.bmm(k.permute(0, 2, 1, 3).reshape(b * g, s, d),
                    q.reshape(b, s, g, r, d).permute(0, 2, 4, 1, 3)
                    .reshape(b * g, d, s * r))
    return out.view(b, g, s, s, r).permute(0, 1, 4, 3, 2)


def softmax_parts(x: torch.Tensor):
    """``_softmax``'s (probabilities, exp, sum): what its VJP reads."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    ssum = e.sum(-1, keepdim=True)
    return e / ssum, e, ssum


def grouped_values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [B, G, R, S_q, S_k], v [B, S, G, D] -> out [B, S, H, D]: the
    reference's ``dot_general(v, probs)`` over (b, g), ``bmm`` of v
    [B·G, D, S_k] by probs [B·G, S_k, R·S_q]."""
    b, g, r, s, _ = probs.shape
    d = v.shape[-1]
    v = sharding.mergeable(v, (0, 2))
    probs = sharding.mergeable(probs, (0, 1), (2, 3))
    out = torch.bmm(v.permute(0, 2, 3, 1).reshape(b * g, d, s),
                    probs.permute(0, 1, 4, 2, 3).reshape(b * g, s, r * s))
    return out.view(b, g, d, r, s).permute(0, 4, 1, 3, 2).reshape(
        b, s, g * r, d)


def full_causal_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The reference's full attention (``attention.py:84-96``): grouped
    GQA products, KV never repeated; q [B, S, H, D], k/v [B, S, G, D] ->
    [B, S, H, D]."""
    s, d = q.shape[1], q.shape[-1]
    scores = grouped_scores(q, k) / math.sqrt(d)
    masked = torch.where(causal_mask(s, q.device), scores.float(), NEG_INF)
    return grouped_values(softmax_parts(masked)[0].to(q.dtype), v)


# ---------------------------------------------------------------------------
# chunked causal attention (flash, online softmax, written-out VJP)
# ---------------------------------------------------------------------------
# The reference's XLA flash paths (``attention.py:115-277``, ``:571-709``),
# what makes its train_4k and prefill_32k shapes fit memory: the scores
# exist one (q chunk, kv chunk) tile at a time and the backward recomputes
# them from the saved (out, lse). Plain PyTorch, as the reference's is
# plain JAX: no Pallas kernel of the reference lies on this path.
#
# Spelled as the reference's jaxpr has it, so the mapper folds the same
# nodes: each scan body is one iteration of a "scan" region and, where the
# reference wraps the body in ``jax.checkpoint``, one "call" region inside
# it; a chunk's index is a 0-d int tensor, multiplied by the chunk and
# normalized as jnp normalizes a dynamic index (``_wrapped``: the add its
# graph prices); slices and carry updates are ``estimator.dynamic_slice``
# and ``estimator.dynamic_update_slice_``. The products are the
# reference's ``dot_general``s as ``bmm``s (which operand is stationary,
# the output's layout); the products in the input dtype, the scores and
# accumulators in float32.

Q_CHUNK = 512
KV_CHUNK = 512

# the model path takes the pair-scan variant (the reference's default);
# the rectangular variant stays for ablation
USE_PAIR_SCAN = True


def _n_chunks(s: int, c: int) -> int:
    if s % c:
        raise ValueError(
            f"sequence length {s} is not a multiple of the attention chunk "
            f"{c}: the reference's reshape into chunks fails there (pad the "
            f"sequence to a multiple of {c})")
    return s // c


def _index(i: int, like: torch.Tensor) -> torch.Tensor:
    """Chunk index ``i`` as the traced int32 scalar a scan body reads."""
    return torch.full((), i, dtype=torch.int32, device=like.device)


def _slice(x: torch.Tensor, i: torch.Tensor, c: int, dim: int):
    """``lax.dynamic_slice_in_dim(x, i * c, c, axis=dim)``."""
    return estimator.dynamic_slice(x, _wrapped(i * c, x.shape[dim]), c, dim)


def _update_slice_(x: torch.Tensor, new: torch.Tensor, i: torch.Tensor,
                   c: int, dim: int) -> None:
    """``x = lax.dynamic_update_slice_in_dim(x, new, i * c, axis=dim)``,
    in place."""
    estimator.dynamic_update_slice_(x, new, _wrapped(i * c, x.shape[dim]),
                                    dim)


def _at_index(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``lax.dynamic_index_in_dim(x, i, 0)[0]``."""
    return estimator.dynamic_slice(x, _wrapped(i, x.shape[0]), 1, 0)[0]


def _update_index_(x: torch.Tensor, new: torch.Tensor,
                   i: torch.Tensor) -> None:
    """``x = lax.dynamic_update_index_in_dim(x, new, i, 0)``, in place."""
    estimator.dynamic_update_slice_(x, new[None], _wrapped(i, x.shape[0]), 0)


def _repeat_chunk(kc: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, c, G, D] -> [B, c, G·R, D]: a chunk's K/V repeated to the query
    heads (a transient of one chunk)."""
    if n_rep == 1:
        return kc
    b, c, g, d = kc.shape
    rep = kc[:, :, :, None, :].expand(b, c, g, n_rep, d).reshape(
        b, c, g * n_rep, d)
    return sharding.constrain(rep, ("batch", None, "heads", None))


def _mask_penalty(qi, ki, iota_q, iota_k) -> torch.Tensor:
    """The (q chunk, kv chunk) tile's causal mask as an additive float32
    penalty (0 or ``NEG_INF``)."""
    causal = ((qi * iota_q.shape[0] + iota_q)[:, None]
              >= (ki * iota_k.shape[0] + iota_k)[None])
    return torch.where(causal, 0.0, NEG_INF)


def _pair_indices(n: int) -> tuple[list[int], list[int]]:
    """The n(n+1)/2 causal (q chunk, kv chunk) pairs, q-major."""
    qs, ks = [], []
    for qi in range(n):
        for ki in range(qi + 1):
            qs.append(qi)
            ks.append(ki)
    return qs, ks


# Tracing a pair costs make_fx ~0.1 s (~100 aten ops at ~1 ms each on a
# CPU core), and a 32-layer step at seq 4096 has 3,456 of them. Every
# pair issues the same ops on the same shapes, its indices the only
# difference, and a pair's results are its in-place carry updates: so a
# traced scan records its first pair and copies that pair's nodes for the
# others, each copy with its own indices and regions. The graph is the
# one tracing every pair gives (tests/test_torch_long_schedules.py).
COPY_TRACED_PAIRS = True


def _scan_pairs(n: int, name: str, like: torch.Tensor, body) -> None:
    """``body(qi, ki)`` for each causal chunk pair (``_pair_indices``),
    each call one iteration of the ``"scan"`` region ``name`` with a
    ``"call"`` region inside it (the reference's ``jax.checkpoint``-ed scan
    body); ``qi``, ``ki`` the pair's indices as int32 scalars on ``like``'s
    device. Under ``make_fx`` only the first pair is traced
    (``COPY_TRACED_PAIRS``, ``_copy_pairs``)."""
    pairs = list(zip(*_pair_indices(n)))
    graph = _traced_graph() if COPY_TRACED_PAIRS else None
    before = len(graph.nodes) if graph is not None else 0
    for i, j in pairs:
        with estimator.region("scan", name), \
                estimator.region("call", "checkpoint"):
            body(_index(i, like), _index(j, like))
        if graph is not None:
            _copy_pairs(graph, len(graph.nodes) - before, pairs[1:])
            return


def _traced_graph():
    """The ``torch.fx`` graph ``make_fx`` is recording into, else None."""
    mode = get_proxy_mode()
    return None if mode is None else mode.tracer.graph


def _copy_pairs(graph, size: int, pairs) -> None:
    """Append to ``graph`` a copy of its last ``size`` nodes (one traced
    pair, opening with its two indices' ``full`` nodes) for each further
    pair: each index filled with the pair's, each node's regions given
    ids of the copy's own."""
    body = list(itertools.islice(reversed(graph.nodes), size))[::-1]
    index = body[:2]
    if not all(nd.target is torch.ops.aten.full.default for nd in index):
        raise AssertionError("a pair's trace opens with its two indices")
    depth = len(estimator.scope_of(body[0])) - 2
    for pair in pairs:
        env: dict = {}
        ids: dict = {}
        for nd in body:
            new = graph.node_copy(nd, lambda a: env.get(a, a))
            estimator.set_scope(new, estimator.renumbered(
                estimator.scope_of(nd), depth, ids))
            if nd in index:
                new.args = (nd.args[0], pair[index.index(nd)])
            env[nd] = new


def _heads_first(x: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """[B, c, H, D] -> [B·H, c, D], or with ``trans`` [B·H, D, c]."""
    b, c, h, d = x.shape
    if trans:
        return x.permute(0, 2, 3, 1).reshape(b * h, d, c)
    return x.permute(0, 2, 1, 3).reshape(b * h, c, d)


def _scores(qc: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """``einsum("bqhd,bkhd->bhqk")``: [B, H, c_q, c_k]."""
    b, cq, h, _ = qc.shape
    return torch.bmm(_heads_first(qc), _heads_first(kc, True)).view(
        b, h, cq, kc.shape[1])


def _values(p: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """``einsum("bhqk,bkhd->bhqd")``: [B, H, c_q, D]."""
    b, h, cq, ck = p.shape
    return torch.bmm(p.reshape(b * h, cq, ck), _heads_first(vc)).view(
        b, h, cq, vc.shape[-1])


def _key_grad(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bhqk,bqhd->bkhd", t, x)``, the reference's
    ``dot_general(x, t)``: [B, c_k, H, D]."""
    b, h, cq, ck = t.shape
    return torch.bmm(_heads_first(x, True), t.reshape(b * h, cq, ck)).view(
        b, h, x.shape[-1], ck).permute(0, 3, 1, 2)


def _query_grad(ds: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """``einsum("bhqk,bkhd->bqhd", ds, kc)``, the reference's
    ``dot_general(kc, ds)``: [B, c_q, H, D]."""
    b, h, cq, ck = ds.shape
    return torch.bmm(_heads_first(kc, True),
                     ds.transpose(2, 3).reshape(b * h, ck, cq)).view(
        b, h, kc.shape[-1], cq).permute(0, 3, 1, 2)


def _fold_heads(x: torch.Tensor, g: int) -> torch.Tensor:
    """[B, c, G·R, D] -> [B, c, G, D]: the repeated heads' cotangents
    summed back onto their KV head."""
    b, c, h, d = x.shape
    return x.reshape(b, c, g, h // g, d).sum(3)


def _delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``einsum("bshd,bshd->bhs", dout, out)`` contracted in float32 (the
    reference's ``preferred_element_type``): [B, H, S]."""
    b, s, h, d = out.shape
    return torch.bmm(dout.float().permute(0, 2, 1, 3).reshape(b * h * s, 1, d),
                     out.float().permute(0, 2, 1, 3).reshape(b * h * s, d, 1)
                     ).view(b, h, s)


def _flash_fwd_impl(q, k, v, q_chunk: int, kv_chunk: int,
                    with_lse: bool = True):
    """The rectangular forward: q [B, S, H, D], k/v [B, S, G, D] -> (out
    [B, S, H, D], lse [B, H, S]); every (q chunk, kv chunk) tile, the
    future ones masked. The reference's ``lax.map`` over q chunks is a
    ``"scan"`` region around the kv chunks' ``"scan"``."""
    b, s, h, d = q.shape
    g = k.shape[2]
    n_rep = h // g
    scale = 1.0 / math.sqrt(d)
    qc, kc = min(q_chunk, s), min(kv_chunk, s)
    nq, nk = _n_chunks(s, qc), _n_chunks(s, kc)
    q = sharding.constrain(q, ("batch", None, "heads", None))
    iota_q = torch.arange(qc, device=q.device)
    iota_k = torch.arange(kc, device=q.device)
    kr = k.reshape(b, nk, kc, g, d).movedim(1, 0)
    vr = v.reshape(b, nk, kc, g, d).movedim(1, 0)
    outs, lses = [], []
    for i in range(nq):
        with estimator.region("scan", "q_chunks"):
            qi = _index(i, q)
            qck = _slice(q, qi, qc, 1)
            acc = torch.zeros((b, h, qc, d), dtype=torch.float32,
                              device=q.device)
            m = torch.full((b, h, qc), NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros((b, h, qc), dtype=torch.float32,
                            device=q.device)
            for j in range(nk):
                with estimator.region("scan", "kv_chunks"):
                    kck = _repeat_chunk(kr[j], n_rep)
                    vck = _repeat_chunk(vr[j], n_rep)
                    ki = _index(j, q)
                    sc = _scores(qck, kck).float() * scale
                    sc = sc + _mask_penalty(qi, ki, iota_q, iota_k)[None, None]
                    m_new = torch.maximum(m, sc.amax(-1))
                    p = torch.exp(sc - m_new[..., None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = (acc * alpha[..., None]
                           + _values(p.to(qck.dtype), vck).float())
                    m = m_new
            out_c = acc / torch.clamp_min(l[..., None], 1e-20)
            if with_lse:
                lses.append(m + torch.log(torch.clamp_min(l, 1e-20)))
            outs.append(out_c.movedim(2, 1).to(q.dtype))
    out = torch.stack(outs, 1).reshape(b, s, h, d)
    return out, torch.cat(lses, -1) if with_lse else None


def _flash_bwd_impl(q, k, v, out, lse, dout, q_chunk: int, kv_chunk: int):
    """The rectangular forward's VJP (the reference's ``_flash_bwd_impl``):
    (dq, dk, dv), each tile's scores recomputed from ``lse``; dk and dv
    accumulated in float32."""
    b, s, h, d = q.shape
    g = k.shape[2]
    n_rep = h // g
    scale = 1.0 / math.sqrt(d)
    qc, kc = min(q_chunk, s), min(kv_chunk, s)
    nq, nk = _n_chunks(s, qc), _n_chunks(s, kc)
    q = sharding.constrain(q, ("batch", None, "heads", None))
    dout = sharding.constrain(dout, ("batch", None, "heads", None))
    iota_q = torch.arange(qc, device=q.device)
    iota_k = torch.arange(kc, device=q.device)
    delta = _delta(dout, out)
    kr = k.reshape(b, nk, kc, g, d).movedim(1, 0)
    vr = v.reshape(b, nk, kc, g, d).movedim(1, 0)
    dk = torch.zeros((b, s, g, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, s, g, d), dtype=torch.float32, device=q.device)
    dqs = []
    for i in range(nq):
        with estimator.region("scan", "q_chunks.T"):
            qi = _index(i, q)
            qck = _slice(q, qi, qc, 1)
            do_c = _slice(dout, qi, qc, 1)
            lse_c = _slice(lse, qi, qc, 2)
            dl_c = _slice(delta, qi, qc, 2)
            dq = torch.zeros((b, qc, h, d), dtype=torch.float32,
                             device=q.device)
            for j in range(nk):
                with estimator.region("scan", "kv_chunks.T"):
                    kck, vck = kr[j], vr[j]
                    ki = _index(j, q)
                    kck_r = _repeat_chunk(kck, n_rep)
                    vck_r = _repeat_chunk(vck, n_rep)
                    sc = _scores(qck, kck_r).float() * scale
                    sc = sc + _mask_penalty(qi, ki, iota_q, iota_k)[None, None]
                    p = torch.exp(sc - lse_c[..., None])
                    dv_blk = _key_grad(p, do_c.float())
                    dp = _scores(do_c, vck_r).float()
                    ds = p * (dp - dl_c[..., None]) * scale
                    dq_blk = _query_grad(ds, kck_r.float())
                    dk_blk = _key_grad(ds, qck.float())
                    dk_blk = _fold_heads(dk_blk, g)
                    dv_blk = _fold_heads(dv_blk, g)
                    _update_slice_(dk, _slice(dk, ki, kc, 1) + dk_blk, ki,
                                   kc, 1)
                    _update_slice_(dv, _slice(dv, ki, kc, 1) + dv_blk, ki,
                                   kc, 1)
                    dq = dq + dq_blk
            dqs.append(dq.to(q.dtype))
    dq = torch.stack(dqs, 1).reshape(b, s, h, d)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _flash_fwd_pair_impl(q, k, v, chunk: int, with_lse: bool = True):
    """The pair-scan forward: q [B, S, H, D], k/v [B, S, G, D] -> (out
    [B, S, H, D], lse [B, H, S]); only the n(n+1)/2 causal chunk pairs,
    carrying every q chunk's online-softmax state ``[n, B, H, c, ...]``
    and updating the pair's q chunk in place. ``with_lse=False`` returns
    None for lse, as the reference's checkpointed forward drops it."""
    b, s, h, d = q.shape
    g = k.shape[2]
    n_rep = h // g
    scale = 1.0 / math.sqrt(d)
    c = min(chunk, s)
    n = _n_chunks(s, c)
    q = sharding.constrain(q, ("batch", None, "heads", None))
    diag = torch.where(causal_mask(c, q.device), 0.0, NEG_INF)
    acc = torch.zeros((n, b, h, c, d), dtype=torch.float32, device=q.device)
    m = torch.full((n, b, h, c), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((n, b, h, c), dtype=torch.float32, device=q.device)

    def pair(qi, ki):
        qck = _slice(q, qi, c, 1)
        kck = _repeat_chunk(_slice(k, ki, c, 1), n_rep)
        vck = _repeat_chunk(_slice(v, ki, c, 1), n_rep)
        sc = _scores(qck, kck).float() * scale
        sc = sc + torch.where(qi == ki, 1.0, 0.0) * diag[None, None]
        m_prev = _at_index(m, qi)
        l_prev = _at_index(l, qi)
        a_prev = _at_index(acc, qi)
        m_new = torch.maximum(m_prev, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l_new = l_prev * alpha + p.sum(-1)
        a_new = (a_prev * alpha[..., None]
                 + _values(p.to(q.dtype), vck).float())
        _update_index_(acc, a_new, qi)
        _update_index_(m, m_new, qi)
        _update_index_(l, l_new, qi)

    _scan_pairs(n, "pairs", q, pair)
    out = acc / torch.clamp_min(l[..., None], 1e-20)
    out = out.permute(1, 0, 3, 2, 4).reshape(b, s, h, d).to(q.dtype)
    if not with_lse:
        return out, None
    lse = m + torch.log(torch.clamp_min(l, 1e-20))
    return out, lse.permute(1, 2, 0, 3).reshape(b, h, s)


def _flash_bwd_pair_impl(q, k, v, out, lse, dout, chunk: int):
    """The pair-scan forward's VJP (the reference's
    ``_flash_bwd_pair_impl``): (dq, dk, dv) in q's and k's dtypes, each
    causal pair's scores recomputed from ``lse``; dq accumulated in q's
    dtype, dk and dv in k's."""
    b, s, h, d = q.shape
    g = k.shape[2]
    n_rep = h // g
    scale = 1.0 / math.sqrt(d)
    c = min(chunk, s)
    n = _n_chunks(s, c)
    q = sharding.constrain(q, ("batch", None, "heads", None))
    dout = sharding.constrain(dout, ("batch", None, "heads", None))
    diag = torch.where(causal_mask(c, q.device), 0.0, NEG_INF)
    delta = _delta(dout, out)
    dq = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.zeros(v.shape, dtype=v.dtype, device=v.device)

    def pair(qi, ki):
        qck = _slice(q, qi, c, 1)
        do_c = _slice(dout, qi, c, 1)
        lse_c = _slice(lse, qi, c, 2)
        dl_c = _slice(delta, qi, c, 2)
        kck_r = _repeat_chunk(_slice(k, ki, c, 1), n_rep)
        vck_r = _repeat_chunk(_slice(v, ki, c, 1), n_rep)
        sc = _scores(qck, kck_r).float() * scale
        sc = sc + torch.where(qi == ki, 1.0, 0.0) * diag[None, None]
        p = torch.exp(sc - lse_c[..., None])
        dv_blk = _key_grad(p, do_c.float())
        dp = _scores(do_c, vck_r).float()
        ds = p * (dp - dl_c[..., None]) * scale
        dq_blk = _query_grad(ds, kck_r.float()).to(q.dtype)
        dk_blk = _fold_heads(_key_grad(ds, qck.float()), g)
        dv_blk = _fold_heads(dv_blk, g)
        _update_slice_(dq, _slice(dq, qi, c, 1) + dq_blk, qi, c, 1)
        _update_slice_(dk, _slice(dk, ki, c, 1) + dk_blk.to(k.dtype), ki,
                       c, 1)
        _update_slice_(dv, _slice(dv, ki, c, 1) + dv_blk.to(v.dtype), ki,
                       c, 1)

    _scan_pairs(n, "pairs.T", q, pair)
    return dq, dk, dv


class _FlashXla(torch.autograd.Function):
    """``flash_attention_xla`` with the reference's custom VJP: outputs
    (out, lse), lse saved for the backward and not differentiable."""

    @staticmethod
    def forward(q, k, v, q_chunk, kv_chunk):
        return _flash_fwd_impl(q, k, v, q_chunk, kv_chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.q_chunk, ctx.kv_chunk = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(q, k, v, *output)

    @staticmethod
    def backward(ctx, dout, _):
        with torch.no_grad():
            return (*_flash_bwd_impl(*ctx.saved_tensors, dout, ctx.q_chunk,
                                     ctx.kv_chunk), None, None)


class _FlashPair(torch.autograd.Function):
    """``flash_attention_pair`` with the reference's custom VJP: outputs
    (out, lse), lse saved for the backward and not differentiable."""

    @staticmethod
    def forward(q, k, v, chunk):
        return _flash_fwd_pair_impl(q, k, v, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.chunk = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(q, k, v, *output)

    @staticmethod
    def backward(ctx, dout, _):
        with torch.no_grad():
            return (*_flash_bwd_pair_impl(*ctx.saved_tensors, dout,
                                          ctx.chunk), None)


def flash_attention_xla(q, k, v, q_chunk: int = Q_CHUNK,
                        kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, S, G, D] -> out [B, S, H, D]: the
    rectangular flash path. A ``"call"`` region, as the reference's
    custom-VJP call."""
    with estimator.region("call", "flash_attention_xla"):
        return _FlashXla.apply(q, k, v, q_chunk, kv_chunk)[0]


def flash_attention_pair(q, k, v, chunk: int = 512) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, S, G, D] -> out [B, S, H, D]: the pair-scan
    flash path. A ``"call"`` region, as the reference's custom-VJP
    call."""
    with estimator.region("call", "flash_attention_pair"):
        return _FlashPair.apply(q, k, v, chunk)[0]


def chunked_causal_attention(q, k, v, *, q_chunk: int = Q_CHUNK,
                             kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """[B, S, H, D] over the flash path (memory O(S · chunk)): the pair
    variant under ``USE_PAIR_SCAN``."""
    s = q.shape[1]
    if USE_PAIR_SCAN:
        return flash_attention_pair(q, k, v, min(q_chunk, s))
    return flash_attention_xla(q, k, v, min(q_chunk, s), min(kv_chunk, s))


def chunked_forward(q, k, v, *, with_lse: bool = True,
                    q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK):
    """``chunked_causal_attention``'s (out, lse), its forward rule inline
    (no call region): what a differentiated layer runs, as the reference's
    linearization inlines the custom VJP's forward; lse None without
    ``with_lse``."""
    s = q.shape[1]
    if USE_PAIR_SCAN:
        return _flash_fwd_pair_impl(q, k, v, min(q_chunk, s), with_lse)
    return _flash_fwd_impl(q, k, v, min(q_chunk, s), min(kv_chunk, s),
                           with_lse)


def chunked_backward(q, k, v, out, lse, dout, *, q_chunk: int = Q_CHUNK,
                     kv_chunk: int = KV_CHUNK):
    """The VJP of :func:`chunked_forward`: (dq, dk, dv)."""
    s = q.shape[1]
    if USE_PAIR_SCAN:
        return _flash_bwd_pair_impl(q, k, v, out, lse, dout,
                                    min(q_chunk, s))
    return _flash_bwd_impl(q, k, v, out, lse, dout, min(q_chunk, s),
                           min(kv_chunk, s))


def attention_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                    positions: torch.Tensor, *,
                    chunked: bool = False) -> torch.Tensor:
    """The reference's ``attention_block``: x [B, S, D] -> [B, S, D],
    full attention or (``chunked``, sequences above
    ``transformer.CHUNKED_ATTN_THRESHOLD``) the chunked flash path."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    if chunked:
        out = chunked_causal_attention(q, k, v)
    else:
        out = full_causal_attention(q, k, v)
    return out.reshape(b, s, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# decode against a contiguous cache
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype, device) -> dict[str, torch.Tensor]:
    """One attention site's contiguous cache ``{"k", "v"}``, each ``[batch,
    max_len, n_kv, head_dim]`` of zeros."""
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _updated(cache: torch.Tensor, new: torch.Tensor,
             pos: torch.Tensor) -> torch.Tensor:
    """``cache`` [B, S, G, D] with ``new`` [B, 1, G, D] written at ``pos``,
    out of place: the reference's ``dynamic_update_slice_in_dim`` (a
    negative position counts from the end, and the row is clamped into
    the cache). ``pos`` stays on the device: no host read."""
    s = cache.shape[1]
    at = torch.where(pos < 0, pos + s, pos).clamp(0, s - 1)
    return cache.index_copy(1, at.reshape(1).long(), new.to(cache.dtype))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, as its jaxpr spells it: the
    max subtracted, exp, divided by the sum."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def decode_attention(x: torch.Tensor, p: dict, cfg: ArchConfig,
                     cache: dict, pos: torch.Tensor):
    """x: [B, 1, D]; ``p`` the reference's attention params; ``cache``
    ``{"k", "v"}`` [B, max_len, G, hd]; pos: a 0-d int tensor, the current
    length. Returns (out [B, 1, D], the updated cache), the cache written
    out of place. Grouped products, KV never repeated: the scores are the
    reference's ``dot_general(k, q)`` over (b, g) — ``bmm`` of k [B·G, S,
    hd] by q [B·G, hd, R] — and the values its ``dot_general(v, p)``."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    g = cfg.n_kv_heads
    r = cfg.n_heads // g
    q, k_new, v_new = _project_qkv(x, p, cfg,
                                   site_positions(cfg, pos.expand(b, 1)))
    k = _updated(cache["k"], k_new, pos)
    v = _updated(cache["v"], v_new, pos)
    valid = torch.arange(k.shape[1], device=x.device) <= pos
    return _grouped_decode(q, k, v, valid, cfg) @ p["wo"], {"k": k, "v": v}


def _grouped_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One query token's grouped attention over keys ``k``/``v`` [B, S, G,
    hd], ``valid`` the keys it may read (broadcast against [B, G, R, 1,
    S]), q [B, 1, H, hd] -> [B, 1, H·hd], before the output projection.
    The reference's products, spelled as its ``dot_general``s: the scores
    its ``dot_general(k, q)`` over (b, g) — ``bmm`` of k [B·G, S, hd] by q
    [B·G, hd, R] — and the values its ``dot_general(v, p)``; the softmax
    in float32, the probabilities in q's dtype."""
    b, s = k.shape[0], k.shape[1]
    hd = cfg.resolved_head_dim
    g = cfg.n_kv_heads
    r = cfg.n_heads // g
    qg = q.reshape(b, 1, g, r, hd)                      # [B, 1, G, R, hd]
    scores = torch.bmm(k.permute(0, 2, 1, 3).reshape(b * g, s, hd),
                       qg.permute(0, 2, 4, 1, 3).reshape(b * g, hd, r))
    scores = scores.view(b, g, s, 1, r).permute(0, 1, 4, 3, 2)  # b g r q k
    scores = scores.float() / math.sqrt(hd)
    probs = _softmax(torch.where(valid, scores, NEG_INF)).to(q.dtype)
    out = torch.bmm(v.permute(0, 2, 3, 1).reshape(b * g, hd, s),
                    probs.permute(0, 1, 4, 2, 3).reshape(b * g, s, r))
    out = out.view(b, g, hd, r, 1).permute(0, 4, 1, 3, 2)   # b q g r d
    # flattened to 2-D first: at rep 1 the permuted heads merge without a
    # copy, and a [B, 1, H·hd] view of them would keep a query-axis stride
    # of 1, which ``torch.matmul`` will not fold into one ``mm`` with the
    # output projection (it takes ``bmm``: a batched product the mapper
    # neither places nor lowers)
    return out.reshape(b, cfg.n_heads * hd).view(b, 1, cfg.n_heads * hd)


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------


def init_paged_kv_cache(n_layers: int, num_blocks: int, block_size: int,
                        n_kv: int, head_dim: int, dtype, device,
                        kv_dtype: str = "fp32") -> dict[str, torch.Tensor]:
    """The paged KV pool of ``n_layers`` attention sites: position ``p``
    of a slot lives at ``[layer, table[p // block_size], p % block_size]``.

    ``kv_dtype="fp32"`` stores ``{"k", "v"}`` in the model dtype. Any
    other grid stores codes (``quant.code_dtype``) and adds float32
    ``k_scale``/``v_scale`` leaves ``[n_layers, num_blocks, block_size,
    n_kv, 1]``; the block axis stays 1, so every allocator copy (CoW,
    swap, prefix export/import) moves codes and scales together."""
    shape = (n_layers, num_blocks, block_size, n_kv, head_dim)
    s = quant.spec(kv_dtype)
    if s.name == "fp32":
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    codes = quant.code_dtype(s)
    sshape = shape[:-1] + (1,)
    return {"k": torch.zeros(shape, dtype=codes, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v": torch.zeros(shape, dtype=codes, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}


def _scatter(store, scale, rows, offs, new, kv_dtype: str) -> None:
    """Write ``new`` [n, G, hd] at ``store[rows, offs]`` in place,
    quantized to ``kv_dtype`` (codes into ``store``, scales into
    ``scale``) unless it is fp32 (the reference's ``.at[].set``)."""
    if quant.spec(kv_dtype).name == "fp32":
        store[rows, offs] = new.to(store.dtype)
        return
    codes, sc = quant.quantize_kv(new, kv_dtype)
    store[rows, offs] = codes
    scale[rows, offs] = sc


def paged_decode_attention(x, attn: Attention, cfg: ArchConfig,
                           k_store: torch.Tensor, v_store: torch.Tensor,
                           block_table: torch.Tensor, pos: torch.Tensor, *,
                           use_kernel: bool = False, kv_dtype: str = "fp32",
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """x: [B, 1, D]; k/v_store: this site's pool [num_blocks, block_size,
    G, hd], written in place (with k/v_scale [num_blocks, block_size, G,
    1] for a quantized ``kv_dtype``); block_table: [B, W] int32 (invalid
    entries clamped to the scratch block); pos: [B] int32 per-slot
    positions. Returns out [B, 1, D].

    The new token's K/V are written into each slot's tail block *before*
    the attention pass. ``use_kernel=True`` runs the pass through the
    paged decode kernel (K4, or K6 over a quantized pool; one launch for
    every slot); otherwise through the gather path, the kernel's plain
    version. The gather path over a quantized pool needs a float32 model
    (module docstring).
    """
    quantized = quant.spec(kv_dtype).name != "fp32"
    if quantized and not use_kernel:
        _require_f32_for_gather(x.dtype, kv_dtype, "the gather decode path")
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    bs = k_store.shape[1]
    q, k_new, v_new = _project_qkv(x, attn, cfg,
                                   site_positions(cfg, pos[:, None]))
    rows = torch.arange(b, device=x.device)
    blk = block_table[rows, (pos // bs).long()].long()      # [B] tail blocks
    off = (pos % bs).long()
    # in place; the reference returns a copy (cache.at[blk, off].set)
    _scatter(k_store, k_scale, blk, off, k_new[:, 0], kv_dtype)
    _scatter(v_store, v_scale, blk, off, v_new[:, 0], kv_dtype)
    q1 = q[:, 0].contiguous()
    if quantized and use_kernel:
        att = paged_decode_attention_grouped_q(
            q1, k_store, k_scale, v_store, v_scale, block_table, pos,
            kv_dtype=kv_dtype)
    elif quantized:
        att = ref.paged_decode_attention_q_ref(
            q1, k_store, k_scale, v_store, v_scale, block_table, pos,
            kv_dtype)
    elif use_kernel:
        att = paged_decode_attention_grouped(q1, k_store, v_store,
                                             block_table, pos)
    else:
        att = ref.paged_decode_attention_ref(q1, k_store, v_store,
                                             block_table, pos)
    return att.reshape(b, 1, cfg.n_heads * hd) @ attn.wo


def _wrapped(idx: torch.Tensor, n: int) -> torch.Tensor:
    """An index into an axis of ``n`` with a negative entry counted from
    the end: the normalization the reference's indexing (jnp's gather and
    ``.at[].set``) applies to every index, whose ``add`` its graph
    prices."""
    return torch.where(idx < 0, idx + n, idx)


def _put(store: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
         new: torch.Tensor) -> torch.Tensor:
    """``store[blk, off] = new`` in place, the indices normalized as the
    reference's ``.at[blk, off].set`` does; returns ``store``."""
    rows = _wrapped(blk, store.shape[0]).long()
    store[rows, _wrapped(off, store.shape[1]).long()] = new.to(store.dtype)
    return store


def paged_decode_attention_tree(x: torch.Tensor, p: dict, cfg: ArchConfig,
                                cache: dict, block_table: torch.Tensor,
                                pos: torch.Tensor, *,
                                use_kernel: bool = False,
                                kv_dtype: str = "fp32"):
    """:func:`paged_decode_attention` on a site's weights from the
    reference's parameter tree (``p``: ``{"wq", "wk", "wv", "wo"}``) and
    its pool slice ``cache`` (``{"k", "v"}`` [num_blocks, block_size, G,
    hd], with ``"k_scale"``/``"v_scale"`` over a quantized pool): the
    function the mapper traces for a paged decode step
    (``models.transformer.decode_step_paged``). Returns (out [B, 1, D],
    ``cache``), the new token's K/V written into it in place.

    The ops are the reference's ``paged_decode_attention``, in its order,
    so the traced graph is its graph: the tail block and offset with
    jnp's index normalization (:func:`_wrapped`), both K and V quantized
    before the four writes (K, its scales, V, its scales), each write and
    each gather of the pool through the table normalizing its own
    indices. The kernel path reaches K4 (K6 over a quantized pool)
    through an op the capture keeps whole
    (``kernels.flash_attention.paged_decode_op``), as the reference's
    graph keeps its ``pallas_call``; the gather path is the reference's
    gather, dequantization and grouped products (:func:`_grouped_decode`).
    It does not share ``_scatter``, which quantizes each leaf just before
    writing it; and the jit engine's tick keeps
    :func:`paged_decode_attention`, which spends no kernels on the index
    normalization (a no-op on the table's valid indices)."""
    quantized = quant.spec(kv_dtype).name != "fp32"
    if quantized and not use_kernel:
        _require_f32_for_gather(x.dtype, kv_dtype, "the gather decode path")
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    k_store, v_store = cache["k"], cache["v"]
    nb, bs = k_store.shape[0], k_store.shape[1]
    w = block_table.shape[1]
    q, k_new, v_new = _project_qkv(x, p, cfg,
                                   site_positions(cfg, pos[:, None]))
    rows = _wrapped(torch.arange(b, dtype=pos.dtype, device=x.device), b)
    tail = _wrapped(torch.div(pos, bs, rounding_mode="floor"), w)
    blk = block_table[rows.long(), tail.long()]              # [B] tail blocks
    off = torch.remainder(pos, bs)
    if quantized:
        k_codes, k_sc = quant.quantize_kv(k_new[:, 0], kv_dtype)
        v_codes, v_sc = quant.quantize_kv(v_new[:, 0], kv_dtype)
        for name, new in (("k", k_codes), ("k_scale", k_sc),
                          ("v", v_codes), ("v_scale", v_sc)):
            _put(cache[name], blk, off, new)
    else:
        _put(k_store, blk, off, k_new[:, 0])
        _put(v_store, blk, off, v_new[:, 0])
    if use_kernel:
        if quantized:
            att = paged_decode_q_op(q[:, 0], k_store, cache["k_scale"],
                                    v_store, cache["v_scale"], block_table,
                                    pos, quant.spec(kv_dtype).name)
        else:
            att = paged_decode_op(q[:, 0], k_store, v_store, block_table,
                                  pos)
        return att.reshape(b, 1, cfg.n_heads * hd) @ p["wo"], cache

    def gathered(name):
        return cache[name][_wrapped(block_table, nb).long()]

    if quantized:
        k = quant.dequantize_kv(gathered("k"), gathered("k_scale"), kv_dtype)
        v = quant.dequantize_kv(gathered("v"), gathered("v_scale"), kv_dtype)
    else:
        k, v = gathered("k"), gathered("v")
    k = k.reshape(b, w * bs, cfg.n_kv_heads, hd)
    v = v.reshape(b, w * bs, cfg.n_kv_heads, hd)
    valid = (torch.arange(w * bs, device=x.device)[None]
             <= pos[:, None])                                 # [B, L]
    out = _grouped_decode(q, k, v, valid[:, None, None, None, :], cfg)
    return out @ p["wo"], cache


def paged_prefill_attention(x, attn: Attention, cfg: ArchConfig,
                            k_store: torch.Tensor, v_store: torch.Tensor,
                            table_row: torch.Tensor, p0: int,
                            n_new: int, *, kv_dtype: str = "fp32",
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Whole-prompt attention for one slot over the paged pool.

    x: [1, T, D] — T new prompt tokens (padded; entries past ``n_new``
    are don't-cares) at global positions ``p0 .. p0+n_new-1``;
    ``table_row``: [W] the slot's physical block ids. Returns att
    [1, T, D]; the new tokens' K/V are written into the pool in place
    (the reference returns a copy), padded entries into the scratch
    block 0. Queries attend causally over the cached prefix and the new
    tokens through a gather of the slot's table, as the reference does;
    this is plain PyTorch because the reference's prefill is XLA code,
    outside any Pallas kernel. A quantized ``kv_dtype`` quantizes the new
    K/V on scatter (codes and scales, as decode does) and attends over the
    dequantized float32 pool, so it needs a float32 model (module
    docstring).
    """
    quantized = quant.spec(kv_dtype).name != "fp32"
    if quantized:
        _require_f32_for_gather(x.dtype, kv_dtype, "batch prefill")
    t = x.shape[1]
    hd = cfg.resolved_head_dim
    bs = k_store.shape[1]
    w = table_row.shape[0]
    g = cfg.n_kv_heads
    gpos = p0 + torch.arange(t, device=x.device)             # [T]
    q, k_new, v_new = _project_qkv(x, attn, cfg,
                                   site_positions(cfg, gpos[None]))
    new_valid = torch.arange(t, device=x.device) < n_new
    tbl = table_row.long()
    blk = torch.where(new_valid, tbl[torch.clamp(gpos // bs, 0, w - 1)], 0)
    off = torch.where(new_valid, gpos % bs, 0)
    # in place; the reference returns a copy (cache.at[blk, off].set)
    _scatter(k_store, k_scale, blk, off, k_new[0], kv_dtype)
    _scatter(v_store, v_scale, blk, off, v_new[0], kv_dtype)
    if quantized:
        k = quant.dequantize_kv(k_store[tbl], k_scale[tbl], kv_dtype)
        v = quant.dequantize_kv(v_store[tbl], v_scale[tbl], kv_dtype)
    else:
        k, v = k_store[tbl], v_store[tbl]
    k = k.reshape(1, w * bs, g, hd)
    v = v.reshape(1, w * bs, g, hd)
    qg = q.reshape(1, t, g, cfg.n_heads // g, hd)             # [1,T,G,R,D]
    scores = (torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
              / math.sqrt(hd))
    # causal over global positions; keys past the written region are
    # excluded by the same bound
    valid = (torch.arange(w * bs, device=x.device)[None]
             <= gpos[:, None])                                # [T, L]
    scores = scores.masked_fill(~valid[None, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(1, t, cfg.n_heads * hd) @ attn.wo


def paged_kv_dequant_error(store: dict, ref: dict,
                           kv_dtype: str) -> torch.Tensor:
    """Measured KV dequantization error of a quantized paged store
    against its fp32 golden twin: max over entries of
    ``|dequant(codes, scale) - ref| / per-(token, head) absmax`` —
    directly comparable to ``quant.layer_error_budget(kv_dtype)``.

    Leaves are the stacked ``[n_layers, num_blocks, block_size, G,
    head_dim]``; returns one float32 value per layer (zeros for fp32
    stores). Unwritten entries are zero in both stores and add 0."""
    s = quant.spec(kv_dtype)
    errs = []
    for name in ("k", "v"):
        refv = ref[name].to(torch.float32)
        if s.name == "fp32":
            dq = store[name].to(torch.float32)
        else:
            dq = quant.dequantize_kv(store[name], store[name + "_scale"], s)
        amax = refv.abs().amax(dim=-1, keepdim=True)
        rel = (dq - refv).abs() / torch.clamp_min(amax, 1e-20)
        errs.append(rel.amax(dim=tuple(range(1, refv.dim()))))
    return torch.maximum(errs[0], errs[1])
