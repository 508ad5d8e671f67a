"""Decoder-only LM: the port of ``repro.models.transformer.DecoderLM``
for ``block_pattern="attn"`` (llama3-8b; with q/k/v biases, qwen2.5-32b;
per-head q/k norms, qwen3-32b; the rotation over half the head dims,
chatglm3-6b; frame embeddings in, musicgen-medium; embeddings in, M-RoPE
over a (t, h, w) position grid and the head tied to the embedding table,
qwen2-vl-2b; mixture-of-experts FFNs, granite-moe-1b-a400m on every
layer and llama4-maverick-400b-a17b on every second with a shared
expert), on a paged KV pool and against a contiguous cache; and for
the recurrent patterns (item 5.4, serving), ``"xlstm"`` (xlstm-350m:
units of an mLSTM then an sLSTM block) and ``"mamba_shared_attn"``
(zamba2-7b: groups of ``shared_attn_every`` Mamba2 layers, each followed
by one weight-tied attention + MLP block, then a tail of Mamba2 layers),
whose blocks are ``models.ssm``'s, against a contiguous cache of their
O(1) states (and zamba2's per-group KV).

The reference stacks units of ``unit_blocks`` blocks (``moe_interleave``
with experts: the unit's last block has the MoE FFN, the others the
dense MLP; one block otherwise) on a leading axis and scans over them,
its tree ``layers/block<i>/…``; the port keeps one ``nn.Module`` per
layer, layer ``u·n + i`` being block ``i`` of unit ``u``, and loops. The
KV pool stays one stacked tensor per leaf, ``[n_layers, num_blocks,
block_size, G, head_dim]``, so a block copy or swap is one index
operation across every layer; ``pool_tree`` views it as the reference's
per-block tree. Parameters are created empty on the model's device;
``init(seed)`` fills them from a seeded ``torch.Generator`` on that
device (the reference's distributions, not its numbers).

The MoE configs serve and train everywhere llama3-8b does: the
differentiated stack writes out the MoE block's VJP too
(``moe.moe_block_bwd``). The recurrent patterns serve through
``decode_step`` and ``hidden_states`` / ``apply`` undifferentiated
(``_decode_recurrent``, ``_forward_recurrent``: each of the reference's
loops a ``"scan"`` region — the units, zamba2's groups with a ``"mamba"``
loop inside each, its ``"tail"``), with one module a layer (``ssm.
RecurrentBlock``) and zamba2's shared block once (``SharedBlock``);
``leaf_layout`` maps every leaf of the tree to the modules holding its
slices. They train through ``_RecurrentStack``: the blocks spelled on a
``lin.Tape``, whose transpose is the reference's, op for op (the loops'
transposes, the chunk bodies recomputed as its checkpoint does, the
shared block's gradients summed over the groups). The paged entry
points raise for them, as the reference's do.

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
    (``launch.steps.make_serve_step``). Each unit runs in a ``"scan"``
    region (``core.estimator.region``), which the mapper's graph folds
    back into the reference's scanned nodes;
  * ``decode_step_paged(cfg, params, cache, token, block_table, pos)``
    -> (logits ``[B, V]``, the written pool slices): the paged tick on the
    same tree, over the engine's pool written in place, each unit one
    iteration of the ``"scan"`` region — what ``ServeEngine(backend=
    "pim")`` maps (``serve.map_paged_tick``); the method of the same name
    stays the jit engine's tick;
  * ``hidden_states(cfg, params, tokens)`` / ``apply`` -> the final-norm
    hidden states ``[B, S, D]`` / the logits ``[B, S, V]`` over a whole
    sequence (train and prefill), functions of the same tree; above
    ``CHUNKED_ATTN_THRESHOLD`` tokens the attention is the chunked flash
    path (``attention.chunked_causal_attention``). Undifferentiated (a
    prefill), the stack is ``_forward_stack``, the reference's plain
    scan. Differentiated, it is one ``autograd.Function``
    (``_LayerStack``): its forward runs each unit of ``unit_blocks``
    blocks as one iteration of the ``"scan"`` region ``"layers"``, its
    backward each unit's VJP, last unit (and last block) first, as one
    iteration of ``"layers.T"`` — the reference's scan and its
    transpose. The VJP is written out op for op in the order the
    reference's transpose emits (``_unit_backward``, an MoE block's FFN
    ``moe.moe_block_bwd``), so the mapper traces the reference's nodes;
    what the reference's linearization hoists out of its scan (each
    block's rope tables, the slot map's group offsets) is made once
    before the stack; under ``cfg.remat`` each iteration first
    recomputes its unit's forward from the saved unit input, as the
    reference's ``jax.checkpoint``-ed scan body does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch._device import resolve_device, torch_dtype
from repro_torch._tree import leaves_with_path, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimator
from repro_torch.models import attention, layers, lin, moe, ssm
from repro_torch.parallel import sharding

# the reference's per-block leaves of a dense block (``layers/block<i>/
# <name>``, stacked over the units on a leading axis) and the port's block
# module attribute of each; ``block_leaves`` adds the attention variants'
# own and swaps the MLP for the MoE FFN in an MoE block
LAYER_LEAVES = {"norm1/scale": "norm1.scale", "norm2/scale": "norm2.scale",
                "attn/wq": "attn.wq", "attn/wk": "attn.wk",
                "attn/wv": "attn.wv", "attn/wo": "attn.wo",
                "mlp/w_gate": "mlp.w_gate", "mlp/w_up": "mlp.w_up",
                "mlp/w_down": "mlp.w_down"}
_BIAS_LEAVES = ("attn/q_bias", "attn/k_bias", "attn/v_bias")
_NORM_LEAVES = ("attn/q_norm", "attn/k_norm")
_MOE_LEAVES = ("moe/router", "moe/w_gate", "moe/w_up", "moe/w_down")
_SHARED_LEAVES = ("moe/shared_expert/w_gate", "moe/shared_expert/w_up",
                  "moe/shared_expert/w_down")


def unit_blocks(cfg: ArchConfig) -> int:
    """Blocks in one scanned unit: ``moe_interleave`` with experts (the
    last block's FFN the MoE, the others dense), else 1. Layer ``u·n + i``
    is block ``i`` of unit ``u``."""
    return max(cfg.moe_interleave, 1) if cfg.n_experts else 1


RECURRENT = ("xlstm", "mamba_shared_attn")


def n_units(cfg: ArchConfig) -> int:
    """The scanned units of the stack (the reference's ``StackLayout``):
    xlstm's are (mLSTM, sLSTM) pairs, zamba2's groups of
    ``shared_attn_every`` Mamba2 layers (the rest the tail,
    ``tail_units``)."""
    if cfg.block_pattern == "xlstm":
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.n_layers} layers are not whole "
                             f"(mLSTM, sLSTM) units")
        return cfg.n_layers // 2
    if cfg.block_pattern == "mamba_shared_attn":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.block_pattern != "attn":
        raise ValueError(cfg.block_pattern)
    n = unit_blocks(cfg)
    if cfg.n_layers % n:
        raise ValueError(f"{cfg.n_layers} layers are not whole units of "
                         f"{n} blocks")
    return cfg.n_layers // n


def is_moe(cfg: ArchConfig, i: int) -> bool:
    """Whether block ``i`` of a unit has the MoE FFN."""
    return cfg.n_experts > 0 and i == unit_blocks(cfg) - 1


def block_leaves(cfg: ArchConfig, i: int) -> dict[str, str]:
    """Block ``i``'s leaves -> the attribute of each on its ``Block``:
    ``LAYER_LEAVES`` with the q/k/v biases (``qkv_bias``) and the q/k
    norm scales (``qk_norm``) of configs that have them, the MoE's in
    place of the MLP's in an MoE block."""
    extra = (_BIAS_LEAVES if cfg.qkv_bias else ()) + (
        _NORM_LEAVES if cfg.qk_norm else ())
    leaves = {**LAYER_LEAVES}
    if is_moe(cfg, i):
        leaves = {k: a for k, a in leaves.items() if not k.startswith("mlp/")}
        extra += _MOE_LEAVES + (_SHARED_LEAVES if cfg.shared_expert else ())
    return {**leaves, **{key: key.replace("/", ".") for key in extra}}


def layer_leaves(cfg: ArchConfig) -> dict[str, str]:
    """Every leaf under ``layers/``, ``block<i>/<name>``, -> its attribute
    on block ``i``'s module (``block_leaves``)."""
    return {f"block{i}/{key}": attr for i in range(unit_blocks(cfg))
            for key, attr in block_leaves(cfg, i).items()}


def stack_leaves(cfg: ArchConfig) -> tuple[str, ...]:
    """The stack's leaves in the reference's (sorted) key order, the order
    its scan takes them: ``block0/…`` before ``block1/…``,
    ``attn/k_bias`` before ``attn/wk``, ``moe`` before ``norm1``."""
    return tuple(sorted(layer_leaves(cfg)))


def _block_shapes(cfg: ArchConfig, i: int) -> dict[str, tuple[int, ...]]:
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    shapes = {"norm1/scale": (d,), "norm2/scale": (d,),
              "attn/wq": (d, hq), "attn/wk": (d, hkv),
              "attn/wv": (d, hkv), "attn/wo": (hq, d)}
    if is_moe(cfg, i):
        e, fe = cfg.n_experts, cfg.moe_d_ff
        shapes.update({"moe/router": (d, e), "moe/w_gate": (e, d, fe),
                       "moe/w_up": (e, d, fe), "moe/w_down": (e, fe, d)})
        if cfg.shared_expert:
            shapes.update({"moe/shared_expert/w_gate": (d, f),
                           "moe/shared_expert/w_up": (d, f),
                           "moe/shared_expert/w_down": (f, d)})
    else:
        shapes.update({"mlp/w_gate": (d, f), "mlp/w_up": (d, f),
                       "mlp/w_down": (f, d)})
    if cfg.qkv_bias:
        shapes.update({"attn/q_bias": (hq,), "attn/k_bias": (hkv,),
                       "attn/v_bias": (hkv,)})
    if cfg.qk_norm:
        shapes.update({"attn/q_norm": (hd,), "attn/k_norm": (hd,)})
    return shapes


def tail_units(cfg: ArchConfig) -> int:
    """zamba2's Mamba2 layers after its last whole group (a scan of their
    own in the reference, ``tail_layers``); 0 for the other patterns."""
    if cfg.block_pattern != "mamba_shared_attn":
        return 0
    return cfg.n_layers % cfg.shared_attn_every


def _recurrent_groups(cfg: ArchConfig) -> list:
    """The recurrent patterns' parameter groups: (tree prefix, stacked
    dims, the leaves' shapes, the module path of slice ``i`` in row-major
    order over the stacked dims). xlstm: unit ``u``'s mLSTM and sLSTM
    are layers ``2u`` and ``2u + 1``; zamba2: group ``u``'s Mamba2 layer
    ``j`` is layer ``u·every + j``, the tail's ``t`` the layer after the
    groups', the weight-tied shared block one module, ``shared``."""
    d, h = cfg.d_model, cfg.n_heads
    units = n_units(cfg)
    if cfg.block_pattern == "xlstm":
        return [("layers/mlstm", (units,), ssm.mlstm_shapes(d, h),
                 lambda i: f"layers.{2 * i}"),
                ("layers/slstm", (units,), ssm.slstm_shapes(d, h),
                 lambda i: f"layers.{2 * i + 1}")]
    every, tail = cfg.shared_attn_every, tail_units(cfg)
    mamba = ssm.mamba2_shapes(d, cfg.ssm_state, cfg.mamba_headdim,
                              cfg.mamba_conv_width)
    hd, f = cfg.resolved_head_dim, cfg.d_ff
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    groups = [("layers/mamba", (units, every), mamba, lambda i: f"layers.{i}")]
    if tail:
        groups.append(("tail_layers/mamba", (tail,), mamba,
                       lambda i: f"layers.{units * every + i}"))
    return groups + [
        ("shared_attn", (), {"wk": (d, hkv), "wo": (hq, d), "wq": (d, hq),
                             "wv": (d, hkv)}, lambda i: "shared.attn"),
        ("shared_mlp", (), {"w_down": (f, d), "w_gate": (d, f),
                            "w_up": (d, f)}, lambda i: "shared.mlp"),
        ("shared_norm1", (), {"scale": (d,)}, lambda i: "shared.norm1"),
        ("shared_norm2", (), {"scale": (d,)}, lambda i: "shared.norm2")]


def leaf_layout(cfg: ArchConfig) -> dict[str, tuple]:
    """Every leaf of the reference's parameter tree by its '/'-joined key
    path -> (its stacked dims, the shape of one slice, the ``DecoderLM``
    parameter holding each slice in row-major order): the one table the
    module's tree (``DecoderLM.stacked_params``) and the bridge read.
    Leaves outside a stack have no stacked dims and one owner."""
    d, v = cfg.d_model, cfg.vocab_size
    out = {"embed/table": ((), (v, d), ["embed.table"]),
           "final_norm/scale": ((), (d,), ["final_norm.scale"])}
    if not cfg.tie_embeddings:
        out["lm_head/w"] = ((), (d, v), ["lm_head.w"])
    if cfg.block_pattern == "attn":
        n, units = unit_blocks(cfg), n_units(cfg)
        for i in range(n):
            attrs = block_leaves(cfg, i)
            for k, shape in _block_shapes(cfg, i).items():
                out[f"layers/block{i}/{k}"] = (
                    (units,), shape,
                    [f"layers.{u * n + i}.{attrs[k]}" for u in range(units)])
        return out
    for prefix, dims, shapes, owner in _recurrent_groups(cfg):
        for k, shape in shapes.items():
            attr = k.replace("/", ".")
            out[f"{prefix}/{k}"] = (dims, shape, [
                f"{owner(i)}.{attr}" for i in range(math.prod(dims))])
    return out


def leaf_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Every leaf of the reference's parameter tree by its '/'-joined key
    path (``checkpoint/ckpt.py:_flatten``'s), with its shape: the stacked
    leaves (``layers/block<i>/…`` over ``n_units``; the recurrent
    patterns' ``layers/…`` and ``tail_layers/…``) with their stacked dims
    first (``leaf_layout``)."""
    return {key: (*dims, *shape)
            for key, (dims, shape, _) in leaf_layout(cfg).items()}


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


def head_weight(cfg: ArchConfig, params: dict) -> torch.Tensor:
    """The LM head's weight [D, V]: with ``cfg.tie_embeddings`` the
    embedding table's transpose, a view (the head's product reads the
    table where it lies), else ``lm_head.w``."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].t()
    return params["lm_head"]["w"]


def logits_of(cfg: ArchConfig, params: dict,
              x: torch.Tensor) -> torch.Tensor:
    """The LM head on the final norm's output ``x`` [..., D] (the
    reference's ``_logits``): ``x @ table.T`` when tied."""
    return layers.lm_head(x, head_weight(cfg, params))


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor):
    """The reference's ``DecoderLM.decode_step``: token [B] int, or [B, 1,
    D] embeddings (cast to the model dtype); pos a 0-d int tensor, the
    current position; ``params`` the reference's tree (``param_tree``),
    ``cache`` ``{"layers": {"block<i>": {"k", "v"}}}``, leaves ``[n_units,
    B, max_len, G, hd]``. Returns (logits [B, V], the updated cache,
    written out of place). Each unit (``unit_blocks`` blocks) is one
    iteration of a ``"scan"`` region. The recurrent patterns take their
    own cache (``DecoderLM.init_cache``; ``_decode_recurrent``)."""
    if token.dim() == 1:
        x = layers.embed(token[:, None], params["embed"]["table"])
    else:
        x = token.to(torch_dtype(cfg.dtype))
    if cfg.block_pattern in RECURRENT:
        x, cache = _decode_recurrent(cfg, params, cache, x, pos)
        x = layers.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return logits_of(cfg, params, x)[:, 0], cache
    n = unit_blocks(cfg)
    keys = stack_leaves(cfg)
    leaves = _stacked(params["layers"], keys)
    lc = cache["layers"]
    new = [{"k": [], "v": []} for _ in range(n)]
    for u in range(n_units(cfg)):
        with estimator.region("scan", "layers"):
            # the iteration's slices first, as the reference's scan body
            # takes its xs: the leaves in sorted key order, then the cache
            w = _layer(keys, leaves, u)
            sites = [{"k": lc[f"block{i}"]["k"][u],
                      "v": lc[f"block{i}"]["v"][u]} for i in range(n)]
            for i in range(n):
                wb = _block(w, i)
                h = layers.rms_norm(x, wb["norm1/scale"], cfg.norm_eps)
                att, kv = attention.decode_attention(
                    h, _group(wb, "attn/"), cfg, sites[i], pos)
                x = x + att
                new[i]["k"].append(kv["k"])
                new[i]["v"].append(kv["v"])
                h = layers.rms_norm(x, wb["norm2/scale"], cfg.norm_eps)
                x = x + _ffn(cfg, h, wb)
    x = layers.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_of(cfg, params, x)
    return logits[:, 0], {"layers": {
        f"block{i}": {name: torch.stack(ts) for name, ts in new[i].items()}
        for i in range(n)}}


def _slices(trees, i: int) -> list[dict]:
    """Slice ``i`` of every leaf of each tree, taken in the order a scan
    takes its xs (the trees in turn, each's leaves in sorted key order):
    the slices of one iteration, made at its start."""
    return [tree_map(lambda t: t[i], tree) for tree in trees]


def _stack_trees(trees: list[dict]) -> dict:
    """The per-iteration trees stacked leaf by leaf on a new leading axis
    (a scan's ys)."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _flat(tree: dict) -> dict:
    """A block's nested leaves as the '/'-joined names ``models.ssm``'s
    functions read (``"norm/scale"``, ``"w_q"``)."""
    return dict(leaves_with_path(tree))


def _decode_recurrent(cfg: ArchConfig, params: dict, cache: dict,
                      x: torch.Tensor, pos: torch.Tensor):
    """The recurrent patterns' layer stack of ``decode_step``: (x, the new
    cache), each loop of the reference's a ``"scan"`` region whose
    iteration slices its params and state first. xlstm: one region a
    unit, its mLSTM then its sLSTM step (``cache["layers"]``: ``mlstm``
    {C, m, n}, ``slstm`` {c, h, m, n}, each ``[n_units, B, …]``).
    zamba2: one ``"layers"`` region a group, inside it one ``"mamba"``
    region a Mamba2 step (``cache["layers"]["mamba"]`` {conv, ssm}
    ``[n_units, every, B, …]``), then the weight-tied shared attention +
    MLP on the group's own KV (``shared_kv`` {k, v} ``[n_units, B,
    max_len, G, hd]``), its weights read whole in every group, as the
    reference's scan takes them as consts; then the tail, one ``"tail"``
    region a layer (``cache["tail"]``)."""
    if cfg.block_pattern == "xlstm":
        new = []
        for u in range(n_units(cfg)):
            with estimator.region("scan", "layers"):
                up, uc = _slices((params["layers"], cache["layers"]), u)
                x, m_st = ssm.mlstm_step(x, _flat(up["mlstm"]),
                                         uc["mlstm"], cfg.n_heads)
                x, s_st = ssm.slstm_step(x, _flat(up["slstm"]),
                                         uc["slstm"], cfg.n_heads)
            new.append({"mlstm": m_st, "slstm": s_st})
        return x, {"layers": _stack_trees(new)}
    kw = dict(ssm_state=cfg.ssm_state, headdim=cfg.mamba_headdim)
    eps = cfg.norm_eps
    sm = params["shared_mlp"]
    groups = []
    for u in range(n_units(cfg)):
        with estimator.region("scan", "layers"):
            gp, gc = _slices((params["layers"], cache["layers"]), u)
            states = []
            for j in range(cfg.shared_attn_every):
                with estimator.region("scan", "mamba"):
                    lp, st = _slices((gp, gc["mamba"]), j)
                    x, st = ssm.mamba2_step(x, _flat(lp["mamba"]), st, **kw)
                states.append(st)
            mamba_new = _stack_trees(states)
            h = layers.rms_norm(x, params["shared_norm1"]["scale"], eps)
            att, kv = attention.decode_attention(
                h, params["shared_attn"], cfg, gc["shared_kv"], pos)
            x = x + att
            h = layers.rms_norm(x, params["shared_norm2"]["scale"], eps)
            x = x + layers.mlp(h, sm["w_gate"], sm["w_up"], sm["w_down"])
        groups.append({"mamba": mamba_new, "shared_kv": kv})
    new_cache = {"layers": _stack_trees(groups)}
    tail = []
    for t in range(tail_units(cfg)):
        with estimator.region("scan", "tail"):
            lp, st = _slices((params["tail_layers"], cache["tail"]), t)
            x, st = ssm.mamba2_step(x, _flat(lp["mamba"]), st, **kw)
        tail.append(st)
    if tail:
        new_cache["tail"] = _stack_trees(tail)
    return x, new_cache


def _forward_recurrent(cfg: ArchConfig, params: dict, x: torch.Tensor,
                       positions: torch.Tensor,
                       chunked: bool) -> torch.Tensor:
    """The recurrent patterns' undifferentiated stack over a sequence
    (prefill), the reference's ``hidden_states`` scans: xlstm's units the
    chunked mLSTM (``ssm.mlstm_seq_chunked``, chunk 256) then the sLSTM
    (``ssm.slstm_seq``); zamba2's groups their chunked Mamba2 layers
    (``ssm.mamba2_seq_chunked``, chunk 128) then the shared attention
    block (above ``CHUNKED_ATTN_THRESHOLD`` tokens the chunked flash
    path), then the tail. One ``"scan"`` region an iteration, as in
    ``_decode_recurrent``."""
    if cfg.block_pattern == "xlstm":
        for u in range(n_units(cfg)):
            with estimator.region("scan", "layers"):
                up, = _slices((params["layers"],), u)
                x = ssm.mlstm_seq_chunked(x, _flat(up["mlstm"]), cfg.n_heads)
                x = ssm.slstm_seq(x, _flat(up["slstm"]), cfg.n_heads)
                x = sharding.constrain(x, ("batch", None, None))
        return x
    kw = dict(ssm_state=cfg.ssm_state, headdim=cfg.mamba_headdim)
    eps = cfg.norm_eps
    sm = params["shared_mlp"]
    for u in range(n_units(cfg)):
        with estimator.region("scan", "layers"):
            gp, = _slices((params["layers"],), u)
            for j in range(cfg.shared_attn_every):
                with estimator.region("scan", "mamba"):
                    lp, = _slices((gp,), j)
                    x = ssm.mamba2_seq_chunked(x, _flat(lp["mamba"]), **kw)
                    x = sharding.constrain(x, ("batch", None, None))
            h = layers.rms_norm(x, params["shared_norm1"]["scale"], eps)
            x = x + attention.attention_block(h, params["shared_attn"], cfg,
                                              positions, chunked=chunked)
            h = layers.rms_norm(x, params["shared_norm2"]["scale"], eps)
            x = x + layers.mlp(h, sm["w_gate"], sm["w_up"], sm["w_down"])
    for t in range(tail_units(cfg)):
        with estimator.region("scan", "tail"):
            lp, = _slices((params["tail_layers"],), t)
            x = ssm.mamba2_seq_chunked(x, _flat(lp["mamba"]), **kw)
    return x


def recurrent_leaves(cfg: ArchConfig) -> tuple[str, ...]:
    """The recurrent stack's leaves by key path, the order
    ``_RecurrentStack`` takes them: xlstm's ``layers/mlstm/…`` then
    ``layers/slstm/…``; zamba2's ``layers/mamba/…``, ``tail_layers/
    mamba/…`` and the shared block's (``leaf_layout``'s order)."""
    return tuple(k for k in leaf_layout(cfg)
                 if k.startswith(("layers/", "tail_layers/", "shared_")))


# the shared block's leaves under the names ``_unit_forward`` reads
_SHARED_NAMES = {"shared_norm1/scale": "norm1/scale",
                 "shared_attn/wq": "attn/wq", "shared_attn/wk": "attn/wk",
                 "shared_attn/wv": "attn/wv", "shared_attn/wo": "attn/wo",
                 "shared_norm2/scale": "norm2/scale",
                 "shared_mlp/w_gate": "mlp/w_gate",
                 "shared_mlp/w_up": "mlp/w_up",
                 "shared_mlp/w_down": "mlp/w_down"}


def _shared_block_t(t, x, w: dict, cfg: ArchConfig, positions, mask,
                    keep: bool):
    """zamba2's weight-tied attention + MLP block on the tape: the dense
    block of the attention stack (``_unit_forward``; rope ``"none"``, so
    no tables), its VJP ``_unit_backward`` recorded as one linear op of
    the block's input and leaves (``w`` keyed as ``_SHARED_NAMES``)."""
    chunked = mask is None
    if not t.lin:
        return _unit_forward(x, w, cfg, positions, mask, chunked=chunked,
                             residuals=False)["out"]
    r = _unit_forward(x, w, cfg, positions, mask, full=keep,
                      chunked=chunked)
    out = r["out"] if keep else x.new_empty(()).expand(x.shape)
    names = list(w)

    def rule(g):
        dx, grads = _unit_backward(g[0], r, w, cfg)
        return (dx, *[grads[n] for n in names])

    t.custom([out], [x, *w.values()], rule)
    return out


class _Holder:
    """What ``_RecurrentStack``'s forward leaves for its backward: the
    tape (its recorded transposes hold the residuals), the forward's own
    input and output tensors. Passed as an input, so ``torch.func``
    hands it to the backward as it is (not a pytree)."""

    tape = out = inputs = None


def _recurrent_forward(t, cfg: ArchConfig, x, positions, mask,
                       p: dict) -> torch.Tensor:
    """The recurrent stack on the tape ``t``: each loop of the reference's
    ``hidden_states`` a ``Tape.loop`` (a ``Tape.checkpoint_loop`` under
    ``cfg.remat``, as the reference checkpoints each unit and, in zamba2,
    each Mamba2 layer inside a group and each tail layer). The chunk
    bodies' ``-1`` indices are made once before each stack without remat,
    where the reference's linearization hoists them."""
    h, remat = cfg.n_heads, cfg.remat
    top = t.checkpoint_loop if remat else t.loop

    def group(prefix):
        keys = [k for k in p if k.startswith(prefix)]
        return keys, [p[k] for k in keys]

    if cfg.block_pattern == "xlstm":
        mk, mv = group("layers/mlstm/")
        sk, sv = group("layers/slstm/")
        idx = None if remat else ssm.chunk_indices(cfg, x.shape[1],
                                                   x.device)

        def unit(tc, consts, carry, xs, keep=True):
            pm = {k[len("layers/mlstm/"):]: v for k, v in zip(mk, xs)}
            ps = {k[len("layers/slstm/"):]: v
                  for k, v in zip(sk, xs[len(mk):])}
            y = ssm.mlstm_block_t(tc, carry[0], pm, h, 1e-5, idx=idx)
            y = ssm.slstm_block_t(tc, y, ps, h, 1e-5, keep=keep)
            return [y], []

        (x,), _ = top(unit, [x], mv + sv, [], "layers")
        return x
    kw = dict(ssm_state=cfg.ssm_state, headdim=cfg.mamba_headdim, eps=1e-5)
    gk, gv = group("layers/mamba/")
    shared = {_SHARED_NAMES[k]: p[k] for k in _SHARED_NAMES}
    idx = None if remat else ssm.chunk_indices(cfg, x.shape[1], x.device)

    def mamba(names):
        def layer(tc, consts, carry, xs, keep=True):
            lp = {k.split("/mamba/")[1]: v for k, v in zip(names, xs)}
            return [ssm.mamba2_block_t(tc, carry[0], lp, keep=keep,
                                       idx=idx, **kw)], []
        return layer

    def unit(tc, consts, carry, xs, keep=True):
        inner = tc.checkpoint_loop if remat else tc.loop
        (y,), _ = inner(mamba(gk), carry, xs, [], "mamba")
        w = dict(zip(shared, consts))
        return [_shared_block_t(tc, y, w, cfg, positions, mask, keep)], []

    (x,), _ = top(unit, [x], gv, list(shared.values()), "layers")
    tk, tv = group("tail_layers/mamba/")
    if tv:
        idx = None if remat else ssm.chunk_indices(cfg, x.shape[1],
                                                   x.device)
        (x,), _ = top(mamba(tk), [x], tv, [], "tail")
    return x


class _RecurrentStack(torch.autograd.Function):
    """The recurrent stack differentiated (``hidden_states`` under
    autograd): inputs the config, a ``_Holder``, x, positions, the causal
    mask (zamba2's shared attention; None when chunked or absent) and the
    leaves of ``recurrent_leaves(cfg)``. The forward is the reference's
    linearized forward on a ``lin.Tape`` (``_recurrent_forward``), each
    unit one iteration of the ``"scan"`` region ``"layers"`` (zamba2: an
    inner ``"mamba"`` loop per group, then the ``"tail"``); the backward
    transposes the tape, last unit first, in ``"layers.T"`` (and
    ``"mamba.T"``, ``"tail.T"``) — the reference's transposed scans, op
    for op, with the shared block's gradients summed over the groups."""

    @staticmethod
    def forward(cfg, holder, x, positions, mask, *leaves):
        t = lin.Tape(True)
        t.var(x, *leaves)
        holder.inputs = (x, *leaves)
        holder.out = _recurrent_forward(
            t, cfg, x, positions, mask,
            dict(zip(recurrent_leaves(cfg), leaves, strict=True)))
        holder.tape = t
        return holder.out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.holder = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        h = ctx.holder
        # no_grad: the VJP is written out and never differentiated, and
        # its unpriced ops (estimator.add_any, silu_vjp, softplus_vjp,
        # select_parts) have no VJP for torch.func to record
        with torch.no_grad():
            acc = h.tape.transpose({h.out: ct})
            grads = [_or_zeros(h.tape.ct_of(acc, v), v) for v in h.inputs]
        h.tape = h.out = h.inputs = None
        return (None, None, grads[0], None, None, *grads[1:])


def _or_zeros(c, like: torch.Tensor) -> torch.Tensor:
    return c if c is not None else torch.zeros_like(like)


def _not_paged(cfg: ArchConfig, what: str) -> None:
    """The reference's ``NotImplementedError`` for a paged entry point of
    a recurrent pattern: it holds O(1) state a slot, nothing to page."""
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"{what} requires block_pattern='attn', "
            f"got {cfg.block_pattern!r}")


def pool_tree(cfg: ArchConfig, pool: dict) -> dict:
    """The engine's KV pool (``DecoderLM.init_paged_cache``: leaves
    ``[n_layers, …]``) as the reference's cache tree, ``{"layers":
    {"block<i>": {leaf: [n_units, …]}}}``: block ``i``'s leaves are views
    of the pool's layers ``i, i + n, …``, so a write into the tree lands
    in the pool and a block copy in the pool moves every site."""
    n = unit_blocks(cfg)
    return {"layers": {f"block{i}": {name: t[i::n] for name, t in
                                     pool.items()} for i in range(n)}}


def decode_step_paged(cfg: ArchConfig, params: dict, cache: dict,
                      token: torch.Tensor, block_table: torch.Tensor,
                      pos: torch.Tensor, *, kernel: bool = False,
                      kv_dtype: str = "fp32"):
    """The reference's ``DecoderLM.decode_step_paged`` on its parameter
    tree (``param_tree``): token [B] int; block_table [B, W] int32; pos
    [B] int32 per-slot positions. ``cache`` is ``pool_tree(cfg, pool)``,
    ``pool`` the engine's KV pool (``DecoderLM.init_paged_cache``), written
    in place — never copied: at llama3-8b's width it holds gigabytes.
    Returns (logits [B, V], ``{"layers": {"block<i>": {leaf: [unit 0's
    slice, ...]}}}``), each slice a view of ``cache``'s leaf that its
    site wrote: the reference's new cache, a stack of its units' pools,
    with nothing stacked.

    Each unit is one iteration of a ``"scan"`` region, its slices taken
    at the iteration's start in the order the reference's scan takes its
    xs (the leaves in sorted key order, then the pool's), so the mapper
    folds it into the reference's scanned nodes; each site is
    ``attention.paged_decode_attention_tree``. ``kernel=True`` runs every
    site's attention on K4 (K6 over a quantized ``kv_dtype``)."""
    _not_paged(cfg, "paged decode")
    x = layers.embed(token[:, None], params["embed"]["table"])
    n = unit_blocks(cfg)
    keys = stack_leaves(cfg)
    leaves = _stacked(params["layers"], keys)
    lcs = [cache["layers"][f"block{i}"] for i in range(n)]
    written = [{name: [] for name in sorted(lc)} for lc in lcs]
    for u in range(n_units(cfg)):
        with estimator.region("scan", "layers"):
            w = _layer(keys, leaves, u)
            sites = [{name: lc[name][u] for name in sorted(lc)}
                     for lc in lcs]
            for i in range(n):
                wb = _block(w, i)
                h = layers.rms_norm(x, wb["norm1/scale"], cfg.norm_eps)
                att, sites[i] = attention.paged_decode_attention_tree(
                    h, _group(wb, "attn/"), cfg, sites[i], block_table, pos,
                    use_kernel=kernel, kv_dtype=kv_dtype)
                x = x + att
                h = layers.rms_norm(x, wb["norm2/scale"], cfg.norm_eps)
                x = x + _ffn(cfg, h, wb)
        for i, site in enumerate(sites):
            for name, t in site.items():
                written[i][name].append(t)
    x = layers.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_of(cfg, params, x)
    return logits[:, 0], {"layers": {f"block{i}": written[i]
                                     for i in range(n)}}


# sequence length above which the reference attends chunk by chunk
# (attention.chunked_causal_attention: the pair-scan flash path)
CHUNKED_ATTN_THRESHOLD = 2048


def leaf_at(tree: dict, key: str):
    """The leaf at the '/'-joined path ``key`` of a nested tree."""
    for part in key.split("/"):
        tree = tree[part]
    return tree


def _stacked(lp: dict, keys) -> list:
    """The stacked leaves of ``params["layers"]`` in ``keys``' order."""
    return [leaf_at(lp, key) for key in keys]


def _layer(keys, leaves, u: int) -> dict:
    """Unit ``u``'s slice of every stacked leaf, by its key."""
    return {key: leaf[u] for key, leaf in zip(keys, leaves, strict=True)}


def _group(w: dict, prefix: str) -> dict:
    """The entries of ``w`` under ``prefix``, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def _block(w: dict, i: int) -> dict:
    """Block ``i``'s leaves of a unit's slice ``w`` (keys ``attn/wq``…)."""
    return _group(w, f"block{i}/")


def _ffn(cfg: ArchConfig, h: torch.Tensor, w: dict) -> torch.Tensor:
    """A block's FFN on the normed ``h``: the MoE (``moe.moe_block``) in
    an MoE block, else the SwiGLU MLP."""
    if "moe/router" in w:
        return moe.moe_block(h, param_tree(_group(w, "moe/")), cfg)
    return layers.mlp(h, w["mlp/w_gate"], w["mlp/w_up"], w["mlp/w_down"])


def _unit_forward(x, w: dict, cfg: ArchConfig, positions, mask,
                  tables=None, *, full: bool = True, chunked: bool = False,
                  infer: bool = False, residuals: bool = True,
                  g_off=None) -> dict:
    """One block's forward over a sequence, returning what its VJP reads
    (under ``infer``, only its output ``out``). An MoE block's FFN is
    ``moe.moe_forward``, its values under ``moe/<name>``: linearized
    where the layer is, its gathers and selections the reference's
    calls in the recomputing body (``tables`` None), ``g_off`` the slot
    map's hoisted group offsets (None: made here, as the recomputing body
    and the undifferentiated forward make them).

    ``tables``: the (q, k) rope tables made once outside the stack, as
    the reference's linearization hoists them out of its scan; ``None``
    makes them here, before each rotation, as its recomputing (remat)
    body and its undifferentiated forward do. The recomputing body takes
    the masked scores through ``estimator.select_parts`` (the mask and
    the zero the selection's VJP reads then come from the scores, as in
    the reference's graph); ``infer=True``, the forward of a step that
    takes no gradient, selects them plainly.

    ``chunked``: the attention is the chunked flash path (``mask`` unused)
    and the layer keeps its output and log-sum-exp for the VJP; inlined
    (``attention.chunked_forward``) where the layer is differentiated, as
    the reference's linearization inlines the custom VJP's forward, a
    call of its own (``attention.chunked_causal_attention``) under
    ``infer``. ``full=False`` stops where the VJP stops reading: before
    the down projection; ``residuals=False`` (the forward of a remat
    stack, whose VJP recomputes the layer) computes no chunked lse, as
    the reference's checkpointed forward drops it.

    The attention variants take the reference's ``_project_qkv`` order:
    the q/k/v biases after the products (``qkv_bias``), the per-head norms
    after the heads split (``qk_norm``; differentiated, with the ops the
    reference's linearization adds for the VJP:
    ``layers.head_rms_norm_parts``), the
    rotation over the first ``layers.rotary_dim`` dims, none under
    ``rope_style="none"``."""
    eps, hd = cfg.norm_eps, cfg.resolved_head_dim
    b, s, _ = x.shape
    lin = residuals and not infer
    # the sequence whole before the products: a DTensor carry split along
    # it is all-gathered (Megatron SP's gather; attention reads every row)
    h1 = sharding.unshard(layers.rms_norm_fwd(x, w["norm1/scale"], eps), 1)
    q = h1 @ w["attn/wq"]
    k = h1 @ w["attn/wk"]
    v = h1 @ w["attn/wv"]
    if cfg.qkv_bias:
        q = q + w["attn/q_bias"]
        k = k + w["attn/k_bias"]
        v = v + w["attn/v_bias"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    norms = {}
    if cfg.qk_norm:
        q, qn = layers.head_rms_norm_parts(q, w["attn/q_norm"], eps, lin)
        k, kn = layers.head_rms_norm_parts(k, w["attn/k_norm"], eps, lin)
        norms = {**{f"qn_{n}": t for n, t in qn.items()},
                 **{f"kn_{n}": t for n, t in kn.items()}}
    rope = cfg.rope_style != "none"

    def table(j):
        if not rope:
            return None
        return tables[j] if tables is not None else rope_table(
            cfg, positions, x.dtype)

    tq = table(0)
    qr = layers.rotate_partial(q, *tq) if rope else q
    tk = table(1)
    kr = layers.rotate_partial(k, *tk) if rope else k
    qr, kr, v = attention.constrain_qkv(qr, kr, v)
    if chunked:
        if infer:
            o, lse = attention.chunked_causal_attention(qr, kr, v), None
        else:
            o, lse = attention.chunked_forward(qr, kr, v,
                                               with_lse=residuals)
        att = dict(o=o.reshape(b, s, -1), lse=lse)
    else:
        scores = (attention.grouped_scores(qr, kr) / math.sqrt(hd)).float()
        if tables is not None or infer:
            masked = torch.where(mask, scores, attention.NEG_INF)
            select = (mask, 0.0)
        else:
            masked, *select = estimator.select_parts(mask, scores,
                                                     attention.NEG_INF)
        p, e, ssum = attention.softmax_parts(masked)
        p = p.to(x.dtype)
        # contiguous: a [B, S, H·hd] view of the grouped product's layout
        # folds into the reference's one product with wo only at B = 1
        att = dict(p=p, e=e, ssum=ssum, select=select,
                   o=attention.grouped_values(p, v).reshape(b, s, -1)
                   .contiguous())
    o = att["o"]
    xm = x + o @ w["attn/wo"]
    h2 = sharding.unshard(layers.rms_norm_fwd(xm, w["norm2/scale"], eps), 1)
    if infer:
        return dict(out=_carry(xm + _ffn(cfg, h2, w)))
    r = dict(x=x, h1=h1, **norms, tq=tq, tk=tk, qr=qr, kr=kr, v=v, **att,
             xm=xm, h2=h2)
    if "moe/router" in w:
        mr = moe.moe_forward(h2, param_tree(_group(w, "moe/")), cfg,
                             lin=lin, parts=tables is None, g_off=g_off,
                             full=full)
        out = mr.pop("out", None)
        r.update({f"moe/{name}": t for name, t in mr.items()})
    else:
        r.update(layers.mlp_parts(h2, w["mlp/w_gate"], w["mlp/w_up"]))
        out = r["hm"] @ w["mlp/w_down"] if full else None
    if full:
        r["out"] = _carry(xm + out)
    return r


def _carry(x: torch.Tensor) -> torch.Tensor:
    """A block's output, the residual carry, split along the sequence
    over the model axis (Megatron SP: the remat carry chain is the
    dominant train-time buffer; the reference's layout hint)."""
    return sharding.constrain(x, ("batch", "seq_act", None))


def _head_norm_bwd(ct: torch.Tensor, r: dict, prefix: str,
                   scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The VJP of ``layers.head_rms_norm_parts`` from its residuals
    ``r[prefix + name]``: (the input's cotangent, the scale's), JAX's
    transpose of the norm's ops in its order (the reference has no custom
    VJP here)."""
    a, e, j, l, m = (r[prefix + name] for name in "aejlm")
    hd = a.shape[-1]
    c = ct.float()
    dscale = (m * c).sum((0, 1, 2))
    cn = c * scale.float()
    u = (a * cn).sum(-1, keepdim=True)
    dx = estimator.add_any(cn * j, u * l / hd * e)
    return dx.to(ct.dtype), dscale.to(scale.dtype)


def _rotate_bwd(ct: torch.Tensor, cos, sin) -> torch.Tensor:
    """The VJP of ``layers.rotate``, as the reference's transpose spells
    it."""
    half = cos.shape[-1]
    c1, c2 = ct[..., :half], ct[..., half:2 * half]
    t1 = c2 * sin
    t2 = c2 * cos
    t3 = c1.neg() * sin
    d2 = estimator.add_any(t2, t3)
    t4 = c1 * cos
    d1 = estimator.add_any(t1, t4)
    return torch.cat([d1, d2], -1)


def _rope_bwd(ct: torch.Tensor, table) -> torch.Tensor:
    """The VJP of ``layers.rotate_partial`` (``table`` its (cos, sin);
    None: no rotation): ``_rotate_bwd`` on the rotated dims, the rest
    passed through."""
    if table is None:
        return ct
    rd = 2 * table[0].shape[-1]
    if rd == ct.shape[-1]:
        return _rotate_bwd(ct, *table)
    return torch.cat([_rotate_bwd(ct[..., :rd], *table), ct[..., rd:]], -1)


def _unit_backward(ct: torch.Tensor, r: dict, w: dict,
                   cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One block's VJP from the values ``_unit_forward`` returned: (the
    cotangent of its input, its leaves' gradients). The ops and their
    order are the reference's transpose of the block: the FFN first
    (``layers.mlp_bwd``: the down projection first, the weight's
    cotangent before the input's; or ``moe.moe_block_bwd``), the norm,
    the attention, the cotangent sums unpriced (``estimator.add_any``)."""
    eps = cfg.norm_eps
    b, s, _ = ct.shape
    add = estimator.add_any
    ct = sharding.unshard(ct, 1)          # as ``_unit_forward``'s h1, h2
    # the FFN: out = xm + mlp(h2), or + the MoE's (moe.moe_block_bwd)
    if "moe/router" in w:
        dh2, g = moe.moe_block_bwd(ct, {**_group(r, "moe/"), "x": r["h2"]},
                                   param_tree(_group(w, "moe/")), cfg)
        grads = {f"moe/{name}": t for name, t in g.items()}
    else:
        dh2, g = layers.mlp_bwd(ct, r["h2"], r, w["mlp/w_gate"],
                                w["mlp/w_up"], w["mlp/w_down"])
        grads = {f"mlp/{name}": t for name, t in g.items()}
    dxm, grads["norm2/scale"] = layers.rms_norm_bwd(
        r["xm"], w["norm2/scale"], dh2, eps)
    ct = add(ct, dxm)
    # attention: xm = x + o @ wo
    grads["attn/wo"] = layers.weight_grad(r["o"], ct)
    if "lse" in r:
        dq, dk, dv = _chunked_backward(ct @ w["attn/wo"].t(), r, cfg)
    else:
        dq, dk, dv = _full_backward(ct @ w["attn/wo"].t(), r, cfg)
    dk = _rope_bwd(dk, r["tk"])
    dq = _rope_bwd(dq, r["tq"])
    if cfg.qk_norm:
        dk, grads["attn/k_norm"] = _head_norm_bwd(dk, r, "kn_",
                                                  w["attn/k_norm"])
        dq, grads["attn/q_norm"] = _head_norm_bwd(dq, r, "qn_",
                                                  w["attn/q_norm"])
    # contiguous: each folds into one product with its weight at any B
    dk, dq, dv = (t.reshape(b, s, -1).contiguous() for t in (dk, dq, dv))
    if cfg.qkv_bias:
        for name, t in (("v", dv), ("k", dk), ("q", dq)):
            grads[f"attn/{name}_bias"] = t.sum((0, 1))
    grads["attn/wv"] = layers.weight_grad(r["h1"], dv)
    dx_v = dv @ w["attn/wv"].t()
    grads["attn/wk"] = layers.weight_grad(r["h1"], dk)
    dx_k = dk @ w["attn/wk"].t()
    grads["attn/wq"] = layers.weight_grad(r["h1"], dq)
    dx_q = dq @ w["attn/wq"].t()
    dx, grads["norm1/scale"] = layers.rms_norm_bwd(
        r["x"], w["norm1/scale"], add(add(dx_v, dx_k), dx_q), eps)
    return add(ct, dx), grads


def _chunked_backward(do: torch.Tensor, r: dict, cfg: ArchConfig):
    """The chunked attention's VJP from the output's cotangent ``do`` [B,
    S, H·hd]: (dq [B, S, H, hd], dk, dv [B, S, G, hd]) of the rotated q, k
    and of v (``attention.chunked_backward``, the reference's custom VJP
    inlined in its transpose)."""
    b, s, _ = do.shape
    hd = cfg.resolved_head_dim
    return attention.chunked_backward(
        r["qr"], r["kr"], r["v"], r["o"].reshape(b, s, -1, hd), r["lse"],
        do.reshape(b, s, -1, hd))


def _full_backward(do: torch.Tensor, r: dict, cfg: ArchConfig):
    """The full attention's VJP from the output's cotangent ``do`` [B, S,
    H·hd], as the reference's transpose spells it: (dq [B, S, H, hd], dk,
    dv [B, S, G, hd])."""
    hd = cfg.resolved_head_dim
    g, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    b, s, _ = do.shape
    add = estimator.add_any
    # the views merge (b, g) and (rep, s) of do, (b, g) and (s, rep) of
    # qr, (b, g) of v and kr: g and rep are parts of the heads' dim
    do = sharding.mergeable(do, (0, 2), (2, 1)).reshape(b, s, g, rep, hd)
    v, p = sharding.mergeable(r["v"], (0, 2)), r["p"]
    qr = sharding.mergeable(r["qr"], (0, 2), (1, 2))
    kr = sharding.mergeable(r["kr"], (0, 2))
    ct_p = torch.bmm(
        do.permute(0, 2, 3, 1, 4).reshape(b * g, rep * s, hd),
        v.permute(0, 2, 3, 1).reshape(b * g, hd, s)).view(b, g, rep, s, s)
    ct_vt = torch.bmm(
        do.permute(0, 2, 4, 3, 1).reshape(b * g, hd, rep * s),
        p.reshape(b * g, rep * s, s)).view(b, g, hd, s)
    dv = ct_vt.permute(0, 3, 1, 2)
    # softmax: p = e / sum(e), e = exp(masked - max)
    e, ssum = r["e"], r["ssum"]
    ct_p = ct_p.float()
    t = ct_p * ssum.pow(-2)
    t = t * e
    neg = t.sum(-1, keepdim=True).neg()
    ct_e = add(ct_p / ssum, neg) * e
    mask, zero = r["select"]
    ct_s = torch.where(mask, ct_e, zero).to(do.dtype) / math.sqrt(hd)
    dq = torch.bmm(ct_s.permute(0, 1, 3, 2, 4).reshape(b * g, s * rep, s),
                   kr.permute(0, 2, 1, 3).reshape(b * g, s, hd)
                   ).view(b, g, s, rep, hd)
    dk = torch.bmm(ct_s.permute(0, 1, 4, 3, 2).reshape(b * g, s, s * rep),
                   qr.reshape(b, s, g, rep, hd).permute(0, 2, 1, 3, 4)
                   .reshape(b * g, s * rep, hd)).view(b, g, s, hd)
    return (dq.permute(0, 2, 1, 3, 4).reshape(b, s, g * rep, hd),
            dk.permute(0, 2, 1, 3), dv)


# what the backward keeps of a block's forward without remat: full
# attention, chunked attention; an MoE block's FFN values in place of the
# MLP's, the q/k norms' residuals and the input of a unit's later block
# besides (``_residuals``)
_RESIDUALS = ("h1", "qr", "kr", "v", "p", "e", "ssum", "o", "xm", "h2",
              "gate", "up", "sg", "hm")
_RESIDUALS_CHUNKED = ("h1", "qr", "kr", "v", "o", "lse", "xm", "h2", "gate",
                      "up", "sg", "hm")
_NORM_RESIDUALS = tuple(f"{p}n_{n}" for p in "qk" for n in "aejlm")


def _residuals(cfg: ArchConfig, chunked: bool, i: int) -> tuple[str, ...]:
    """The values of block ``i``'s forward that its VJP reads, by key."""
    keys = _RESIDUALS_CHUNKED if chunked else _RESIDUALS
    if is_moe(cfg, i):
        keys = keys[:keys.index("gate")] + tuple(
            f"moe/{name}" for name in moe.residuals(cfg))
    return (("x",) if i else ()) + keys + (
        _NORM_RESIDUALS if cfg.qk_norm else ())


def _tables(cfg: ArchConfig, rest) -> tuple[list, list]:
    """Split ``_LayerStack``'s inputs after the offsets: each block's
    ((q cos, q sin), (k cos, k sin)), None under ``rope_style="none"``,
    and the rest."""
    n = unit_blocks(cfg)
    tables = [((qc, qs), (kc, ks)) if qc is not None else None
              for qc, qs, kc, ks in zip(*[iter(rest[:4 * n])] * 4)]
    return tables, list(rest[4 * n:])


class _LayerStack(torch.autograd.Function):
    """The layer stack, ``x`` through every unit of ``unit_blocks`` blocks
    (module docstring). Inputs: the config, x, positions, the causal mask
    (None: the attention is chunked), an MoE block's hoisted group
    offsets (``moe.group_offsets``; None without experts), each block's
    (q, k) rope tables (cos, sin each; ``_tables``) and the stacked leaves
    (``stack_leaves(cfg)``). Outputs: x and what the backward reads (the
    units' inputs after the first; without remat also each block's
    residuals, ``_residuals``), the latter not differentiable. Under
    ``rope_style="none"`` the tables are None."""

    @staticmethod
    def forward(cfg, x, positions, mask, g_off, *rest):
        tables, leaves = _tables(cfg, rest)
        chunked = mask is None
        names = stack_leaves(cfg)
        saved = []
        for u in range(n_units(cfg)):
            if u:
                saved.append(x)
            with estimator.region("scan", "layers"):
                w = _layer(names, leaves, u)
                for i in range(unit_blocks(cfg)):
                    r = _unit_forward(x, _block(w, i), cfg, positions, mask,
                                      tables[i], chunked=chunked,
                                      residuals=not cfg.remat, g_off=g_off)
                    if not cfg.remat:
                        saved.extend(r[key] for key in
                                     _residuals(cfg, chunked, i))
                    x = r["out"]
        return (x, *saved)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cfg = inputs[0]
        ctx.mark_non_differentiable(*output[1:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs[1:], *output[1:])

    @staticmethod
    def backward(ctx, ct, *_):
        cfg = ctx.cfg
        x, positions, mask, _, *rest = ctx.saved_tensors
        tables, rest = _tables(cfg, rest)
        names = stack_leaves(cfg)
        leaves, saved = rest[:len(names)], rest[len(names):]
        chunked = mask is None
        n, units = unit_blocks(cfg), n_units(cfg)
        keys = [_residuals(cfg, chunked, i) for i in range(n)]
        per = 0 if cfg.remat else sum(map(len, keys))
        grads = [[None] * units for _ in leaves]
        # no_grad: the VJP is written out and never differentiated, and
        # its unpriced ops (estimator.add_any, silu_vjp, select_parts,
        # take_parts, scatter_add) have no VJP for torch.func to record
        with torch.no_grad():
            for u in reversed(range(units)):
                # unit u's part of the saved list: its input (after the
                # first unit), then each block's residuals
                at = u * per + u
                xu = saved[at - 1] if u else x
                with estimator.region("scan", "layers.T"):
                    w = _layer(names, leaves, u)
                    rs = []
                    for i in range(n):
                        if cfg.remat:
                            # the unit recomputed from its input; the last
                            # block up to where its VJP stops reading
                            r = _unit_forward(xu, _block(w, i), cfg,
                                              positions, mask,
                                              full=i < n - 1,
                                              chunked=chunked)
                            xu = r.get("out")
                        else:
                            tq, tk = tables[i] or (None, None)
                            r = dict(zip(keys[i], saved[at:at + len(keys[i])]),
                                     tq=tq, tk=tk, select=(mask, 0.0))
                            r.setdefault("x", xu)
                            at += len(keys[i])
                        rs.append(r)
                    g = {}
                    for i in reversed(range(n)):
                        ct, gi = _unit_backward(ct, rs[i], _block(w, i), cfg)
                        g.update({f"block{i}/{k}": t for k, t in gi.items()})
                for j, key in enumerate(names):
                    grads[j][u] = g[key]
            grads = [torch.stack(gl) for gl in grads]
        return (None, ct, None, None, None, *[None] * len(tables) * 4,
                *grads)


def _differentiated(*xs: torch.Tensor) -> bool:
    """Whether autograd (or a ``torch.func`` transform) records a VJP of
    ``xs``: the differentiated stack spells the reference's linearized
    forward and its transpose, the other its plain forward."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _forward_stack(cfg: ArchConfig, x, positions, mask,
                   leaves) -> torch.Tensor:
    """The layer stack of a step that takes no gradient (prefill): each
    unit one iteration of the ``"scan"`` region ``"layers"``, each block
    making its rope tables itself and the chunked attention (``mask``
    None) a call of its own, as the reference's undifferentiated scan
    body does."""
    keys = stack_leaves(cfg)
    for u in range(n_units(cfg)):
        with estimator.region("scan", "layers"):
            w = _layer(keys, leaves, u)
            for i in range(unit_blocks(cfg)):
                x = _unit_forward(x, _block(w, i), cfg, positions, mask,
                                  chunked=mask is None, infer=True)["out"]
    return x


def rope_table(cfg: ArchConfig, positions: torch.Tensor, dtype):
    """The (cos, sin) of ``cfg``'s rotation at ``positions`` ([B, S], or
    the [3, B, S] grid under ``"mrope"``); None under ``"none"``."""
    return layers.rope_table_for(cfg.resolved_head_dim, positions, dtype,
                                 theta=cfg.rope_theta, style=cfg.rope_style,
                                 sections=cfg.mrope_sections)


def hidden_states(cfg: ArchConfig, params: dict,
                  tokens: torch.Tensor | None = None,
                  embeds: torch.Tensor | None = None,
                  positions: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's ``DecoderLM.hidden_states``: tokens [B, S] int, or
    ``embeds`` [B, S, D] (a modality frontend's output, cast to the model
    dtype) -> the final norm's output [B, S, D], on the reference's
    parameter tree. ``positions`` default to the arange, broadcast to the
    [3, B, S] grid under ``"mrope"``. Above ``CHUNKED_ATTN_THRESHOLD``
    tokens the attention is the chunked flash path (the sequence a
    multiple of ``attention.Q_CHUNK``). Differentiated, the stack is
    ``_LayerStack`` (the rope tables made from the positions once, outside
    it); otherwise ``_forward_stack``. The recurrent patterns' stack is
    ``_RecurrentStack`` differentiated, ``_forward_recurrent``
    otherwise."""
    if embeds is None:
        x = layers.embed(tokens, params["embed"]["table"])
    else:
        x = embeds.to(torch_dtype(cfg.dtype))
    b, s, _ = x.shape
    chunked = s > CHUNKED_ATTN_THRESHOLD
    x = sharding.constrain(x, ("batch", "seq", None))
    if positions is None:
        pos = attention.site_positions(cfg, torch.arange(
            s, dtype=torch.int32, device=x.device)[None].expand(b, s))
    else:
        pos = positions
    if cfg.block_pattern in RECURRENT:
        leaves = [leaf_at(params, k) for k in recurrent_leaves(cfg)]
        if _differentiated(x, *leaves):
            mask = (attention.causal_mask(s, x.device)
                    if cfg.block_pattern == "mamba_shared_attn"
                    and not chunked else None)
            x = _RecurrentStack.apply(cfg, _Holder(), x, pos, mask, *leaves)
        else:
            x = _forward_recurrent(cfg, params, x, pos, chunked)
        return layers.rms_norm(x, params["final_norm"]["scale"],
                               cfg.norm_eps)
    leaves = _stacked(params["layers"], stack_leaves(cfg))
    differentiated = _differentiated(x, *leaves)
    g_off = None
    if differentiated:
        # each block's (q, k) tables, then the slot map's group offsets
        tables = [None] * (4 * unit_blocks(cfg))
        if cfg.rope_style != "none":
            tables = [t for _ in range(2 * unit_blocks(cfg))
                      for t in rope_table(cfg, pos, x.dtype)]
        if cfg.n_experts:
            g_off = moe.group_offsets(cfg, b * s, x.device)
    mask = None if chunked else attention.causal_mask(s, x.device)
    if differentiated:
        x = _LayerStack.apply(cfg, x, pos, mask, g_off, *tables,
                              *leaves)[0]
    else:
        x = _forward_stack(cfg, x, pos, mask, leaves)
    return layers.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)


def apply(cfg: ArchConfig, params: dict,
          tokens: torch.Tensor | None = None,
          embeds: torch.Tensor | None = None,
          positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence logits [B, S, V]: ``hidden_states`` then the LM head
    (``logits_of``)."""
    return logits_of(cfg, params,
                     hidden_states(cfg, params, tokens, embeds, positions))


class Block(nn.Module):
    """Pre-norm attention + SwiGLU MLP, or + the MoE FFN (``moe``)."""

    def __init__(self, cfg: ArchConfig, dtype, device, moe_ffn: bool = False):
        super().__init__()
        self.norm1 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.attn = attention.init_attention(cfg, dtype, device)
        self.norm2 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        if moe_ffn:
            self.moe = moe.MoE(cfg, dtype, device)
        else:
            self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        return self.moe(h) if hasattr(self, "moe") else self.mlp(h)


class SharedBlock(nn.Module):
    """zamba2's weight-tied attention + MLP block, one set of weights read
    at every group's site (the reference's ``shared_attn``,
    ``shared_mlp``, ``shared_norm1`` / ``shared_norm2``)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.attn = attention.init_attention(cfg, dtype, device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)
        self.norm1 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.norm2 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)


def _recurrent_layers(cfg: ArchConfig, dtype, device) -> list[nn.Module]:
    """The recurrent patterns' layer modules in layer order: xlstm's
    alternating mLSTM and sLSTM blocks, zamba2's Mamba2 blocks."""
    d, h, eps = cfg.d_model, cfg.n_heads, cfg.norm_eps
    if cfg.block_pattern == "xlstm":
        return [(ssm.mlstm_block if j % 2 == 0 else ssm.slstm_block)(
            d, h, eps, dtype, device) for j in range(cfg.n_layers)]
    return [ssm.mamba2_block(d, cfg.ssm_state, cfg.mamba_headdim,
                             cfg.mamba_conv_width, eps, dtype, device)
            for _ in range(cfg.n_layers)]


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, *,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        dt, dev = self.dtype, self.device
        n_units(cfg)                    # whole units of a known pattern
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dt, dev)
        if cfg.block_pattern == "attn":
            n = unit_blocks(cfg)
            # layer u·n + i is block i of unit u
            self.layers = nn.ModuleList(
                Block(cfg, dt, dev, is_moe(cfg, j % n))
                for j in range(cfg.n_layers))
        else:
            self.layers = nn.ModuleList(_recurrent_layers(cfg, dt, dev))
        if cfg.block_pattern == "mamba_shared_attn":
            self.shared = SharedBlock(cfg, dt, dev)
        self.final_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dt, dev)
        # tied: the head reads the embedding table (``logits_of``)
        self.lm_head = (None if cfg.tie_embeddings else
                        layers.LMHead(cfg.d_model, cfg.vocab_size, dt, dev))

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
        flat = {}
        for key, (dims, shape, owners) in leaf_layout(self.cfg).items():
            ps = [self.get_parameter(o) for o in owners]
            flat[key] = (ps[0] if not dims else
                         torch.stack(ps).reshape(*dims, *shape))
        return param_tree(flat)

    @torch.no_grad()
    def shared_stacked_params(self) -> dict:
        """The reference's tree of this module's parameters, built once
        and shared with the module: each layer's parameters become views
        of the tree's stacked leaves (values unchanged), so the two never
        hold the weights twice and later calls return the same tree. What
        a mapped step runs on for the engine's lifetime
        (``serve.ServeEngine(backend="pim")``); ``stacked_params`` copies
        on every call."""
        tree = getattr(self, "_shared_tree", None)
        if tree is not None:
            return tree
        tree = self.stacked_params()
        for key, (dims, shape, owners) in leaf_layout(self.cfg).items():
            if not dims:
                continue
            rows = leaf_at(tree, key).reshape(-1, *shape)
            for i, path in enumerate(owners):
                owner, pname = path.rsplit(".", 1)
                setattr(self.get_submodule(owner), pname,
                        nn.Parameter(rows[i], requires_grad=False))
        self._shared_tree = tree
        return tree

    def init_cache(self, batch: int, max_len: int) -> dict:
        """The contiguous cache ``decode_step`` takes: ``{"layers":
        {"block<i>": {"k", "v"}}}``, each ``[n_units, batch, max_len,
        n_kv, head_dim]`` of zeros in the model dtype. xlstm: each unit's
        mLSTM state ``{C, m, n}`` and sLSTM state ``{c, h, m, n}``
        (``models.ssm``), float32, ``m`` at -1e30; zamba2: each group's
        Mamba2 states ``{conv, ssm}`` ``[n_units, every, …]`` and its
        shared site's KV, then the tail's states (``"tail"``)."""
        cfg = self.cfg
        dev = self.device
        site = attention.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                       cfg.resolved_head_dim, self.dtype,
                                       dev)

        def stack(tree: dict, *dims: int) -> dict:
            return {name: (stack(t, *dims) if isinstance(t, dict) else
                           t.expand(*dims, *t.shape).clone())
                    for name, t in tree.items()}

        units = n_units(cfg)
        if cfg.block_pattern == "xlstm":
            dk = cfg.d_model // cfg.n_heads
            return {"layers": stack({
                "mlstm": ssm.mlstm_state(batch, cfg.n_heads, dk, dk, dev),
                "slstm": ssm.slstm_state(batch, cfg.d_model, cfg.n_heads,
                                         dev)}, units)}
        if cfg.block_pattern == "mamba_shared_attn":
            d_in = 2 * cfg.d_model
            state = ssm.mamba2_state(
                batch, d_in // cfg.mamba_headdim, cfg.mamba_headdim,
                cfg.ssm_state, cfg.mamba_conv_width, d_in, dev)
            cache = {"layers": {
                "mamba": stack(state, units, cfg.shared_attn_every),
                "shared_kv": stack(site, units)}}
            if tail_units(cfg):
                cache["tail"] = stack(state, tail_units(cfg))
            return cache
        return {"layers": {f"block{i}": stack(site, units)
                           for i in range(unit_blocks(cfg))}}

    def hidden_states(self, params: dict, tokens=None, embeds=None,
                      positions=None) -> torch.Tensor:
        """Module-level ``hidden_states`` with this model's config."""
        return hidden_states(self.cfg, params, tokens, embeds, positions)

    def apply(self, params: dict, tokens=None, embeds=None,
              positions=None) -> torch.Tensor:
        """Module-level ``apply`` with this model's config: the logits of
        the reference's ``DecoderLM.apply``, a function of the tree (it
        takes the place of ``nn.Module.apply``, which no code of the
        port calls)."""
        return apply(self.cfg, params, tokens, embeds, positions)

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
        (``attention.init_paged_kv_cache``). Only the ``attn`` pattern
        pages: the recurrent ones hold O(1) state a slot, not KV."""
        cfg = self.cfg
        if cfg.block_pattern != "attn":
            raise NotImplementedError(
                f"paged KV cache requires block_pattern='attn'; "
                f"{cfg.block_pattern!r} holds recurrent state, not KV")
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
        _not_paged(cfg, "paged decode")
        x = self.embed(token[:, None])
        for i, blk in enumerate(self.layers):
            x = x + attention.paged_decode_attention(
                blk.norm1(x), blk.attn, cfg, block_table=block_table,
                pos=pos, use_kernel=kernel, kv_dtype=kv_dtype,
                **self._site(cache, i))
            x = x + blk.ffn(blk.norm2(x))
        x = self.final_norm(x)
        logits = (x @ self.embed.table.t() if self.lm_head is None
                  else self.lm_head(x))
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
        _not_paged(cfg, "paged prefill")
        x = self.embed(tokens[None])                          # [1, T, D]
        for i, blk in enumerate(self.layers):
            x = x + attention.paged_prefill_attention(
                blk.norm1(x), blk.attn, cfg, table_row=table_row, p0=p0,
                n_new=n_new, kv_dtype=kv_dtype, **self._site(cache, i))
            x = x + blk.ffn(blk.norm2(x))
        return cache
