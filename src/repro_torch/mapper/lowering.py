"""The one lowering-rule table: placed aten-graph nodes -> PIM kernel
calls. The port of ``repro.mapper.lowering``.

Both execution modes of a :class:`~repro_torch.mapper.schedule.Schedule`
share this module, so the matmul/conv/eltwise lowering logic exists
exactly once:

  * the **interpreter** (``repro_torch.mapper.executor``) runs with
    ``grouped=False``: one ``pim_matmul`` (K2) launch **per placed
    block**, the verification mode and the bit-level oracle;
  * the **compiler** (``repro_torch.mapper.compile``) runs with
    ``grouped=True``: each placed node's whole block grid is stacked into
    **one** ``pim_matmul_grouped`` (K1) launch — the paper's subarrays
    computing all placed blocks in parallel.

Grouped execution is constructed to be *bit-identical* to the per-block
oracle: every group runs the same kernel body over the same padded block
a standalone ``pim_matmul`` would (K2 is K1 with one group), extra
zero-padding contributes exact zeros, and the cross-row-block reduction is
an explicit ascending left-fold — the same association order as the
oracle's chain of block adds. Every operand is zero-padded to multiples
of ``TILE``, the kernels' tile edge.

Grouped, the walk also coalesces *independent* placed nodes: same-shape
placed matmuls whose operands are all already computed ride one grouped
launch, and whole waves of ready
eltwise add/sub/mul nodes ride one ``pim_mac_grouped`` (K3) launch.
Fusion only ever *reorders* nodes whose inputs were already available, so
values are unchanged.

The reference walks its jaxpr afresh on every trace; the port plans the
walk once (:func:`plan`, when the context is made): which aten node runs
natively, which through a rule, and which nodes ride a fused launch —
everything that does not depend on argument values. :func:`eval_placed`
then replays the plan on concrete tensors. A lowered output takes the
strides its aten node had when traced, so every native view op after it
replays as traced.

``placed_blocks`` counts block-level work, ``kernel_launches`` counts
actual kernel launches — under the per-block oracle they are equal (plus
eltwise); under grouped execution launches collapse to about one per
placed node.

Rules decline — and the node runs its own aten op, numerically exact,
just not routed through the PIM kernels — for: batched matmuls (``bmm``),
non-float matmuls, convolutions with a bias, groups, dilation,
transposition or other than 2-D, ``div`` (a*(1/b) would diverge from
division at the overflow edge), eltwise ops that are not float32 or whose
``alpha`` is not 1. Weight grids other than fp32 (K5) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import estimator
from repro_torch.kernels.pim_mac import (pim_mac, pim_mac_grouped, pim_matmul,
                                         pim_matmul_grouped)
from repro_torch.mapper.graph import OpNode

aten = torch.ops.aten


TILE = 128          # tile edge the placed blocks are padded to


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad a 2-D operand to multiples of ``mult`` in both dims."""
    rows, cols = _round_up(x.shape[0], mult), _round_up(x.shape[1], mult)
    if (rows, cols) == tuple(x.shape):
        return x.contiguous()
    out = x.new_zeros((rows, cols))
    out[:x.shape[0], :x.shape[1]] = x
    return out


@dataclasses.dataclass(frozen=True)
class Step:
    """One planned step of the walk over the aten graph.

    ``kind``: ``"input"`` (argument ``index``), ``"native"`` (the node's
    own aten op), ``"placed"`` (a rule; with ``peers``, the nodes that
    ride its fused launch) or ``"output"``."""

    kind: str
    fx: torch.fx.Node
    node: OpNode | None = None
    peers: tuple = ()             # ((fx, node), ...) fused into this launch
    index: int = 0


@dataclasses.dataclass
class LoweringContext:
    """Schedule + execution mode + launch counters, threaded through the
    rules.

    ``grouped=False`` is the per-block oracle (one launch per placed
    block, the interpreter's mode); ``grouped=True`` stacks each node's
    blocks into one grouped launch and coalesces independent same-shape
    placed nodes (the compiler's mode).

    Counters: ``placed_blocks`` / ``eltwise_calls`` count kernel-routed
    *work* (block matmuls resp. eltwise nodes); ``matmul_launches`` /
    ``eltwise_launches`` count actual kernel launches per kind, with
    ``kernel_launches`` their sum.
    """

    schedule: Any                 # repro_torch.mapper.schedule.Schedule
    grouped: bool = True          # grouped + fused (False = per-block)
    placed_blocks: int = 0
    eltwise_calls: int = 0
    matmul_launches: int = 0
    eltwise_launches: int = 0

    def __post_init__(self):
        self.node_by_fx = {nd.fx_node: nd
                           for nd in self.schedule.graph.nodes}
        self.steps = plan(self)

    @property
    def kernel_launches(self) -> int:
        """All kernel launches (matmul + eltwise)."""
        return self.matmul_launches + self.eltwise_launches

    def reset_counters(self) -> None:
        self.placed_blocks = self.eltwise_calls = 0
        self.matmul_launches = self.eltwise_launches = 0


# ---------------------------------------------------------------------------
# placed matmul (shared by the mm and conv rules)
# ---------------------------------------------------------------------------


def _grouped_operands(ctx: LoweringContext, node_idx: int, a2, b2):
    """Pad once and stack a node's placed block operands.

    The node's stationary weight is a (row_blocks x col_blocks) grid of
    subarray-sized blocks; this builds the stacked grouped operands
    ``a_g (R, mp, Kb)`` (one activation slab per *row* chunk — the kernel
    fans each slab out to its C column groups, so activations are never
    replicated) and ``b_g (R*C, Kb, Nb)`` (replica 0 — replicas are
    throughput copies holding identical weights), padded to ``TILE``
    multiples exactly as the per-block path pads each block. Returns
    ``(a_g, b_g, meta)``; ``meta`` feeds :func:`_grouped_reduce`.
    """
    np_ = ctx.schedule.placement.node_placements[node_idx]
    sub = ctx.schedule.hierarchy.subarray
    br, bc = sub.weight_rows, sub.weight_cols
    R, C = np_.row_blocks, np_.col_blocks
    m, k = a2.shape
    n = b2.shape[1]
    h = br if R > 1 else k            # per-row-chunk height (values)
    w = bc if C > 1 else n            # per-col-chunk width (values)
    mp, kb, nb = _round_up(m, TILE), _round_up(h, TILE), _round_up(w, TILE)
    a2 = a2.to(torch.float32)
    b2 = b2.to(torch.float32)
    a_g = a2.new_zeros((R, mp, kb))
    b_g = b2.new_zeros((R * C, kb, nb))
    for r in range(R):
        rows = slice(r * h, (r + 1) * h)
        chunk = a2[:, rows]
        a_g[r, :m, :chunk.shape[1]] = chunk
        for c in range(C):
            wb = b2[rows, c * w:(c + 1) * w]
            b_g[r * C + c, :wb.shape[0], :wb.shape[1]] = wb
    return a_g, b_g, (R, C, m, n, w)


def _grouped_reduce(out_g: torch.Tensor, meta) -> torch.Tensor:
    """(G, mp, Nb) grouped partial products -> (m, n): one segment-sum
    over the row-block axis per output column-block, then stitch the
    column blocks. The fold is explicit and ascending so the result is
    bit-identical to the oracle's per-block add chain."""
    R, C, m, n, w = meta
    out4 = out_g.reshape(R, C, out_g.shape[1], out_g.shape[2])
    col = out4[0]
    for i in range(1, R):
        col = col + out4[i]
    col = col[:, :m, :w]                                   # (C, m, w)
    return col.transpose(0, 1).reshape(m, C * w)[:, :n]


def _launch_grouped(ctx: LoweringContext, a_g, b_g,
                    col_groups: int) -> torch.Tensor:
    """One grouped launch over stacked block operands."""
    out_g = pim_matmul_grouped(a_g, b_g, bm=TILE, bn=TILE, bk=TILE,
                               col_groups=col_groups)
    ctx.placed_blocks += b_g.shape[0]
    ctx.matmul_launches += 1
    return out_g


def blocked_matmul(ctx: LoweringContext, node_idx: int, a2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """A (m,k) @ B (k,n) through the node's placed block grid — replica 0;
    replicas are throughput copies holding identical weights.

    ``ctx.grouped``: one ``pim_matmul_grouped`` launch over the stacked
    blocks + a single segment-sum per output column-block. Otherwise the
    per-block oracle — one ``pim_matmul`` launch
    per placed block, partial products added into the output in block
    order.
    """
    if ctx.grouped:
        a_g, b_g, meta = _grouped_operands(ctx, node_idx, a2, b2)
        out_g = _launch_grouped(ctx, a_g, b_g, meta[1])
        return _grouped_reduce(out_g, meta)

    np_ = ctx.schedule.placement.node_placements[node_idx]
    m, n = a2.shape[0], b2.shape[1]
    out = torch.zeros((m, n), dtype=torch.float32, device=a2.device)
    for blk in np_.iter_blocks(ctx.schedule.hierarchy, replica=0):
        rows = slice(blk.row0, blk.row0 + blk.n_rows)
        cols = slice(blk.col0, blk.col0 + blk.n_cols)
        pa = _pad_to(a2[:, rows].to(torch.float32), TILE)
        pb = _pad_to(b2[rows, cols].to(torch.float32), TILE)
        part = pim_matmul(pa, pb, bm=TILE, bn=TILE, bk=TILE)
        out[:, cols] += part[:m, :blk.n_cols]
        ctx.placed_blocks += 1
        ctx.matmul_launches += 1
    return out


# ---------------------------------------------------------------------------
# per-kind rules: ``ok`` decides from the traced graph alone whether a node
# lowers (the plan), the rule computes it
# ---------------------------------------------------------------------------


def _traced(fx: torch.fx.Node):
    return fx.meta["val"]


def _conform(out: torch.Tensor, fx: torch.fx.Node) -> torch.Tensor:
    """``out`` in the dtype and with the strides ``fx`` had when traced."""
    val = _traced(fx)
    out = out.to(val.dtype)
    if out.stride() == val.stride():
        return out
    like = torch.empty_strided(tuple(val.shape), val.stride(),
                               dtype=val.dtype, device=out.device)
    return like.copy_(out)


def _dot_ok(fx: torch.fx.Node) -> bool:
    # batched matmuls decline, as the reference's batched dot_generals do
    return (fx.target is aten.mm.default
            and _traced(fx).dtype.is_floating_point)


def lower_dot(ctx: LoweringContext, fx, node, args, kwargs):
    out = blocked_matmul(ctx, node.idx, args[0], args[1])
    return _conform(out, fx)


def _conv_ok(fx: torch.fx.Node) -> bool:
    if len(fx.args) != 9 or fx.kwargs:
        return False
    _, w, bias, stride, padding, dilation, transposed, _, groups = fx.args
    return (_traced(fx).dtype.is_floating_point and bias is None
            and not transposed and groups == 1
            and len(_traced(w).shape) == 4 and len(stride) == 2
            and all(d == 1 for d in dilation)
            and all(p >= 0 for p in padding))


def lower_conv(ctx: LoweringContext, fx, node, args, kwargs):
    """im2col + the placed blocked matmul. Patches are laid out
    ``(kh, kw, cin)`` and the weight is read through its OIHW view as
    ``(kh, kw, cin) x cout`` — the reference's ``HWIO.reshape(-1, cout)``
    — so a placed block's rows hold the same weights as the reference's."""
    x, w, _, (sh, sw), (ph, pw) = args[:5]
    cout, cin, kh, kw = w.shape
    xh = x.permute(0, 2, 3, 1)                             # NHWC view
    if ph or pw:
        xh = F.pad(xh, (0, 0, pw, pw, ph, ph))
    n, hh, ww, _ = xh.shape
    oh = (hh - kh) // sh + 1
    ow = (ww - kw) // sw + 1
    cols = [xh[:, i:i + oh * sh:sh, j:j + ow * sw:sw, :]
            for i in range(kh) for j in range(kw)]
    a2 = torch.cat(cols, dim=-1).reshape(n * oh * ow, kh * kw * cin)
    b2 = w.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    out = blocked_matmul(ctx, node.idx, a2, b2)
    return _conform(out.reshape(n, oh, ow, cout).permute(0, 3, 1, 2), fx)


def _eltwise_ok(fx: torch.fx.Node, node: OpNode) -> bool:
    val = _traced(fx)
    return (len(fx.args) == 2 and fx.kwargs.get("alpha", 1) == 1
            and set(fx.kwargs) <= {"alpha"} and val.dtype == torch.float32
            and val.numel() > 0 and node.op in ("add", "sub", "mul"))


def _eltwise_operands(fx, node, args):
    """``(a, b, acc)`` with out = acc + a*b, broadcasts resolved and laid
    out contiguously (the kernel's operands)."""
    val = _traced(fx)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))

    def full(x):
        x = torch.as_tensor(x, dtype=val.dtype, device=dev)
        return torch.broadcast_to(x, val.shape).contiguous()

    a, b = full(args[0]), full(args[1])
    one = torch.ones_like(a)
    if node.op == "add":       # b + a*1
        return a, one, b
    if node.op == "sub":       # a + b*(-1)
        return b, -one, a
    return a, b, torch.zeros_like(a)      # mul: 0 + a*b


def lower_eltwise(ctx: LoweringContext, fx, node, args, kwargs):
    out = pim_mac(*_eltwise_operands(fx, node, args))
    ctx.eltwise_calls += 1
    ctx.eltwise_launches += 1
    return _conform(out, fx)


# keyed by the estimator registry's node kinds — one rule per kind
RULES: dict[str, Callable] = {
    "matmul": lower_dot,
    "conv": lower_conv,
    "eltwise": lower_eltwise,
}

_OK: dict[str, Callable] = {
    "matmul": lambda fx, node: _dot_ok(fx),
    "conv": lambda fx, node: _conv_ok(fx),
    "eltwise": _eltwise_ok,
}

assert set(RULES) == set(_OK) == set(estimator.NODE_KINDS.values()), (
    "lowering rules out of sync with estimator.NODE_KINDS")


# ---------------------------------------------------------------------------
# cross-node fusion (grouped mode): coalesce independent placed nodes
# whose operands are all already computed into one launch
# ---------------------------------------------------------------------------


def _dot_key(ctx: LoweringContext, fx, node):
    """Shape/dtype/block-grid signature deciding matmul fusability."""
    np_ = ctx.schedule.placement.node_placements[node.idx]
    return (tuple(_traced(fx.args[0]).shape), tuple(_traced(fx.args[1]).shape),
            _traced(fx).dtype, np_.row_blocks, np_.col_blocks)


def _fuse_matmuls(ctx: LoweringContext, group, read) -> list:
    """One grouped launch for same-shape placed matmuls (the lead and its
    planned peers); returns each member's output."""
    stacked = [_grouped_operands(ctx, nd.idx, read(fx.args[0]),
                                 read(fx.args[1])) for fx, nd in group]
    g_per = stacked[0][1].shape[0]
    cols = stacked[0][2][1]          # shared C (same block grid by key)
    out_all = _launch_grouped(ctx, torch.cat([s[0] for s in stacked]),
                              torch.cat([s[1] for s in stacked]), cols)
    return [_conform(_grouped_reduce(out_all[i * g_per:(i + 1) * g_per],
                                     meta), fx)
            for i, ((fx, _), (_, _, meta)) in enumerate(zip(group, stacked))]


def _fuse_eltwise(ctx: LoweringContext, group, read) -> list:
    """One ragged ``pim_mac_grouped`` launch for a ready eltwise wave."""
    outs = pim_mac_grouped([
        _eltwise_operands(fx, nd, [read(a) for a in fx.args])
        for fx, nd in group])
    ctx.eltwise_calls += len(group)
    ctx.eltwise_launches += 1
    return [_conform(out, fx) for (fx, _), out in zip(group, outs)]


_FUSERS = {"matmul": _fuse_matmuls, "eltwise": _fuse_eltwise}


# ---------------------------------------------------------------------------
# the plan and the evaluator (interpreter == compiler, one walk)
# ---------------------------------------------------------------------------


def _inputs_of(fx: torch.fx.Node) -> list[torch.fx.Node]:
    ins: list[torch.fx.Node] = []
    torch.fx.node.map_arg((fx.args, fx.kwargs), ins.append)
    return ins


def plan(ctx: LoweringContext) -> list[Step]:
    """The walk over the schedule's aten graph, decided once.

    Grouped, a lowerable placed node leads a fused launch of
    every *later* placed node of its kind that is ready (all inputs
    computed by then) and matches it (matmul: same operand shapes and
    block grid; eltwise: add/sub/mul of the same dtype); those nodes are
    computed early, at the lead's step, and skip their own slot."""
    gm = ctx.schedule.graph.gm
    fx_nodes = list(gm.graph.nodes)
    lowered = {}
    for fx in fx_nodes:
        node = ctx.node_by_fx.get(fx.name) if fx.op == "call_function" \
            else None
        if node is not None and _OK[node.kind](fx, node):
            lowered[fx] = node
    cands: dict[str, list] = {}
    if ctx.grouped:
        cands = {"matmul": [], "eltwise": []}
        for fx, node in lowered.items():
            if node.kind in cands:
                cands[node.kind].append(fx)

    steps: list[Step] = []
    done: set[torch.fx.Node] = set()
    n_inputs = 0
    for fx in fx_nodes:
        if fx in done:
            continue
        if fx.op == "placeholder":
            steps.append(Step("input", fx, index=n_inputs))
            n_inputs += 1
        elif fx.op == "get_attr":
            raise NotImplementedError(
                f"graph constant {fx.target}: the mapper replays functions "
                f"of their arguments only")
        elif fx.op == "output":
            steps.append(Step("output", fx))
        elif fx not in lowered:
            steps.append(Step("native", fx))
        else:
            node = lowered[fx]
            peers = []
            if node.kind in cands:
                key = (_dot_key(ctx, fx, node) if node.kind == "matmul"
                       else _traced(fx).dtype)
                lst = cands[node.kind]
                for fx2 in lst[lst.index(fx) + 1:]:
                    nd2 = lowered[fx2]
                    if (fx2 in done or not all(
                            v in done for v in _inputs_of(fx2))):
                        continue
                    key2 = (_dot_key(ctx, fx2, nd2)
                            if node.kind == "matmul"
                            else _traced(fx2).dtype)
                    if key2 == key:
                        peers.append((fx2, nd2))
                # members are computed by this launch, not before it: a
                # node reading one of them is not ready for it
                done.update(fx2 for fx2, _ in peers)
            steps.append(Step("placed", fx, node, tuple(peers)))
        done.add(fx)
    return steps


def _run_placed(ctx: LoweringContext, step: Step, read) -> list:
    """One placed step: ``[(fx, value), ...]`` for the lead and its peers."""
    if step.peers:
        group = [(step.fx, step.node), *step.peers]
        return list(zip((fx for fx, _ in group),
                        _FUSERS[step.node.kind](ctx, group, read)))
    fx = step.fx
    args = torch.fx.node.map_arg(fx.args, read)
    kwargs = torch.fx.node.map_arg(fx.kwargs, read)
    return [(fx, RULES[step.node.kind](ctx, fx, step.node, args, kwargs))]


def eval_placed(ctx: LoweringContext, flat_args) -> list:
    """Replay the plan on the flat argument leaves; returns the flat
    output leaves. Placed nodes run through the rules (their kernels),
    everything else its own aten op on the arguments' device."""
    env: dict[torch.fx.Node, Any] = {}
    read = env.__getitem__
    device = flat_args[0].device if flat_args else None
    tr = obs.tracer()
    for step in ctx.steps:
        fx = step.fx
        if step.kind == "input":
            env[fx] = flat_args[step.index]
        elif step.kind == "native":
            env[fx] = fx.target(*torch.fx.node.map_arg(fx.args, read),
                                **torch.fx.node.map_arg(fx.kwargs, read))
        elif step.kind == "placed":
            if tr.enabled:
                # record the launch as an execute-lane span, synced so dur
                # covers the device work
                n0 = ctx.kernel_launches
                with tr.span(f"{step.node.kind}:{step.node.name}",
                             lane="execute", node=step.node.idx,
                             kind=step.node.kind):
                    outs = _run_placed(ctx, step, read)
                    if device is not None and device.type == "cuda":
                        torch.cuda.synchronize(device)
                obs.metrics().counter("pim.kernel_launches").inc(
                    ctx.kernel_launches - n0)
            else:
                outs = _run_placed(ctx, step, read)
            env.update(outs)
        else:
            return [read(v) for v in fx.args[0]]
    raise AssertionError("the plan has no output step")
