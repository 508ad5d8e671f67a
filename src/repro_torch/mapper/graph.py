"""Lower an aten ``torch.fx`` graph into the mapper's operator graph: the
port of ``repro.mapper.graph``.

Reuses ``repro_torch.core.estimator.iter_nodes`` — the same traversal that
prices op counts — so the graph's op totals reconcile with
``pim_estimate`` by construction: every costed op becomes exactly one node
carrying the same MAC/add/mul count the estimator would have charged.

Node kinds:
  * ``MatmulNode``  — ``mm`` / ``bmm``; the rhs operand is treated as the
    stationary weight (x @ W convention). Backward-pass matmuls get their
    own stationary operand, as in the reference; autograd's weight
    cotangent ``mm(t(x), g)`` is placed as the reference's ``gᵀx`` with
    ``x`` stationary (``transposed``; ``estimator.mm_transposed``).
  * ``ConvNode``    — ``convolution``; stationary weight is the
    (fan_in, cout) filter matrix (spatially replicated units share it).
    Its ``out_shape`` is channels-last, ``(N, *spatial, C_out)``: the
    layout of the models' public NHWC interface and of the reference's
    node, where the aten op itself returns channels-first. A
    ``convolution_backward`` node is the convolution of one cotangent
    (``half``): the input's, channels-last, or the weight's, in the
    public HWIO layout ``(*kernel spatial, C_in, C_out)``.
  * ``EltwiseNode`` — add/sub/mul/div, priced per element; executed in the
    shared peripheral FP units, so no weight placement.

Dependency edges are recovered by dataflow closure over *all* ops (a
tanh between two matmuls still links them), except what an op reads only
for its shape: the ``*_like`` and ``new_*`` factories, and of a
convolution's cotangents the input of the input's and the weight of the
weight's — each reads the output cotangent and the other operand, as the
reference's transposed convolutions do. Nor does an edge cross the
boundary of a region the traced code marked (``estimator.region``): the
reference's var identity stops at a sub-jaxpr (a call such as the
custom-VJP ``rms_norm``, a scan body), so its edges into and out of one
are dropped, and the port drops the same ones.

A product's ``out_shape`` is its value as the program reads it:
``x @ w`` over a 3-D ``x`` traces as ``mm`` between a flattening view and
``_unsafe_view``, and a batched product as ``bmm`` followed by the view
that unflattens its batch dims; the reference's ``dot_general`` keeps
those dims, so the node takes the shape of that one view.

A scanned layer stack: ``make_fx`` unrolls the loop the reference scans.
Each iteration of a ``"scan"`` region must repeat the first op for op
(the same aten ops on the same shapes, the same nodes with the same
edges); the graph keeps the first iteration's nodes, marked ``scanned``,
with ``repeat`` the number of iterations and their op totals multiplied
by it, drops the others, and numbers the nodes afresh — the reference's
node list. A loop inside a loop (the chunked attention's pair scan inside
the layer stack, the stack inside ``grad_accum``'s microbatch scan) is a
loop of its own in each iteration of the enclosing one; the innermost
loops fold first, and the enclosing iteration is then compared op for op
and folded in turn, so the repeats multiply as the reference's
``iter_eqn`` multiplies its scan lengths.

Top-level units: the reference cuts pipeline partitions on its top-level
jaxpr equations (``OpNode.top_eqn``). The port's counterpart is the
:class:`Unit`, in graph order: one outermost region (a ``"call"`` such as
``rms_norm``, or a whole scanned stack, each one equation of the
reference) or one aten op outside any region, its ``getitem`` outputs
with it. Three spellings of the two frameworks differ, and the units and
their values (``OpGraph.values``, the activations a cut between two
units moves) follow the reference's:

* a layout view (``permute``, ``t``, ``transpose``) is the value it
  views: the reference reads operands in any layout through a
  contraction's or a convolution's dimension numbers;
* a binary elementwise op over operands of two different nonzero ranks
  reads its lower-rank operand through a rank promotion — jnp's
  ``broadcast_in_dim`` equation, an operation of its own with a value of
  its own — so a unit with no ops (``Unit.fx == ()``) stands before the
  op for each promoted operand;
* a function input is not a value: weights are resident per partition
  and batch inputs enter at the stage that first reads them.

Scan expansion (``plan_scan_expansion``, ``expand_graph``): a scanned
stack is one unit, so no cut lands inside it. Expanding it folds its
iterations per chunk instead of whole: a chunk length ``g = 1`` leaves
every iteration's nodes at top level (each its own layer's resident
copy, placed and run on the kernels like any node outside a loop, its
ops and regions units of their own), ``g > 1`` makes ``ceil(R / g)``
folded loops of length at most ``g``, each one unit, as the reference
replays the stack as ``ceil(R / g)`` scans. The aten graph is the same:
``make_fx`` unrolled the stack already.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable

import torch

from repro_torch.core import estimator
from repro_torch.core.estimator import OpCounts


@dataclasses.dataclass
class OpNode:
    idx: int
    kind: str                 # matmul | conv | eltwise
    name: str                 # "<op>.<idx>"; every product "mm.<idx>"
    repeat: int               # static multiplicity (scan iterations)
    deps: list[int]
    out_shape: tuple[int, ...]
    out_elems: int            # per execution
    macs: int = 0             # totals including ``repeat``
    adds: int = 0
    muls: int = 0
    fx_node: str = ""         # name of the source fx node (executor key;
                              # the reference's ``eqn_id``): for a scanned
                              # node, the first iteration's
    scanned: bool = False     # inside a scanned layer stack: runs natively
                              # (the reference binds it as its primitive)
    top_unit: int = 0         # index of the owning top-level unit
                              # (OpGraph.units): partition cuts land on
                              # unit boundaries

    @property
    def weight_shape(self) -> tuple[int, int] | None:
        return None

    @property
    def weight_values(self) -> int:
        ws = self.weight_shape
        return ws[0] * ws[1] if ws else 0


@dataclasses.dataclass
class MatmulNode(OpNode):
    batch: int = 1
    m: int = 0
    k: int = 0
    n: int = 0
    transposed: bool = False  # the aten node's value is the product's
                              # transpose (estimator.mm_transposed)

    @property
    def weight_shape(self) -> tuple[int, int]:
        # batched matmuls hold each batch member's stationary operand;
        # fold batch into the column dimension.
        return (self.k, self.n * self.batch)


@dataclasses.dataclass
class ConvNode(OpNode):
    fan_in: int = 0
    cout: int = 0
    half: str = ""            # convolution_backward: "input" | "weight"

    @property
    def weight_shape(self) -> tuple[int, int]:
        return (self.fan_in, self.cout)


@dataclasses.dataclass
class EltwiseNode(OpNode):
    op: str = "add"           # add | sub | mul | div


@dataclasses.dataclass(frozen=True)
class Unit:
    """One top-level unit of the aten graph: the reference's top-level
    equation (module docstring)."""

    idx: int
    fx: tuple[str, ...]       # its fx nodes' names, in graph order; ()
                              # for a rank promotion
    loop: str = ""            # a folded loop: the stack it folds
    length: int = 1           # ... and its iterations


@dataclasses.dataclass
class OpGraph:
    """Cost-relevant operator graph of one traced function."""

    nodes: list[OpNode]
    gm: torch.fx.GraphModule                # the aten graph (the jaxpr's
    in_spec: Any                            # place); pytree specs of the
    out_spec: Any                           # arguments and the output
    fn: Callable | None = None
    units: list[Unit] = dataclasses.field(default_factory=list)
    # (producing unit, last reading unit — len(units) for an output —,
    # elements) of every value a unit makes: the activations partition
    # cuts move
    values: list[tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    groups: dict[str, int] = dataclasses.field(default_factory=dict)
                                            # stack -> chunk length of the
                                            # expansion applied

    def totals(self) -> OpCounts:
        c = OpCounts()
        for nd in self.nodes:
            c.macs += nd.macs
            c.adds += nd.adds
            c.muls += nd.muls
        return c

    def weight_values(self) -> int:
        return sum(nd.weight_values for nd in self.nodes)

    def weight_bits(self, n_bits: int = 32) -> int:
        return self.weight_values() * n_bits

    def matmul_like(self) -> list[OpNode]:
        return [nd for nd in self.nodes if nd.kind in ("matmul", "conv")]


aten = torch.ops.aten

# ops that read their tensor arguments for shape and dtype only
SHAPE_ONLY = {aten.ones_like.default, aten.zeros_like.default,
              aten.empty_like.default, aten.full_like.default,
              aten.new_zeros.default, aten.new_ones.default,
              aten.new_empty.default, aten.new_full.default}


def _channels_last(shape: tuple[int, ...]) -> tuple[int, ...]:
    return (shape[0], *shape[2:], shape[1])


def _conv_out_shape(fx: torch.fx.Node, half: str) -> tuple[int, ...]:
    """A conv node's value in the public layout: NHWC activations (the
    forward's output and the input cotangent), HWIO weights."""
    if half == "weight":
        w = estimator.shape_of(fx.args[2])        # OIHW
        return (*w[2:], w[1], w[0])
    if half == "input":
        return _channels_last(estimator.shape_of(fx.args[1]))
    return _channels_last(estimator.shape_of(fx))


def _data_inputs(fx: torch.fx.Node) -> list[torch.fx.Node]:
    """The fx nodes whose values ``fx`` computes from (see the module
    docstring for what is read for its shape only)."""
    if fx.target in SHAPE_ONLY:
        return []
    args = fx.args
    if fx.target is aten.convolution_backward.default:
        # (grad, input, weight, ...): the weight cotangent reads the
        # input, the input cotangent the weight
        weight = estimator.conv_backward_half(fx) == "weight"
        args = (args[0], args[1] if weight else args[2])
    ins: list[torch.fx.Node] = []
    torch.fx.node.map_arg((args, fx.kwargs), ins.append)
    return ins


def _product_shape(fx: torch.fx.Node) -> tuple[int, ...]:
    """A product's value as the program reads it: the shape of the one
    view that unflattens it (``_unsafe_view`` after ``mm``, that or
    ``view`` after ``bmm``), else its own (module docstring)."""
    users = list(fx.users)
    views = ({aten._unsafe_view.default} if fx.target is aten.mm.default
             else {aten._unsafe_view.default, aten.view.default})
    if len(users) == 1 and users[0].target in views:
        return estimator.shape_of(users[0])
    return estimator.shape_of(fx)


def _top_loop(scope: tuple):
    """The top-level loop a scope lies in: ``(stack name, iteration id)``
    of its outermost frame where that is a scan, else None."""
    if scope and scope[0][0] == "scan":
        return scope[0][1], scope[0][2]
    return None


def _stack_lengths(gm: torch.fx.GraphModule) -> dict[str, int]:
    """Each top-level loop's stack -> its number of iterations."""
    seen: set[tuple] = set()
    count: dict[str, int] = {}
    for fx in gm.graph.nodes:
        at = _top_loop(estimator.scope_of(fx))
        if at is not None and at not in seen:
            seen.add(at)
            count[at[0]] = count.get(at[0], 0) + 1
    return count


def _loops(gm: torch.fx.GraphModule):
    """Every loop of the aten graph, nested ones included: ``(enclosing
    frames, stack name)`` -> iteration id -> (its aten ops' (target,
    shape, dtype), its fx nodes), in trace order. The enclosing frames
    keep their ids, so one stack inside each iteration of an enclosing
    loop is a loop of its own per iteration, as the reference's inner
    scan runs once per outer iteration."""
    loops: dict[tuple, dict[int, tuple[list, list]]] = {}
    for fx in gm.graph.nodes:
        scope = estimator.scope_of(fx)
        if not scope:
            continue
        val = fx.meta.get("val")
        op = (fx.target, tuple(getattr(val, "shape", ())),
              getattr(val, "dtype", None))
        for j, (kind, name, rid) in enumerate(scope):
            if kind == "scan":
                ops, members = loops.setdefault(
                    (scope[:j], name), {}).setdefault(rid, ([], []))
                ops.append(op)
                members.append(fx)
    return loops


def _top_scope(scope: tuple, count: dict, groups: dict) -> tuple:
    """A scope as the expanded graph sees it: a fully unrolled stack's
    iteration is no region (its body's ops are top level, and edges
    into, out of and between its iterations are kept, as in the
    reference's re-traced jaxpr; a loop inside it becomes a top-level
    loop of its own)."""
    if (scope and scope[0][0] == "scan"
            and not _chunks(count[scope[0][1]], groups.get(scope[0][1]))):
        return scope[1:]
    return scope


def build_graph_from_capture(cap: estimator.Capture,
                             fn: Callable | None = None,
                             groups: dict[str, int] | None = None
                             ) -> OpGraph:
    """The operator graph of a capture; ``groups`` (stack name -> chunk
    length) expands those stacks (module docstring)."""
    groups = dict(groups or {})
    count = _stack_lengths(cap.gm)

    def scope(v) -> tuple:
        return _top_scope(estimator.scope_of(v), count, groups)

    nodes: list[OpNode] = []
    origin: dict[torch.fx.Node, frozenset[int]] = {}  # -> producing nodes
    for fx, scale in estimator.iter_nodes(cap.gm):
        here = scope(fx)
        src = frozenset().union(*[origin.get(v, frozenset())
                                  for v in _data_inputs(fx)
                                  if scope(v) == here])
        kind = estimator.node_kind(fx.target)
        if kind is None:
            origin[fx] = src
            continue
        idx = len(nodes)
        name = estimator.op_name(fx.target)
        if kind == "conv":
            half = (estimator.conv_backward_half(fx)
                    if fx.target is aten.convolution_backward.default
                    else "")
            out_shape = _conv_out_shape(fx, half)
        elif kind == "matmul" and estimator.mm_transposed(fx):
            out_shape = estimator.shape_of(fx)[::-1]
        elif kind == "matmul":
            out_shape = _product_shape(fx)
        else:
            out_shape = estimator.shape_of(fx)
        out_elems = estimator.numel(out_shape)
        common = dict(idx=idx, kind=kind, repeat=scale, deps=sorted(src),
                      out_elems=out_elems, out_shape=out_shape,
                      fx_node=fx.name)
        node: OpNode
        if kind == "matmul":
            b, m, n, k = estimator.mm_dims(fx)
            node = MatmulNode(name=f"mm.{idx}",
                              macs=scale * b * m * n * k, batch=b, m=m, k=k,
                              n=n, transposed=estimator.mm_transposed(fx),
                              **common)
        elif kind == "conv":
            _, fan_in, cout = estimator.conv_dims(fx)
            node = ConvNode(name=f"conv.{idx}",
                            macs=scale * out_elems * fan_in, fan_in=fan_in,
                            cout=cout, half=half, **common)
        else:
            is_add = name in estimator.ADD_OPS
            node = EltwiseNode(name=f"{name}.{idx}",
                               adds=scale * out_elems if is_add else 0,
                               muls=0 if is_add else scale * out_elems,
                               op=name, **common)
        nodes.append(node)
        origin[fx] = frozenset({node.idx})
    nodes = _fold_stacks(nodes, cap.gm, groups)
    units, unit_of, values = _units(cap.gm, groups)
    for nd in nodes:
        nd.top_unit = unit_of[nd.fx_node]
    return OpGraph(nodes=nodes, gm=cap.gm, in_spec=cap.in_spec,
                   out_spec=cap.out_spec, fn=fn, units=units,
                   values=values, groups=groups)


def _iteration_row(nd: OpNode, first: int) -> tuple:
    """What two iterations of a stack must agree on for a node: every
    field but its index, name, fx node and edges, and the edges relative
    to the iteration's first node."""
    row = dataclasses.asdict(nd)
    for key in ("idx", "name", "fx_node", "deps"):
        del row[key]
    return (type(nd).__name__, tuple(sorted(row.items())),
            tuple(d - first for d in nd.deps if d >= first))


def _chunks(n: int, group: int | None) -> list[range]:
    """A stack's ``n`` iterations as the folded loops of its expansion:
    one of all (not expanded), none (``group`` <= 1 or >= n: a full
    unroll, the reference's rule) or runs of ``group``, the last
    shorter."""
    if group is None:
        return [range(n)]
    if group <= 1 or group >= n:
        return []
    return [range(lo, min(n, lo + group)) for lo in range(0, n, group)]


def _fold_stacks(nodes: list[OpNode], gm: torch.fx.GraphModule,
                 groups: dict[str, int]) -> list[OpNode]:
    """Fold each loop back into its first iteration's nodes, innermost
    loops first, so that a loop inside a loop multiplies its ``repeat``
    by every enclosing length, as the reference's ``iter_eqn`` does; a
    top-level stack that is expanded folds each chunk into its chunk's
    first iteration instead (module docstring). Renumber every node.
    Raises ``ValueError`` where an iteration does not repeat the first
    (after the loops inside both are folded)."""
    by_fx = {nd.fx_node: nd for nd in nodes}
    loops = _loops(gm)
    drop: set[int] = set()
    for (outer, stack), iterations in sorted(
            loops.items(), key=lambda kv: -len(kv[0][0])):
        its_nodes = [[by_fx[fx.name] for fx in members
                      if fx.name in by_fx and by_fx[fx.name].idx not in drop]
                     for _, members in iterations.values()]
        (ops0, _), *rest = iterations.values()
        first = its_nodes[0]
        rows0 = [_iteration_row(nd, first[0].idx if first else 0)
                 for nd in first]
        for i, ((ops, _), its) in enumerate(zip(rest, its_nodes[1:]),
                                            start=1):
            rows = [_iteration_row(nd, its[0].idx if its else 0)
                    for nd in its]
            if ops != ops0 or rows != rows0:
                raise ValueError(
                    f"layer stack {stack!r}: iteration {i} does not "
                    f"repeat iteration 0 op for op ({len(ops)} vs "
                    f"{len(ops0)} aten ops, {len(its)} vs {len(first)} "
                    f"nodes); the reference scans only identical layers")
        group = None if outer else groups.get(stack)
        for chunk in _chunks(len(its_nodes), group):
            count = len(chunk)
            for nd in its_nodes[chunk[0]]:
                nd.repeat *= count
                nd.macs *= count
                nd.adds *= count
                nd.muls *= count
                nd.scanned = True
            for i in chunk[1:]:
                drop.update(nd.idx for nd in its_nodes[i])
    kept = [nd for nd in nodes if nd.idx not in drop]
    new_idx = {nd.idx: i for i, nd in enumerate(kept)}
    return [dataclasses.replace(
        nd, idx=new_idx[nd.idx], name=f"{nd.name.rsplit('.', 1)[0]}."
                                      f"{new_idx[nd.idx]}",
        deps=[new_idx[d] for d in nd.deps if d in new_idx])
        for nd in kept]


# ---------------------------------------------------------------------------
# top-level units and the values that cross them
# ---------------------------------------------------------------------------

# views that only relayout a value (module docstring): the value they view
LAYOUT_VIEWS = {aten.permute.default, aten.t.default, aten.transpose.int}

# binary elementwise ops the reference spells with jnp's rank promotion
PROMOTING = {aten.add.Tensor, aten.sub.Tensor, aten.mul.Tensor,
             aten.div.Tensor, aten.where.self, aten.maximum.default,
             aten.minimum.default, aten.pow.Tensor_Tensor, aten.lt.Tensor,
             aten.le.Tensor, aten.gt.Tensor, aten.ge.Tensor,
             aten.eq.Tensor, aten.ne.Tensor}


def _promoted(fx: torch.fx.Node) -> list[torch.fx.Node]:
    """The operands of ``fx`` that jnp would promote in rank: where the
    tensor operands have two or more distinct nonzero ranks, each of
    lower rank than the highest (scalars broadcast inside the op)."""
    if fx.target not in PROMOTING:
        return []
    ops = [a for a in fx.args if isinstance(a, torch.fx.Node)
           and isinstance(a.meta.get("val"), torch.Tensor)]
    ranks = {a.meta["val"].dim() for a in ops} - {0}
    if len(ranks) < 2:
        return []
    top = max(ranks)
    return [a for a in ops if 0 < a.meta["val"].dim() < top]


def _unit_keys(gm: torch.fx.GraphModule, groups: dict[str, int]) -> dict:
    """Each op's unit key: consecutive ops with one key form one unit. A
    folded loop's key names its loop (enclosing frames and stack) and
    chunk, so the loops inside two unrolled iterations of an expanded
    stack stay two units."""
    count = _stack_lengths(gm)
    ordinals = {key: {rid: i for i, rid in enumerate(its)}
                for key, its in _loops(gm).items()}
    keys: dict[torch.fx.Node, tuple] = {}
    for fx in gm.graph.nodes:
        if fx.op != "call_function":
            continue
        if fx.target is operator.getitem:
            keys[fx] = keys[fx.args[0]]
            continue
        full = estimator.scope_of(fx)
        scope = _top_scope(full, count, groups)
        if scope and scope[0][0] == "scan":        # a folded loop
            _, stack, rid = scope[0]
            outer = full[:len(full) - len(scope)]
            its = ordinals[(outer, stack)]
            chunks = _chunks(len(its), None if outer
                             else groups.get(stack))
            c = next(j for j, ch in enumerate(chunks) if its[rid] in ch)
            keys[fx] = ("loop", (outer, stack), c, len(chunks[c]))
        else:
            keys[fx] = ("region", scope[0][2]) if scope else ("op", fx.name)
    return keys


def _units(gm: torch.fx.GraphModule, groups: dict[str, int]):
    """(units, fx name -> unit index, values) of the aten graph (module
    docstring)."""
    keys = _unit_keys(gm, groups)
    members: list[list[str]] = []            # each unit's fx names
    loops: list[tuple[str, int]] = []        # each unit's (loop, length)
    unit_of: dict[str, int] = {}
    base: dict[Any, Any] = {}                # fx -> the value it is
    produced: dict[Any, int] = {}
    last: dict[Any, int] = {}
    elems: dict[Any, int] = {}

    def read(v, at: int) -> None:
        v = base.get(v)
        if v is not None:
            last[v] = at

    def make(v, at: int, n: int) -> None:
        base[v] = v
        produced[v] = last[v] = at
        elems[v] = n

    def new_unit(loop: str = "", length: int = 1) -> int:
        members.append([])
        loops.append((loop, length))
        return len(members) - 1

    prev = None
    pending: list[torch.fx.Node] = []    # top-level layout views
    for fx in gm.graph.nodes:
        if fx.op == "placeholder":
            continue
        if fx.op == "output":
            if pending:                  # trailing views: the last unit's
                at = len(members) - 1 if members else new_unit()
                members[at] += [v.name for v in pending]
                unit_of.update((v.name, at) for v in pending)
            torch.fx.node.map_arg(fx.args, lambda v: read(v, len(members)))
            break
        key = keys[fx]
        if fx.target in LAYOUT_VIEWS:
            base[fx] = base.get(fx.args[0])
            if key[0] == "op":
                # no unit of its own: it runs with the next op, whose
                # dimension numbers it is in the reference
                pending.append(fx)
                continue
        promote = _promoted(fx) if key[0] == "op" else []
        for a in promote:                    # jnp's broadcast_in_dim
            at = new_unit()
            read(a, at)
            make(("promote", fx.name, a.name), at, a.meta["val"].numel())
        if key != prev or promote:
            if key[0] == "loop":   # ("loop", (outer, stack), c, length)
                new_unit(key[1][1], key[3])
            else:
                new_unit()
            prev = key
        at = len(members) - 1
        for v in (*pending, fx):
            members[at].append(v.name)
            unit_of[v.name] = at
        pending = []
        if fx.target in LAYOUT_VIEWS:
            continue
        for v in _data_inputs(fx):
            read(("promote", fx.name, v.name) if v in promote else v, at)
        val = fx.meta.get("val")
        if isinstance(val, torch.Tensor):
            make(fx, at, val.numel())
    units = [Unit(idx=i, fx=tuple(m), loop=loop, length=length)
             for i, (m, (loop, length)) in enumerate(zip(members, loops))]
    values = [(produced[v], last[v], elems[v]) for v in produced]
    return units, unit_of, values


# ---------------------------------------------------------------------------
# scan residency: expand a scanned stack into resident per-layer copies
# ---------------------------------------------------------------------------


def scan_lengths(graph: OpGraph) -> dict[int, int]:
    """Folded loops by unit index -> static trip count (the reference's
    top-level ``scan`` equations of length > 1)."""
    return {u.idx: u.length for u in graph.units
            if u.loop and u.length > 1}


def _node_blocks(node: OpNode, weight_rows: int, weight_cols: int) -> int:
    """Subarray blocks one resident copy of this node's weight grid takes
    (0 for eltwise — peripheral units, no placement)."""
    ws = node.weight_shape
    if not ws:
        return 0
    return (max(1, math.ceil(ws[0] / weight_rows))
            * max(1, math.ceil(ws[1] / weight_cols)))


def plan_scan_expansion(graph: OpGraph, *, weight_rows: int,
                        weight_cols: int,
                        budget: int) -> dict[int, int]:
    """Capacity-bucketed expansion plan: for each folded loop owning
    placed weights, the largest copy count the subarray ``budget``
    allows.

    Returns ``{unit_idx: g}`` for :func:`expand_graph` — ``g=1`` when
    the full R-copy unroll fits, ``g>1`` (``ceil(R/g)`` resident copies)
    when it must bucket, and the site omitted entirely (refused) when
    even two resident copies would blow the budget. The budget is counted
    in subarray blocks against every node's weight grid, so un-expanded
    nodes' residency is charged too."""
    lengths = scan_lengths(graph)
    if not lengths:
        return {}
    base = sum(_node_blocks(nd, weight_rows, weight_cols)
               for nd in graph.nodes)
    free = budget - base
    plan: dict[int, int] = {}
    for unit, length in lengths.items():
        copy_blocks = sum(_node_blocks(nd, weight_rows, weight_cols)
                          for nd in graph.nodes if nd.top_unit == unit)
        if copy_blocks == 0:
            continue                       # no resident weights inside
        if (length - 1) * copy_blocks <= free:
            plan[unit] = 1                 # full unroll fits
            free -= (length - 1) * copy_blocks
            continue
        n_copies = 1 + free // copy_blocks
        if n_copies < 2:
            continue                       # refuse: cannot afford a 2nd copy
        g = math.ceil(length / n_copies)
        plan[unit] = g
        free -= (math.ceil(length / g) - 1) * copy_blocks
    return plan


def expand_graph(graph: OpGraph, *, weight_rows: int, weight_cols: int,
                 budget: int) -> OpGraph:
    """Expand ``graph``'s folded layer stacks into resident per-layer
    copies where the subarray ``budget`` allows (see
    :func:`plan_scan_expansion`); returns ``graph`` itself when no stack
    can be expanded. The rebuilt graph keeps the aten graph, ``fn`` and
    the pytree specs — the plain function remains the numerical
    oracle."""
    plan = plan_scan_expansion(graph, weight_rows=weight_rows,
                               weight_cols=weight_cols, budget=budget)
    if not plan:
        return graph
    groups = {**graph.groups,
              **{graph.units[u].loop: g for u, g in plan.items()}}
    cap = estimator.Capture(gm=graph.gm, in_spec=graph.in_spec,
                            out_spec=graph.out_spec)
    return build_graph_from_capture(cap, fn=graph.fn, groups=groups)


def build_graph(fn: Callable, *args, **kwargs) -> OpGraph:
    """Trace ``fn(*args, **kwargs)`` (meta tensors welcome — no
    allocation) and lower its aten graph to an ``OpGraph``."""
    return build_graph_from_capture(estimator.capture(fn, *args, **kwargs),
                                    fn=fn)
