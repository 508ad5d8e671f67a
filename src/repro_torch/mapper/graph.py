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
node list. Scan expansion (``expand_graph``, ``plan_scan_expansion``,
which let partition cuts land inside the stack) is not ported yet
(ROADMAP.md, queue item 3.3).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class OpGraph:
    """Cost-relevant operator graph of one traced function."""

    nodes: list[OpNode]
    gm: torch.fx.GraphModule                # the aten graph (the jaxpr's
    in_spec: Any                            # place); pytree specs of the
    out_spec: Any                           # arguments and the output
    fn: Callable | None = None

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


def _stack_of(scope: tuple):
    """The outermost scan region of a scope: ``(stack name, iteration
    id)``, or None."""
    for kind, name, rid in scope:
        if kind == "scan":
            return name, rid
    return None


def build_graph_from_capture(cap: estimator.Capture,
                             fn: Callable | None = None) -> OpGraph:
    nodes: list[OpNode] = []
    origin: dict[torch.fx.Node, frozenset[int]] = {}  # -> producing nodes
    for fx, scale in estimator.iter_nodes(cap.gm):
        here = estimator.scope_of(fx)
        src = frozenset().union(*[origin.get(v, frozenset())
                                  for v in _data_inputs(fx)
                                  if estimator.scope_of(v) == here])
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
    nodes = _fold_stacks(nodes, cap.gm)
    return OpGraph(nodes=nodes, gm=cap.gm, in_spec=cap.in_spec,
                   out_spec=cap.out_spec, fn=fn)


def _iteration_row(nd: OpNode, first: int) -> tuple:
    """What two iterations of a stack must agree on for a node: every
    field but its index, name, fx node and edges, and the edges relative
    to the iteration's first node."""
    row = dataclasses.asdict(nd)
    for key in ("idx", "name", "fx_node", "deps"):
        del row[key]
    return (type(nd).__name__, tuple(sorted(row.items())),
            tuple(d - first for d in nd.deps))


def _fold_stacks(nodes: list[OpNode],
                 gm: torch.fx.GraphModule) -> list[OpNode]:
    """Fold each scanned layer stack back into its first iteration's
    nodes (module docstring); renumber every node. Raises ``ValueError``
    where an iteration does not repeat the first."""
    by_fx = {nd.fx_node: nd for nd in nodes}
    # stack -> iteration id -> (its aten ops, its nodes), in trace order
    stacks: dict[str, dict[int, tuple[list, list]]] = {}
    for fx in gm.graph.nodes:
        at = _stack_of(estimator.scope_of(fx))
        if at is None:
            continue
        ops, its_nodes = stacks.setdefault(at[0], {}).setdefault(
            at[1], ([], []))
        val = fx.meta.get("val")
        ops.append((fx.target, tuple(getattr(val, "shape", ())),
                    getattr(val, "dtype", None)))
        if fx.name in by_fx:
            its_nodes.append(by_fx[fx.name])
    drop: set[int] = set()
    for stack, iterations in stacks.items():
        (ops0, first), *rest = iterations.values()
        count = len(iterations)
        rows0 = [_iteration_row(nd, first[0].idx if first else 0)
                 for nd in first]
        for i, (ops, its) in enumerate(rest, start=1):
            rows = [_iteration_row(nd, its[0].idx if its else 0)
                    for nd in its]
            if ops != ops0 or rows != rows0:
                raise ValueError(
                    f"layer stack {stack!r}: iteration {i} does not "
                    f"repeat iteration 0 op for op ({len(ops)} vs "
                    f"{len(ops0)} aten ops, {len(its)} vs {len(first)} "
                    f"nodes); the reference scans only identical layers")
            drop.update(nd.idx for nd in its)
        for nd in first:
            nd.repeat *= count
            nd.macs *= count
            nd.adds *= count
            nd.muls *= count
            nd.scanned = True
    kept = [nd for nd in nodes if nd.idx not in drop]
    new_idx = {nd.idx: i for i, nd in enumerate(kept)}
    return [dataclasses.replace(
        nd, idx=new_idx[nd.idx], name=f"{nd.name.rsplit('.', 1)[0]}."
                                      f"{new_idx[nd.idx]}",
        deps=[new_idx[d] for d in nd.deps if d in new_idx])
        for nd in kept]


def build_graph(fn: Callable, *args, **kwargs) -> OpGraph:
    """Trace ``fn(*args, **kwargs)`` (meta tensors welcome — no
    allocation) and lower its aten graph to an ``OpGraph``."""
    return build_graph_from_capture(estimator.capture(fn, *args, **kwargs),
                                    fn=fn)
