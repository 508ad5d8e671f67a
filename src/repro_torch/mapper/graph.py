"""Lower an aten ``torch.fx`` graph into the mapper's operator graph: the
port of ``repro.mapper.graph``.

Reuses ``repro_torch.core.estimator.iter_nodes`` — the same traversal that
prices op counts — so the graph's op totals reconcile with
``pim_estimate`` by construction: every costed op becomes exactly one node
carrying the same MAC/add/mul count the estimator would have charged.

Node kinds:
  * ``MatmulNode``  — ``mm`` / ``bmm``; the rhs operand is treated as the
    stationary weight (x @ W convention).
  * ``ConvNode``    — ``convolution``; stationary weight is the
    (fan_in, cout) filter matrix (spatially replicated units share it).
    Its ``out_shape`` is channels-last, ``(N, *spatial, C_out)``: the
    layout of the models' public NHWC interface and of the reference's
    node, where the aten op itself returns channels-first.
  * ``EltwiseNode`` — add/sub/mul/div, priced per element; executed in the
    shared peripheral FP units, so no weight placement.

Dependency edges are recovered by dataflow closure over *all* ops (a
tanh between two matmuls still links them). A flat aten graph has no
sub-graph boundaries, so every edge is precise.

Scan expansion (``expand_graph``, ``plan_scan_expansion``) is not ported:
an aten graph has no scan — ``make_fx`` unrolls loops.
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
    name: str                 # "<aten op>.<idx>"
    repeat: int               # static multiplicity (always 1: flat graph)
    deps: list[int]
    out_shape: tuple[int, ...]
    out_elems: int            # per execution
    macs: int = 0             # totals including ``repeat``
    adds: int = 0
    muls: int = 0
    fx_node: str = ""         # name of the source fx node (executor key;
                              # the reference's ``eqn_id``)

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

    @property
    def weight_shape(self) -> tuple[int, int]:
        # batched matmuls hold each batch member's stationary operand;
        # fold batch into the column dimension.
        return (self.k, self.n * self.batch)


@dataclasses.dataclass
class ConvNode(OpNode):
    fan_in: int = 0
    cout: int = 0

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


def _channels_last(shape: tuple[int, ...]) -> tuple[int, ...]:
    return (shape[0], *shape[2:], shape[1])


def build_graph_from_capture(cap: estimator.Capture,
                             fn: Callable | None = None) -> OpGraph:
    nodes: list[OpNode] = []
    origin: dict[torch.fx.Node, frozenset[int]] = {}  # -> producing nodes
    for fx, scale in estimator.iter_nodes(cap.gm):
        ins: list[torch.fx.Node] = []
        torch.fx.node.map_arg((fx.args, fx.kwargs), ins.append)
        src = frozenset().union(*[origin.get(v, frozenset()) for v in ins])
        node: OpNode | None = None
        idx = len(nodes)
        out_shape = estimator.shape_of(fx)
        out_elems = estimator.numel(out_shape)
        kind = estimator.node_kind(fx.target)
        name = estimator.op_name(fx.target)
        common = dict(idx=idx, kind=kind, repeat=scale, deps=sorted(src),
                      out_elems=out_elems, fx_node=fx.name)
        if kind == "matmul":
            b, m, n, k = estimator.mm_dims(fx)
            node = MatmulNode(name=f"{name}.{idx}", out_shape=out_shape,
                              macs=scale * b * m * n * k, batch=b, m=m, k=k,
                              n=n, **common)
        elif kind == "conv":
            _, fan_in, cout = estimator.conv_dims(fx)
            node = ConvNode(name=f"conv.{idx}",
                            out_shape=_channels_last(out_shape),
                            macs=scale * out_elems * fan_in, fan_in=fan_in,
                            cout=cout, **common)
        elif kind == "eltwise":
            is_add = name in estimator.ADD_OPS
            node = EltwiseNode(name=f"{name}.{idx}", out_shape=out_shape,
                               adds=scale * out_elems if is_add else 0,
                               muls=0 if is_add else scale * out_elems,
                               op=name, **common)
        if node is not None:
            nodes.append(node)
            origin[fx] = frozenset({node.idx})
        else:
            origin[fx] = src
    return OpGraph(nodes=nodes, gm=cap.gm, in_spec=cap.in_spec,
                   out_spec=cap.out_spec, fn=fn)


def build_graph(fn: Callable, *args, **kwargs) -> OpGraph:
    """Trace ``fn(*args, **kwargs)`` (meta tensors welcome — no
    allocation) and lower its aten graph to an ``OpGraph``."""
    return build_graph_from_capture(estimator.capture(fn, *args, **kwargs),
                                    fn=fn)
