"""PIM cost estimation for PyTorch functions: the port of
``repro.core.estimator``.

The reference walks a jaxpr; the port walks an aten-level ``torch.fx``
graph captured by ``make_fx`` with ``tracing_mode="fake"`` (:func:`capture`)
— shapes and dtypes only, nothing computed, the analogue of tracing with
``ShapeDtypeStruct``s. Meta-device tensors are welcome as arguments. It
counts multiply-accumulate work (``mm``, ``bmm``, ``convolution``) and
elementwise FLOPs, then prices them on the paper's PIM accelerator.

MACs = matmul/conv FLOPs / 2 (one FP mul + one FP add per MAC, the Fig. 5
unit). Elementwise adds/muls are priced individually with the §3.3 closed
forms.

An aten graph is flat: ``make_fx`` inlines calls and unrolls Python
loops, so every node runs once (the reference's scan multiplicity is
always 1 here).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from repro_torch.core import accelerator as acc_mod
from repro_torch.core import cell as cell_mod
from repro_torch.core import cost as cost_mod

aten = torch.ops.aten

# ops priced as pure adds / pure muls (elementwise), by aten op name
ADD_OPS = {"add", "sub"}
MUL_OPS = {"mul", "div"}

# Lowering-rule registry: aten overload -> mapper node kind. The single
# source of truth for "which ops are PIM-lowerable", shared by the op
# counter here, the graph constructor (repro_torch.mapper.graph) and the
# executor/compiler rule table (repro_torch.mapper.lowering).
NODE_KINDS: dict[Any, str] = {
    aten.mm.default: "matmul",
    aten.bmm.default: "matmul",
    aten.convolution.default: "conv",
    **{getattr(aten, op).Tensor: "eltwise" for op in ADD_OPS | MUL_OPS},
}

# matrix products the reference prices (as dot_general) that the port
# cannot split into its node kinds yet: a graph holding one raises rather
# than under-count. Write ``x @ w + b``, not ``F.linear`` (-> addmm).
UNPRICED = {aten.addmm.default, aten.baddbmm.default, aten.addbmm.default,
            aten.addmv.default, aten.mv.default, aten.dot.default}


def node_kind(target) -> str | None:
    """Mapper node kind of an aten op, or None if it is not lowerable."""
    return NODE_KINDS.get(target)


def op_name(target) -> str:
    """The aten op's name without overload: ``aten.add.Tensor`` -> add."""
    return target.overloadpacket.__name__


@dataclasses.dataclass
class OpCounts:
    macs: int = 0
    adds: int = 0
    muls: int = 0

    def __add__(self, o: "OpCounts") -> "OpCounts":
        return OpCounts(self.macs + o.macs, self.adds + o.adds,
                        self.muls + o.muls)


def shape_of(node) -> tuple[int, ...]:
    """The traced shape of an fx node's value."""
    return tuple(node.meta["val"].shape)


def numel(shape) -> int:
    return math.prod(shape)


def mm_dims(node) -> tuple[int, int, int, int]:
    """(batch, m, n, contract) sizes of one ``mm`` / ``bmm`` node."""
    lhs, rhs = shape_of(node.args[0]), shape_of(node.args[1])
    if node.target is aten.bmm.default:
        return lhs[0], lhs[1], rhs[2], lhs[2]
    return 1, lhs[0], rhs[1], lhs[1]


def conv_dims(node) -> tuple[int, int, int]:
    """(out_elems, fan_in, cout) of one ``convolution`` node.

    fan-in per output element = prod(kernel spatial) * in_channels per
    group (the weight is ``[cout, cin / groups, *spatial]``)."""
    w = shape_of(node.args[1])
    return numel(shape_of(node)), numel(w[1:]), w[0]


def iter_nodes(gm: torch.fx.GraphModule):
    """Yield ``(node, scale)`` for every op node of ``gm``, in graph
    (topological) order; ``scale`` is always 1 in a flat aten graph. The
    single traversal shared by the op counter below and by
    ``repro_torch.mapper.graph``. Raises on an op in ``UNPRICED``."""
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if node.target in UNPRICED:
            raise NotImplementedError(
                f"{node.target} is a matrix product the port's mapper does "
                f"not price yet; write it as x @ w (+ b)")
        yield node, 1


def _count_stream(items) -> OpCounts:
    """Price a (node, scale) stream — the one op-pricing switch."""
    total = OpCounts()
    for node, scale in items:
        kind = node_kind(node.target)
        if kind == "matmul":
            b, m, n, k = mm_dims(node)
            total.macs += scale * b * m * n * k
        elif kind == "conv":
            out_elems, fan_in, _ = conv_dims(node)
            total.macs += scale * out_elems * fan_in
        elif kind == "eltwise":
            n_el = scale * numel(shape_of(node))
            if op_name(node.target) in ADD_OPS:
                total.adds += n_el
            else:
                total.muls += n_el
    return total


@dataclasses.dataclass
class Capture:
    """One shape-only trace: the aten graph and the pytree specs of the
    arguments ``(args, kwargs)`` and of the output. The graph's
    placeholders are the flattened argument leaves, in order, and it
    returns the flattened output leaves."""

    gm: torch.fx.GraphModule
    in_spec: Any
    out_spec: Any


def capture(fn: Callable, *args, **kwargs) -> Capture:
    """Trace ``fn(*args, **kwargs)`` to an aten graph with
    ``make_fx(tracing_mode="fake")``: shapes and dtypes only (meta-device
    arguments welcome — nothing is allocated or computed)."""
    flat, in_spec = pytree.tree_flatten((args, kwargs))
    if not all(isinstance(x, torch.Tensor) for x in flat):
        raise TypeError("every argument leaf must be a tensor")
    out_spec: list = []

    def flat_fn(*leaves):
        a, kw = pytree.tree_unflatten(list(leaves), in_spec)
        outs, spec = pytree.tree_flatten(fn(*a, **kw))
        out_spec[:] = [spec]
        return outs

    gm = make_fx(flat_fn, tracing_mode="fake")(*flat)
    return Capture(gm=gm, in_spec=in_spec, out_spec=out_spec[0])


def count_ops_graph(gm: torch.fx.GraphModule) -> OpCounts:
    return _count_stream(iter_nodes(gm))


def count_ops(fn: Callable, *args, **kwargs) -> OpCounts:
    return count_ops_graph(capture(fn, *args, **kwargs).gm)


@dataclasses.dataclass(frozen=True)
class PIMReport:
    """PIM training/serving cost for one computation on one design."""

    tech: str
    macs: int
    adds: int
    muls: int
    energy_j: float
    latency_s: float           # fully-serialized per-subarray latency / units
    area_m2: float
    n_subarrays: int

    def summary(self) -> str:
        return (f"[{self.tech}] MACs={self.macs:.3e} E={self.energy_j:.3e} J "
                f"T={self.latency_s:.3e} s area={self.area_m2 * 1e6:.2f} mm^2 "
                f"({self.n_subarrays} subarrays)")


def pim_estimate(counts: OpCounts, tech: str = "proposed",
                 weight_bits: int | None = None,
                 parallel_units: int | None = None,
                 t_mac_s: float | None = None,
                 e_mac_j: float | None = None) -> PIMReport:
    """Price an op-count bag on a PIM design.

    ``parallel_units``: concurrent PIM MAC lanes provisioned (default: one
    1024-lane subarray group per 2^20 weight bits, FloatPIM's layout).
    ``t_mac_s`` / ``e_mac_j`` override the per-MAC cost. The arithmetic is
    the reference's, in the same order, so the numbers are its to the bit.
    """
    accel = acc_mod.PIMAccelerator(tech)
    mac = accel.mac
    mac_t = mac.t_mac_s if t_mac_s is None else t_mac_s
    mac_e = mac.e_mac_j if e_mac_j is None else e_mac_j
    if weight_bits is None:
        weight_bits = 1 << 20
    n_sub = max(1, math.ceil(weight_bits / (acc_mod.SUBARRAY_ROWS
                                            * acc_mod.SUBARRAY_COLS)))
    if parallel_units is None:
        parallel_units = n_sub * acc_mod.SUBARRAY_COLS
    if tech == "floatpim":
        p = cost_mod.FloatPIMParams()
        t_add, e_add = cost_mod.floatpim_fp_add_cost(p)
        t_mul, e_mul = cost_mod.floatpim_fp_mul_cost(p)
    else:
        dev = (cell_mod.derive_ultrafast_costs() if tech == "ultrafast"
               else cell_mod.derive_sot_mram_costs())
        t_add, e_add = cost_mod.proposed_fp_add_cost(dev)
        t_mul, e_mul = cost_mod.proposed_fp_mul_cost(dev)
    energy = (counts.macs * mac_e + counts.adds * e_add
              + counts.muls * e_mul)
    serial_macs = math.ceil(counts.macs / parallel_units)
    serial_elem = math.ceil((counts.adds + counts.muls) / parallel_units)
    latency = serial_macs * mac_t + serial_elem * max(t_add, t_mul)
    area = (n_sub * acc_mod.SUBARRAY_ROWS * acc_mod.SUBARRAY_COLS
            * accel.cell_area * (1 + accel.periph_factor))
    return PIMReport(tech=tech, macs=counts.macs, adds=counts.adds,
                     muls=counts.muls, energy_j=energy, latency_s=latency,
                     area_m2=area, n_subarrays=n_sub)

