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
always 1 here). Where the reference's jaxpr has sub-jaxprs — a call such
as the custom-VJP ``rms_norm``, or the scanned layer stack — the traced
code marks them with :func:`region`, and :func:`capture` records each fx
node's regions in its meta (:func:`scope_of`): the mapper's graph drops
the edges that cross a region's boundary and folds a stack's iterations
back into one set of nodes with ``repeat``, as the reference's graph
does (``repro_torch.mapper.graph``). The op counts do not depend on it.

A backward pass is captured from ``torch.func.grad_and_value`` (the
reference's ``jax.value_and_grad``). Where torch's autograd formulas fuse
what JAX's transpose rules spell as separate primitives, :func:`capture`
respells them (:data:`DECOMPOSITIONS`) so the graph holds the reference's
costed nodes in its order:

* ``tanh_backward(g, y)`` -> ``t = g * (1 - y)``, ``t * y`` and the
  cotangent sum :func:`add_any` (unpriced, as JAX's ``add_any``); the
  residual ``1 - y`` moves to right after its ``tanh``, where JAX's
  linearization evaluates it (:func:`_hoist_residuals`);
* ``convolution_backward`` -> one ``convolution_backward`` per requested
  cotangent, the weight's first and the input's second, as the reference's
  two transposed convolutions; each is priced as the convolution JAX
  emits (:func:`conv_dims`);
* ``mm(t(a), b)``, autograd's weight cotangent ``xᵀg``, is priced and
  oriented as the reference's ``dot_general`` contracting dim 0 of both
  operands: ``(bᵀa)ᵀ`` with ``a`` the stationary operand
  (:func:`mm_transposed`).

A backward written out by hand (the decoder's layer stack) spells the
ops the reference's graph does not see as ops of their own, unpriced:
the cotangent sum :func:`add_any`, ``silu``'s and ``softplus``'s VJPs
:func:`silu_vjp` and :func:`softplus_vjp` (the reference's ``silu`` and
``softplus`` are jits whose ops it does not walk),
``jnp.where``'s outputs :func:`select_parts`, ``take_along_axis``'s
:func:`take_parts` and a gather's transpose :func:`scatter_add` (the
mixture-of-experts block's dispatch and combine). A chunk's slice and a
loop carry's update by a traced index are :func:`dynamic_slice` and
:func:`dynamic_update_slice_`, the reference's ``dynamic_slice`` and
``dynamic_update_slice`` (unpriced there too). Elsewhere the same holds
for the paged decode attention kernels K4 and K6 (the reference's graph
does not enter a ``pallas_call``; ``kernels.flash_attention.paged_decode_op``
and ``paged_decode_q_op``) and the grid rounding's bit-plane increment
(``core.quant.round_mantissa``). An in-place write (``index_put_``, the
paged pool's) is no node, as the reference's ``scatter`` is none; the
ops that read the written tensor after it draw their edges through it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Callable

import torch
import torch.fx.traceback as fx_traceback
from torch.fx._lazy_graph_module import _use_lazy_graph_module
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from repro_torch.core import accelerator as acc_mod
from repro_torch.core import cell as cell_mod
from repro_torch.core import cost as cost_mod

aten = torch.ops.aten

# ops priced as pure adds / pure muls (elementwise), by op name
ADD_OPS = {"add", "sub"}
MUL_OPS = {"mul", "div"}

# elementwise aten overloads -> the reference primitive they price as;
# ``rsub`` is ``1 - y`` (JAX's ``sub 1.0 y``)
ELTWISE_OPS: dict[Any, str] = {
    **{getattr(aten, op).Tensor: op for op in ADD_OPS | MUL_OPS},
    aten.rsub.Scalar: "sub",
}

# Lowering-rule registry: aten overload -> mapper node kind. The single
# source of truth for "which ops are PIM-lowerable", shared by the op
# counter here, the graph constructor (repro_torch.mapper.graph) and the
# executor/compiler rule table (repro_torch.mapper.lowering).
NODE_KINDS: dict[Any, str] = {
    aten.mm.default: "matmul",
    aten.bmm.default: "matmul",
    aten.convolution.default: "conv",
    aten.convolution_backward.default: "conv",
    **{op: "eltwise" for op in ELTWISE_OPS},
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
    """The name a node of ``target`` carries: the reference primitive an
    elementwise op prices as (``aten.rsub.Scalar`` -> sub), else the aten
    op's name without overload (``aten.mm.default`` -> mm)."""
    return ELTWISE_OPS.get(target) or getattr(target, "overloadpacket",
                                              target).__name__


@torch.library.custom_op("repro_torch::add_any", mutates_args=())
def add_any(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The cotangent sum: ``a + b``, JAX's ``add_any``. A primitive of its
    own so that, as in the reference, it is not priced."""
    return a + b


@add_any.register_fake
def _add_any_fake(a, b):
    return a + b


@torch.library.custom_op("repro_torch::select_parts", mutates_args=())
def select_parts(mask: torch.Tensor, x: torch.Tensor,
                 fill: float) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``jnp.where(mask, x, fill)`` as the reference traces it: one call
    whose outputs are the selection, the mask and a zero (what the
    selection's transpose selects from). The reference's graph gives
    every output of such a call an edge from each input, ``x`` included;
    one op of its own carries the same edges here."""
    return (torch.where(mask, x, torch.full((), fill, dtype=x.dtype,
                                             device=x.device)),
            mask.clone(), x.new_zeros(()))


@select_parts.register_fake
def _select_parts_fake(mask, x, fill):
    return (torch.empty_like(x), torch.empty_like(mask), x.new_empty(()))


@torch.library.custom_op("repro_torch::take_parts", mutates_args=())
def take_parts(x: torch.Tensor, index: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jnp.take_along_axis(x, index[..., None], axis=1)`` as the
    reference traces it: one call whose outputs are the rows of ``x``
    [G, N, D] at ``index`` [G, M] and the index (what the gather's
    transpose scatters by), each with an edge from both inputs, as the
    reference's graph gives every output of a call."""
    return (torch.take_along_dim(x, index[..., None].long(), dim=1),
            index.clone())


@take_parts.register_fake
def _take_parts_fake(x, index):
    return (x.new_empty((*index.shape, x.shape[2])), torch.empty_like(index))


@torch.library.custom_op("repro_torch::scatter_add", mutates_args=())
def scatter_add(src: torch.Tensor, index: torch.Tensor,
                size: int) -> torch.Tensor:
    """The transpose of a gather along axis ``d = index.dim() - 1``:
    zeros with ``src``'s shape but ``size`` along ``d``, and each
    ``src[..., i, ...]`` added at ``index[..., i]`` (``index`` has
    ``src``'s leading ``d + 1`` dims). The reference's ``scatter-add``,
    unpriced, in a fixed order: duplicate indices sum the same way on
    every run (CUDA: ``index_put_`` with ``accumulate``, sorted; the CPU:
    ``index_add_``, serial), where ``scatter_add_`` on the card adds by
    atomics in no fixed order."""
    d = index.dim() - 1
    lead = math.prod(src.shape[:d])
    rest = math.prod(src.shape[d + 1:])
    n = src.shape[d]
    rows = (index.reshape(lead, n).long() + size * torch.arange(
        lead, device=src.device)[:, None]).reshape(-1)
    vals = src.reshape(lead * n, rest)
    out = src.new_zeros(lead * size, rest)
    if src.is_cuda:
        out.index_put_((rows,), vals, accumulate=True)
    else:
        out.index_add_(0, rows, vals)
    return out.reshape(*src.shape[:d], size, *src.shape[d + 1:])


@scatter_add.register_fake
def _scatter_add_fake(src, index, size):
    d = index.dim() - 1
    return src.new_empty((*src.shape[:d], size, *src.shape[d + 1:]))


@torch.library.custom_op("repro_torch::silu_vjp", mutates_args=())
def silu_vjp(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``x`` in ``silu(x)`` for the cotangent ``g``, as
    the reference's transpose computes it: ``g·σ + (x·g)·σ(1-σ)``. The
    reference's ``silu`` is a jit of its own, whose ops its graph does not
    price; one op of its own keeps them unpriced here."""
    sig = torch.sigmoid(x)
    return g * sig + (x * g) * (sig * (1 - sig))


@silu_vjp.register_fake
def _silu_vjp_fake(g, x):
    return torch.empty_like(g)


@torch.library.custom_op("repro_torch::softplus_vjp", mutates_args=())
def softplus_vjp(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``x`` in ``softplus(x)`` for the cotangent ``g``:
    ``g·σ(x)``. The reference's ``softplus`` is a jit of its own, whose
    ops its graph does not price; one op of its own keeps them unpriced
    here."""
    return g * torch.sigmoid(x)


@softplus_vjp.register_fake
def _softplus_vjp_fake(g, x):
    return torch.empty_like(g)


def _window(x: torch.Tensor, start: torch.Tensor, size: int,
            dim: int) -> torch.Tensor:
    """The ``size`` indices along ``dim`` of ``x`` from ``start`` (a 0-d
    integer tensor), the start clamped into the axis as XLA clamps a
    dynamic slice's; computed on the device, no host read."""
    at = start.clamp(0, x.shape[dim] - size).long()
    return at + torch.arange(size, device=x.device)


@torch.library.custom_op("repro_torch::dynamic_slice", mutates_args=())
def dynamic_slice(x: torch.Tensor, start: torch.Tensor, size: int,
                  dim: int) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim(x, start, size, dim)``: ``size`` entries
    of ``x`` along ``dim`` from the traced index ``start``, a copy. A
    primitive of its own, unpriced, as the reference's ``dynamic_slice``;
    its result draws edges from ``x`` and ``start``."""
    return x.index_select(dim, _window(x, start, size, dim))


@dynamic_slice.register_fake
def _dynamic_slice_fake(x, start, size, dim):
    shape = list(x.shape)
    shape[dim] = size
    return x.new_empty(shape)


@torch.library.custom_op("repro_torch::dynamic_update_slice_",
                         mutates_args=("x",))
def dynamic_update_slice_(x: torch.Tensor, update: torch.Tensor,
                          start: torch.Tensor, dim: int) -> None:
    """``x = lax.dynamic_update_slice_in_dim(x, update, start, dim)``,
    written in place: a loop's carry updated one chunk at a time, where the
    reference's XLA buffer is reused (a copy of the whole carry per
    iteration would move ~0.5 TB in a 32-layer prefill at seq 8192).
    Unpriced, as the reference's ``dynamic_update_slice``."""
    x.index_copy_(dim, _window(x, start, update.shape[dim], dim),
                  update.to(x.dtype))


@dynamic_update_slice_.register_fake
def _dynamic_update_slice_fake(x, update, start, dim):
    return None


# where a traced node's regions live: node.meta["custom"][SCOPE_KEY]
SCOPE_KEY = "repro_torch.region"
_REGION_IDS = itertools.count()


@contextlib.contextmanager
def region(kind: str, name: str):
    """Mark the ops traced inside as one sub-jaxpr of the reference:
    ``kind`` ``"call"`` (a call primitive, as the custom-VJP ``rms_norm``)
    or ``"scan"`` (one iteration of the scanned layer stack ``name``).
    Each entry is a region of its own: a frame ``(kind, name, id)`` pushed
    onto the scope that :func:`capture` copies into each fx node made
    inside (:func:`scope_of`). Outside a trace it only updates a dict."""
    meta = fx_traceback.current_meta
    saved = meta.get("custom")
    frames = (saved or {}).get(SCOPE_KEY, ())
    meta["custom"] = {**(saved or {}),
                      SCOPE_KEY: (*frames, (kind, name, next(_REGION_IDS)))}
    try:
        yield
    finally:
        if saved is None:
            meta.pop("custom", None)
        else:
            meta["custom"] = saved


def scope_of(node) -> tuple:
    """The regions an fx node was traced in, outermost first: frames
    ``(kind, name, id)``; () outside any."""
    return node.meta.get("custom", {}).get(SCOPE_KEY, ())


def set_scope(node, scope: tuple) -> None:
    """Record ``scope`` as the regions of fx ``node`` (a copied node)."""
    node.meta["custom"] = {**node.meta.get("custom", {}), SCOPE_KEY: scope}


def renumbered(scope: tuple, depth: int, ids: dict) -> tuple:
    """``scope`` with its frames from ``depth`` on given fresh ids, one
    for each id they held (``ids`` keeps the pairing across the nodes of
    one copy): the regions of a copy of a traced loop iteration."""
    out = list(scope[:depth])
    for kind, name, rid in scope[depth:]:
        if rid not in ids:
            ids[rid] = next(_REGION_IDS)
        out.append((kind, name, ids[rid]))
    return tuple(out)


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


def _is_transpose(node) -> bool:
    """Whether fx ``node`` swaps the two dims of a 2-D tensor."""
    if not isinstance(node, torch.fx.Node) or len(shape_of(node)) != 2:
        return False
    if node.target is aten.t.default:
        return True
    if node.target is aten.transpose.int:
        return sorted(d % 2 for d in node.args[1:3]) == [0, 1]
    return (node.target is aten.permute.default
            and list(node.args[1]) in ([1, 0], [-1, -2]))


def mm_transposed(node) -> bool:
    """``mm(t(a), b)``: the product contracts the rows of ``a`` and ``b``
    — autograd's weight cotangent ``xᵀg``. The reference's transpose rule
    emits it as ``dot_general(g, x)`` contracting dim 0 of both, then a
    transpose: the product ``gᵀx`` with ``x`` stationary. The mapper
    prices and places it so; the aten node's value is that product's
    transpose."""
    return node.target is aten.mm.default and _is_transpose(node.args[0])


def mm_dims(node) -> tuple[int, int, int, int]:
    """(batch, m, n, contract) sizes of one ``mm`` / ``bmm`` node, in the
    reference's orientation (see :func:`mm_transposed`)."""
    lhs, rhs = shape_of(node.args[0]), shape_of(node.args[1])
    if node.target is aten.bmm.default:
        return lhs[0], lhs[1], rhs[2], lhs[2]
    if mm_transposed(node):
        return 1, rhs[1], lhs[0], lhs[1]
    return 1, lhs[0], rhs[1], lhs[1]


def conv_backward_half(node) -> str:
    """Which cotangent a ``convolution_backward`` node computes: ``"input"``
    or ``"weight"`` (:func:`capture` splits the op, one per cotangent)."""
    mask = list(node.args[10])
    if mask == [True, False, False]:
        return "input"
    if mask == [False, True, False]:
        return "weight"
    raise NotImplementedError(
        f"convolution_backward with output_mask {mask}: the mapper prices "
        f"one cotangent per node (trace through estimator.capture)")


def conv_dims(node) -> tuple[int, int, int]:
    """(out_elems, fan_in, cout) of one ``convolution`` node.

    fan-in per output element = prod(kernel spatial) * in_channels per
    group (the weight is ``[cout, cin / groups, *spatial]``). A
    ``convolution_backward`` node is priced as the convolution the
    reference's transpose rule emits for its cotangent: the weight's
    convolves the input with the output cotangent as kernel (fan-in =
    batch x output spatial, cout = the weight's out channels), the
    input's convolves the padded cotangent with the flipped kernel
    (fan-in = kernel spatial x out channels, cout = in channels)."""
    if node.target is aten.convolution_backward.default:
        if node.args[7] or node.args[9] != 1:
            raise NotImplementedError(
                "the backward of a transposed or grouped convolution is "
                "not priced yet")
        g, w = shape_of(node.args[0]), shape_of(node.args[2])
        if conv_backward_half(node) == "weight":
            return numel(w), numel(g) // g[1], w[0]
        return numel(shape_of(node.args[1])), numel(w) // w[1], w[1]
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
            if ELTWISE_OPS[node.target] in ADD_OPS:
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


def _tanh_backward(g, y):
    """JAX's tanh VJP: ``t = g * (1 - y)``, then ``t + t * y``."""
    t = g * (1 - y)
    return add_any(t, t * y)


def _convolution_backward(grad, inp, weight, bias_sizes, stride, padding,
                          dilation, transposed, output_padding, groups,
                          output_mask):
    """One ``convolution_backward`` per requested cotangent, the weight's
    first (the reference's order); the bias's is the plain sum."""
    mask = list(output_mask)
    if sum(mask[:2]) < 2 and not mask[2]:
        return NotImplemented           # one cotangent: the op itself
    conf = (bias_sizes, stride, padding, dilation, transposed,
            output_padding, groups)
    grad_w = grad_x = grad_b = None
    if mask[1]:
        grad_w = aten.convolution_backward.default(
            grad, inp, weight, *conf, [False, True, False])[1]
    if mask[0]:
        grad_x = aten.convolution_backward.default(
            grad, inp, weight, *conf, [True, False, False])[0]
    if mask[2]:
        grad_b = grad.sum([0, *range(2, grad.dim())])
    return grad_x, grad_w, grad_b


# torch's fused backward formulas respelled as the reference's primitives
DECOMPOSITIONS = {
    aten.tanh_backward.default: _tanh_backward,
    aten.convolution_backward.default: _convolution_backward,
}


def _hoist_residuals(gm: torch.fx.GraphModule) -> None:
    """Move each ``1 - y`` of a respelled ``tanh_backward`` to right after
    its ``tanh``: JAX's linearization evaluates that residual in the
    forward pass, so the reference's graph holds it there. The module's
    code is regenerated only where a node moved (seconds at 10^5 nodes)."""
    moved = False
    for node in list(gm.graph.nodes):
        y = node.args[0] if node.target is aten.rsub.Scalar else None
        if (isinstance(y, torch.fx.Node) and y.target is aten.tanh.default
                and y.next is not node):
            y.append(node)
            moved = True
    if moved:
        gm.recompile()


# marks a node that only stands for another (``models.lin``'s copied
# loop iterations): :func:`capture` replaces it by the node it reads
STAND_IN_KEY = "repro_torch.stand_in"


def _drop_stand_ins(gm: torch.fx.GraphModule) -> None:
    """Replace each stand-in node by the node it reads and erase it, so
    the graph holds what tracing every iteration would have."""
    moved = False
    for node in list(gm.graph.nodes):
        if node.meta.get(STAND_IN_KEY):
            node.replace_all_uses_with(node.args[0])
            gm.graph.erase_node(node)
            moved = True
    if moved:
        gm.recompile()


def capture(fn: Callable, *args, **kwargs) -> Capture:
    """Trace ``fn(*args, **kwargs)`` to an aten graph with
    ``make_fx(tracing_mode="fake")``: shapes and dtypes only (meta-device
    arguments welcome — nothing is allocated or computed). Backward
    formulas are respelled as the reference's primitives
    (:data:`DECOMPOSITIONS`); each node keeps the regions it was traced
    in (:func:`region`)."""
    flat, in_spec = pytree.tree_flatten((args, kwargs))
    if not all(isinstance(x, torch.Tensor) for x in flat):
        raise TypeError("every argument leaf must be a tensor")
    out_spec: list = []

    def flat_fn(*leaves):
        a, kw = pytree.tree_unflatten(list(leaves), in_spec)
        outs, spec = pytree.tree_flatten(fn(*a, **kw))
        out_spec[:] = [spec]
        return outs

    # a lazy module: its Python code is generated at its first call, not
    # after each edit (seconds at 10^5 nodes; the mapper reads the graph)
    with fx_traceback.preserve_node_meta(), _use_lazy_graph_module(True):
        gm = make_fx(flat_fn, tracing_mode="fake",
                     decomposition_table=DECOMPOSITIONS)(*flat)
        _drop_stand_ins(gm)
        _hoist_residuals(gm)
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

