"""Numerical executor: run a static schedule with the port's PIM kernels.
The port of ``repro.mapper.executor``.

Replays the schedule's aten graph node by node through the shared
lowering-rule table (``repro_torch.mapper.lowering``). Placed matmul nodes
execute as one ``pim_matmul`` (K2) call *per placed weight block* (partial
products accumulated across blocks — the block structure of the placement
drives the compute); simple convolutions lower to im2col + the same placed
blocked matmul; eltwise add/sub/mul run through ``pim_mac`` (K3).
Everything else (views, reductions, nonlinearities) runs its own aten op,
so the output must match the plain function to float32 tolerance.

This per-block walk is the **verification mode** — and the *per-block
oracle* the compiled program (``repro_torch.mapper.compile``) must match
bit for bit: the compiler replays the identical rule table grouped,
stacking each node's blocks into one ``pim_matmul_grouped`` (K1) launch.
Over a sub-fp32 weight grid each block is quantized as the compiler
quantizes it (K2 then runs on the dequantized block, K5's program on the
codes and scales), and the executor records each block's quantization
error into the ``pim.quant_layer_rel_error`` histogram.

The counters (``placed_blocks``, ``kernel_launches``, ...) add up over the
executor's runs, as the reference's do.

Differentiable, as the reference's executor is under ``jax.grad``: when an
argument requires grad, a run records autograd's graph, and each placed
block's cotangents come from K2's backward pass (``_Matmul`` in
``repro_torch.kernels.pim_mac``), each MAC's from K3's. Otherwise the run
is under ``torch.no_grad()``.

``run_fake_quant_plain`` is the quantized schedule's plain oracle: the
same aten graph with native ops only, each placed product reading its
stationary operand through ``core.quant.fake_quant`` per placed row block.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core import quant
from repro_torch.mapper.lowering import (LoweringContext, eval_placed,
                                         native_kwargs)
from repro_torch.mapper.schedule import Schedule


def flatten_args(schedule: Schedule, device: torch.device, args,
                 kwargs) -> list:
    """The call's argument leaves, checked against the traced structure
    and against ``device``."""
    flat, spec = pytree.tree_flatten((args, kwargs))
    if spec != schedule.graph.in_spec:
        raise TypeError(f"argument structure {spec} != traced structure "
                        f"{schedule.graph.in_spec}")
    for x in flat:
        if not isinstance(x, torch.Tensor) or x.device != device:
            raise ValueError(f"argument leaf on "
                             f"{getattr(x, 'device', type(x))}: the "
                             f"schedule runs on {device}")
    return flat


@contextlib.contextmanager
def full_float32():
    """float32 matrix products and convolutions in full float32 on the
    card: cuDNN convolutions default to TF32, which keeps about 3 digits."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def max_deviation(got, want, rtol: float, atol: float) -> float:
    """Max abs deviation of ``got`` from ``want`` (pytrees of tensors);
    raises if outside ``rtol`` / ``atol``."""
    worst = 0.0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want),
                    strict=True):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
        if g.numel():
            worst = max(worst, float((g - w).abs().max()))
    return worst


@dataclasses.dataclass
class ScheduleExecutor:
    """Run ``schedule`` numerically on ``device`` (CUDA by default), one
    launch per placed block: the per-block oracle (module docstring)."""

    schedule: Schedule
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._ctx = LoweringContext(self.schedule, grouped=False)

    # kernel-routed work/launch counters live on the shared lowering ctx
    @property
    def placed_blocks(self) -> int:
        return self._ctx.placed_blocks

    @property
    def eltwise_calls(self) -> int:
        return self._ctx.eltwise_calls

    @property
    def kernel_launches(self) -> int:
        return self._ctx.kernel_launches

    @property
    def matmul_launches(self) -> int:
        return self._ctx.matmul_launches

    @property
    def eltwise_launches(self) -> int:
        return self._ctx.eltwise_launches

    # -- public API ---------------------------------------------------------

    def run(self, *args, **kwargs):
        flat = flatten_args(self.schedule, self.device, args, kwargs)
        tr = obs.tracer()
        grad = torch.is_grad_enabled() and any(x.requires_grad for x in flat)
        with torch.set_grad_enabled(grad):
            if tr.enabled:
                # depth-0 run span; the per-node launch spans recorded in
                # eval_placed nest under it
                with tr.span("run:schedule", lane="execute",
                             sync=self.device.type == "cuda"):
                    outs = eval_placed(self._ctx, flat)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            else:
                outs = eval_placed(self._ctx, flat)
        m = obs.metrics()
        m.counter("executor.runs").inc()
        m.gauge("executor.placed_blocks").set(self._ctx.placed_blocks)
        m.gauge("executor.kernel_launches").set(self._ctx.kernel_launches)
        return pytree.tree_unflatten(outs, self.schedule.graph.out_spec)

    def verify(self, *args, rtol: float = 1e-4, atol: float = 1e-4,
               **kwargs) -> float:
        """Run the schedule and compare against the plain function
        (float32, TF32 off). Returns the max abs deviation; raises if
        outside tolerance."""
        fn = self.schedule.graph.fn
        assert fn is not None, "graph was built without a fn reference"
        got = self.run(*args, **kwargs)
        with torch.no_grad(), full_float32():
            want = fn(*args, **kwargs)
        return max_deviation(got, want, rtol, atol)


def fake_quant_stationary(schedule: Schedule, node, w: torch.Tensor
                          ) -> torch.Tensor:
    """What the schedule's weight grid stores of a placed product's
    stationary operand ``w`` (the (k, n) matrix of ``node.weight_shape``),
    dequantized: ``quant.fake_quant`` per placed row block and column, as
    K5 reads it. The identity, in float32, on the fp32 grid."""
    grid = schedule.hierarchy.subarray.weight_dtype
    rows = schedule.hierarchy.subarray.weight_rows
    assert tuple(w.shape) == tuple(node.weight_shape), node.name
    return torch.cat([quant.fake_quant(w[r:r + rows], grid)
                      for r in range(0, w.shape[0], rows)])


def run_fake_quant_plain(schedule: Schedule, *args, **kwargs):
    """The schedule's aten graph run with native ops on the arguments'
    device (float32, TF32 off), each placed product outside a scanned
    stack (the lowering runs those inside natively) — ``aten.mm`` or a
    forward ``aten.convolution`` with a placement — over its stationary
    operand (the node's weight, of shape ``node.weight_shape``) replaced by
    ``quant.fake_quant`` of it per (placed row block, column) on the
    schedule's weight grid. No kernel, padding, stacking or fusion of the
    lowering takes part: an oracle for the quantized program, to float32
    tolerance."""
    flat, spec = pytree.tree_flatten((args, kwargs))
    if spec != schedule.graph.in_spec:
        raise TypeError(f"argument structure {spec} != traced structure "
                        f"{schedule.graph.in_spec}")
    placed = {nd.fx_node: nd for nd in schedule.graph.nodes
              if nd.idx in schedule.placement.node_placements
              and not nd.scanned}
    aten = torch.ops.aten

    def stored(w, node):
        return fake_quant_stationary(schedule, node, w)

    def call(fx, node, args, kwargs):
        if node is not None and fx.target is aten.mm.default:
            lhs, rhs = args
            if node.transposed:       # mm(t(x), g): x stationary
                return stored(lhs.T, node).T @ rhs
            return lhs @ stored(rhs, node)
        if node is not None and fx.target is aten.convolution.default:
            w = args[1]
            cout, cin, kh, kw = w.shape
            view = stored(w.permute(2, 3, 1, 0).reshape(-1, cout), node)
            w = view.reshape(kh, kw, cin, cout).permute(3, 2, 0, 1)
            return fx.target(args[0], w, *args[2:])
        return fx.target(*args, **kwargs)

    env: dict = {}
    leaves = iter(flat)
    device = flat[0].device if flat else None
    with torch.no_grad(), full_float32():
        for fx in schedule.graph.gm.graph.nodes:
            if fx.op == "placeholder":
                env[fx] = next(leaves)
            elif fx.op == "output":
                outs = [env[v] for v in fx.args[0]]
                return pytree.tree_unflatten(outs, schedule.graph.out_spec)
            else:
                args = torch.fx.node.map_arg(fx.args, env.__getitem__)
                kw = native_kwargs(fx, env.__getitem__, device)
                env[fx] = call(fx, placed.get(fx.name), args, kw)
    raise AssertionError("the graph has no output node")


def run_schedule(schedule: Schedule, *args,
                 device: str | torch.device | None = None, **kwargs):
    """One-shot: execute ``schedule`` on concrete inputs on ``device``
    (CUDA by default)."""
    return ScheduleExecutor(schedule, device=device).run(*args, **kwargs)
