"""The reference's linearization and transpose, rule by rule: a tape of
JAX's primitives for the written-out VJPs of the recurrent blocks.

``jax.value_and_grad`` differentiates a function by linearizing it (its
JVP, split into the known part the forward evaluates and the linear part
in the tangents) and then transposing the linear part, last op first. The
mapper prices what that emits: the forward's known ops (a ``max``'s tie
factors, ``logistic``'s and ``tanh``'s derivatives, ``integer_pow``'s
coefficient), and the transposes of the linear ops (each ``mul`` by its
other operand, a ``div``'s three products, a ``dot_general``'s two
products, the weight's first). A :class:`Tape` spells a block's forward
in JAX's primitives, each op evaluating its primal value and, when the
tape linearizes (``lin=True``), the known part of its JVP rule, and
recording the linear part; :meth:`Tape.transpose` then runs the recorded
ops' transpose rules in reverse. So the ops a block's VJP emits, their
order and their operands are the reference's by construction, rule for
rule: ``max`` splits a tie in halves (``_balanced_eq``), ``abs`` at 0
passes the cotangent (``select(x >= 0, g, -g)``), ``tanh`` transposes as
``t = g·(1 - y)`` then ``t + t·y``, ``div`` by ``y`` as ``g·y⁻²·x``
negated.

What the reference's graph does not price stays unpriced here: the
cotangent sums (``estimator.add_any``), reshapes, slices, pads,
broadcasts and their transposes, ``exp``, ``max``, ``select``; and
``softplus`` / ``silu``, jits of their own in the reference, whose
derivatives are the custom ops ``estimator.softplus_vjp`` /
``silu_vjp``. A value carries a tangent when it is an input marked by
:meth:`Tape.var` or an op's output with an operand that does
(JAX's symbolic zeros: an op on constants records nothing).

A tape with ``lin=False`` evaluates the primal ops alone, as the
forward of a ``jax.checkpoint``-ed function (whose VJP recomputes it) and
a loop of JAX's differentiated primal (``cummax`` as its associative
scan) spell them. Loops: :meth:`Tape.loop` (a ``lax.scan``: each
iteration linearized, its transpose the iterations' transposes in
reverse) and :meth:`Tape.checkpoint_loop` (a scan of a checkpointed
body: the forward primal, and the transpose of each iteration inside a
``"call"`` region that recomputes it linearized first). The transpose
closures hold the residuals they read, so a tape lives as long as the
backward that transposes it.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor
from torch.fx.experimental.proxy_tensor import get_proxy_mode, get_proxy_slot

from repro_torch.core import estimator
from repro_torch.models import layers


def _unbroadcast(ct: torch.Tensor, shape) -> torch.Tensor:
    """The transpose of a broadcast to ``ct``'s shape from ``shape``: a
    sum over the broadcast dims (unpriced)."""
    shape = tuple(shape)
    if tuple(ct.shape) == shape:
        return ct
    lead = ct.dim() - len(shape)
    dims = list(range(lead)) + [lead + i for i, n in enumerate(shape)
                                if n == 1 and ct.shape[lead + i] != 1]
    return ct.sum(dims).reshape(shape) if dims else ct.reshape(shape)


def _ranges_like(*xs) -> list[list[int]]:
    start, out = 0, []
    for x in xs:
        out.append(list(range(start, start + len(x))))
        start += len(x)
    return out


def _remaining(n: int, *taken) -> list[int]:
    drop = {d for t in taken for d in t}
    return [d for d in range(n) if d not in drop]


def dot_general(x: torch.Tensor, y: torch.Tensor, dims) -> torch.Tensor:
    """``lax.dot_general(x, y, dims)`` as one ``bmm`` whose batch, rows,
    columns and contraction are the reference's (so the mapper prices
    and places it as the reference's node): the output's axes are the
    batch dims, then ``x``'s free dims, then ``y``'s."""
    (xc, yc), (xb, yb) = dims
    xk = _remaining(x.dim(), xc, xb)
    yk = _remaining(y.dim(), yc, yb)
    size = lambda t, ds: math.prod(t.shape[d] for d in ds)
    b, m, k, n = size(x, xb), size(x, xk), size(x, xc), size(y, yk)
    a = x.permute(*xb, *xk, *xc).reshape(b, m, k)
    w = y.permute(*yb, *yc, *yk).reshape(b, k, n)
    out = [x.shape[d] for d in (*xb, *xk)] + [y.shape[d] for d in yk]
    return torch.bmm(a, w).view(out)


def _dot_transpose_lhs(g, x_shape, y, dims, swap_ans: bool = False):
    """JAX's ``_dot_general_transpose_lhs``: the cotangent of ``x`` in
    ``dot_general(x, y, dims)`` as ``dot_general(g, y)`` and a
    transpose."""
    (xc, yc), (xb, yb) = dims
    x_kept = _remaining(len(x_shape), xc, xb)
    y_kept = _remaining(y.dim(), yc, yb)
    if swap_ans:
        ans_batch, ans_y, _ = _ranges_like(xb, y_kept, x_kept)
    else:
        ans_batch, _, ans_y = _ranges_like(xb, x_kept, y_kept)
    d = ((ans_y, y_kept), (ans_batch, list(yb)))
    xc_by_y = list(np.take(xc, np.argsort(yc))) if len(xc) else []
    unsorted = list(xb) + x_kept + [int(a) for a in xc_by_y]
    out = dot_general(g, y, d)
    perm = [int(a) for a in np.argsort(unsorted)]
    return out if perm == list(range(len(perm))) else out.permute(perm)


def _dot_transpose_rhs(g, x, y_shape, dims):
    """JAX's ``_dot_general_transpose_rhs``."""
    (xc, yc), (xb, yb) = dims
    return _dot_transpose_lhs(g, y_shape, x, ((yc, xc), (yb, xb)),
                              swap_ans=True)


def _mask_like(t: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=t.dtype, device=t.device)


def _twin(custom: Callable, plain: Callable) -> Callable:
    """``custom`` (an unpriced op of ``core.estimator``) while ``make_fx``
    traces, so the capture keeps it whole; else ``plain``, its arithmetic
    without the custom op's dispatch (~0.1 ms a call, tens of thousands
    a step in the sLSTM's token loop). The same values either way."""
    def call(*args):
        return (custom if get_proxy_mode() is not None else plain)(*args)
    return call


def _silu_vjp_plain(g, x):
    sig = torch.sigmoid(x)
    return g * sig + (x * g) * (sig * (1 - sig))


_add_any = _twin(estimator.add_any, lambda a, b: a + b)
_softplus_vjp = _twin(estimator.softplus_vjp,
                      lambda g, x: g * torch.sigmoid(x))
_silu_vjp = _twin(estimator.silu_vjp, _silu_vjp_plain)
_select_parts = _twin(estimator.select_parts, lambda mask, x, fill: (
    torch.where(mask, x, _mask_like(x, fill)), mask, x.new_zeros(())))
_dynamic_slice = _twin(estimator.dynamic_slice, lambda x, start, size, dim:
                       x.index_select(dim, estimator._window(x, start, size,
                                                             dim)))


class Tape:
    """One linearized (or, ``lin=False``, primal) trace of a function
    spelled in JAX's primitives (module docstring)."""

    def __init__(self, lin: bool = True):
        self.lin = lin
        self._slot: dict[int, int] = {}
        self._keep: list[torch.Tensor] = []   # ids stay unique
        self._ops: list[tuple] = []
        self._n = 0
        self._dead = False

    @contextlib.contextmanager
    def dead(self):
        """Ops inside compute no primal value (a zero-storage placeholder
        of the output's shape stands for it) and only record their linear
        part: the values of a recomputed forward that only its outputs
        read, which JAX's partial evaluation drops (the transposes read
        none of them)."""
        saved, self._dead = self._dead, True
        try:
            yield
        finally:
            self._dead = saved

    def _value(self, fn: Callable, shape: Callable, like: torch.Tensor):
        """``fn()``, or in a ``dead`` block a placeholder of the shape
        ``shape()``."""
        if not self._dead:
            return fn()
        return torch.empty((), dtype=like.dtype, device=like.device).expand(
            *shape())

    # -- bookkeeping ---------------------------------------------------------

    def _mark(self, x: torch.Tensor) -> int:
        s = self._n
        self._n += 1
        self._slot[id(x)] = s
        self._keep.append(x)
        return s

    def slot(self, x) -> int | None:
        """The tangent slot of ``x``, None for a constant."""
        if not isinstance(x, torch.Tensor):
            return None
        return self._slot.get(id(x))

    def var(self, *xs: torch.Tensor):
        """Mark ``xs`` as inputs with tangents; returns them."""
        if self.lin:
            for x in xs:
                if self.slot(x) is None:
                    self._mark(x)
        return xs[0] if len(xs) == 1 else xs

    def _record(self, outs: Sequence[torch.Tensor], ins: Sequence,
                rule: Callable) -> None:
        """Record a linear op: ``rule(cts of outs) -> cts of ins`` (None
        where an input has no tangent). Nothing when no input has one."""
        slots = [self.slot(x) for x in ins]
        if not self.lin or all(s is None for s in slots):
            return
        self._ops.append(([self._mark(o) for o in outs], slots, rule))

    def transpose(self, cts: dict) -> dict:
        """Run the recorded ops' transpose rules, last op first, from the
        cotangents ``cts`` (tensor -> cotangent) of some outputs; returns
        the cotangents of the marked inputs by slot. A cotangent reaching
        a slot twice is summed unpriced (JAX's ``add_any``)."""
        acc: dict[int, torch.Tensor] = {}
        for x, g in cts.items():
            if g is not None and self.slot(x) is not None:
                self._add(acc, self.slot(x), g)
        for outs, slots, rule in reversed(self._ops):
            gs = [acc.pop(o, None) for o in outs]
            if all(g is None for g in gs):
                continue
            for s, c in zip(slots, rule(gs)):
                if s is not None and c is not None:
                    self._add(acc, s, c)
        return acc

    @staticmethod
    def _add(acc: dict, s: int, c: torch.Tensor) -> None:
        acc[s] = _add_any(acc[s], c) if s in acc else c

    def ct_of(self, acc: dict, x: torch.Tensor):
        """The cotangent of the marked input ``x`` in ``transpose``'s
        result, or None."""
        return acc.get(self.slot(x))

    # -- priced ops ----------------------------------------------------------

    def add(self, x, y):
        out = self._value(lambda: x + y, lambda: _bshape(x, y),
                          _like(x, y))
        xs, ys = _shape(x), _shape(y)
        self._record([out], [x, y], lambda g: (
            _unbroadcast(g[0], xs) if xs is not None else None,
            _unbroadcast(g[0], ys) if ys is not None else None))
        return out

    def sub(self, x, y):
        out = self._value(lambda: x - y, lambda: _bshape(x, y),
                          _like(x, y))
        xs, ys = _shape(x), _shape(y)
        self._record([out], [x, y], lambda g: (
            _unbroadcast(g[0], xs) if xs is not None else None,
            _unbroadcast(g[0].neg(), ys) if ys is not None else None))
        return out

    def mul(self, x, y):
        """``x * y``; its transpose emits the second operand's cotangent
        first (``mul(x, g)``), then the first's (``mul(g, y)``)."""
        out = self._value(lambda: x * y, lambda: _bshape(x, y),
                          _like(x, y))
        lx, ly = self.slot(x) is not None, self.slot(y) is not None
        xs, ys = _shape(x), _shape(y)

        def rule(g):
            g = g[0]
            cy = _unbroadcast(x * g, ys) if ly else None
            cx = _unbroadcast(g * y, xs) if lx else None
            return cx, cy

        self._record([out], [x, y], rule)
        return out

    def div(self, x, y):
        """``x / y``; the divisor's cotangent ``-(g·y⁻²)·x`` first, then
        the dividend's ``g / y``."""
        out = self._value(lambda: x / y, lambda: _bshape(x, y),
                          _like(x, y))
        lx, ly = self.slot(x) is not None, self.slot(y) is not None
        xs, ys = _shape(x), _shape(y)
        ym2 = y.pow(-2) if (self.lin and ly) else None

        def rule(g):
            g = g[0]
            cy = _unbroadcast(((g * ym2) * x).neg(), ys) if ly else None
            cx = _unbroadcast(g / y, xs) if lx else None
            return cx, cy

        self._record([out], [x, y], rule)
        return out

    def exp(self, x):
        out = torch.exp(x)
        self._record([out], [x], lambda g: (g[0] * out,))
        return out

    def maximum(self, x, y):
        """``max(x, y)``; linearized, each operand's tie factor
        ``[x == z] / (1 + [y == z])`` (a priced div, JAX's
        ``_balanced_eq``: a tie splits the cotangent in halves), the
        first operand's first; transposed, the second's product first."""
        out = torch.maximum(x, y) if isinstance(y, torch.Tensor) else \
            torch.clamp_min(x, y)
        lx, ly = self.slot(x) is not None, self.slot(y) is not None
        xs, ys = _shape(x), _shape(y)
        cx = cy = None
        if self.lin and lx:
            cx = _balanced_eq(x, out, y)
        if self.lin and ly:
            cy = _balanced_eq(y, out, x)

        def rule(g):
            g = g[0]
            gy = _unbroadcast(g * cy, ys) if ly else None
            gx = _unbroadcast(g * cx, xs) if lx else None
            return gx, gy

        self._record([out], [x, y], rule)
        return out

    def logistic(self, x):
        """``sigmoid(x)``; linearized, its derivative ``y·(1 - y)`` (a
        priced sub and mul)."""
        out = torch.sigmoid(x)
        if self.lin and self.slot(x) is not None:
            coef = out * (1 - out)
            self._record([out], [x], lambda g: (g[0] * coef,))
        return out

    def tanh(self, x):
        """``tanh(x)``; linearized, ``1 - y`` (priced); transposed,
        ``t = g·(1 - y)`` then ``t + t·y``."""
        out = torch.tanh(x)
        if self.lin and self.slot(x) is not None:
            omy = 1 - out

            def rule(g):
                t = g[0] * omy
                return (_add_any(t, t * out),)

            self._record([out], [x], rule)
        return out

    def ipow(self, x, n: int):
        """``x ** n`` (``integer_pow``, unpriced); linearized, its
        coefficient ``n·x^(n-1)`` (a priced mul)."""
        out = x.pow(n)
        if self.lin and self.slot(x) is not None:
            coef = n * x.pow(n - 1)
            self._record([out], [x], lambda g: (g[0] * coef,))
        return out

    def dot(self, x, y, dims):
        """``dot_general(x, y, dims)``; transposed, the second operand's
        cotangent first (a weight's before its input's)."""
        out = self._value(lambda: dot_general(x, y, dims),
                          lambda: _dot_shape(x.shape, y.shape, dims), x)
        lx, ly = self.slot(x) is not None, self.slot(y) is not None
        xs, ys = tuple(x.shape), tuple(y.shape)

        def rule(g):
            g = g[0]
            cy = _dot_transpose_rhs(g, x, ys, dims) if ly else None
            cx = _dot_transpose_lhs(g, xs, y, dims) if lx else None
            return cx, cy

        self._record([out], [x, y], rule)
        return out

    def matmul(self, x, w):
        """``x @ w`` of x [..., K] and w [K, N]."""
        return self.dot(x, w, (([x.dim() - 1], [0]), ([], [])))

    # -- unpriced ops --------------------------------------------------------

    def neg(self, x):
        out = x.neg()
        self._record([out], [x], lambda g: (g[0].neg(),))
        return out

    def reshape(self, x, *shape):
        out = x.reshape(*shape)
        xs = x.shape
        self._record([out], [x], lambda g: (g[0].reshape(xs),))
        return out

    def permute(self, x, *perm):
        out = x.permute(*perm)
        inv = [int(a) for a in np.argsort(perm)]
        self._record([out], [x], lambda g: (g[0].permute(*inv),))
        return out

    def expand(self, x, *shape):
        out = x.expand(*shape)
        xs = tuple(x.shape)
        self._record([out], [x], lambda g: (_unbroadcast(g[0], xs),))
        return out

    def slice(self, x, dim: int, start: int, stop: int, step: int = 1):
        """``x[start:stop:step]`` along ``dim`` (``lax.slice``); its
        transpose scatters the cotangent into zeros (``slice_scatter``)."""
        dim %= x.dim()
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        out = x[tuple(idx)]
        xs = tuple(x.shape)
        stop = min(stop, xs[dim])
        self._record([out], [x], lambda g: (torch.slice_scatter(
            g[0].new_zeros(xs), g[0], dim, start, stop, step),))
        return out

    def pad(self, x, dim: int, lo: int, hi: int, interior: int = 0):
        """``lax.pad`` of ``x`` along ``dim`` with zeros: ``lo`` before,
        ``hi`` after, ``interior`` (0 or 1) between elements; built from
        ``x`` by stacking and concatenating (its result reads ``x``)."""
        dim %= x.dim()
        n = x.shape[dim]
        if interior:
            z = torch.zeros_like(x)
            x2 = torch.stack([x, z], dim + 1).flatten(dim, dim + 1)
            body = x2.narrow(dim, 0, max(2 * n - 1, 0))
        else:
            body = x
        parts = []
        for width in (lo, hi):
            shape = list(x.shape)
            shape[dim] = width
            parts.append(x.new_zeros(shape))
        out = torch.cat([parts[0], body, parts[1]], dim)
        step = interior + 1
        self._record([out], [x], lambda g: (
            g[0].narrow(dim, lo, max(n - 1, 0) * step + 1 if n else 0)
            [(slice(None),) * dim + (slice(None, None, step),)],))
        return out

    def cat(self, xs: Sequence[torch.Tensor], dim: int):
        out = torch.cat(list(xs), dim)
        sizes = [t.shape[dim] for t in xs]
        self._record([out], list(xs), lambda g: tuple(
            torch.split(g[0], sizes, dim)))
        return out

    def where(self, mask: torch.Tensor, x, fill: float):
        """``jnp.where(mask, x, fill)`` of a constant mask: the
        reference's ``_where`` jit; linearized, ``estimator.select_parts``
        (every output drawing edges from both inputs, as the jit's do),
        transposed to the selection of the cotangent."""
        if self.lin and self.slot(x) is not None:
            out, m, zero = _select_parts(mask, x, fill)
            self._record([out], [x], lambda g: (torch.where(m, g[0], zero),))
            return out
        return torch.where(mask, x, _mask_like(x, fill))

    def cumsum(self, x, dim: int):
        out = torch.cumsum(x, dim)
        self._record([out], [x], lambda g: (
            torch.flip(torch.cumsum(torch.flip(g[0], [dim]), dim), [dim]),))
        return out

    def softplus(self, x):
        """``jax.nn.softplus``, a jit the reference's graph does not enter:
        unpriced, its transpose ``estimator.softplus_vjp``."""
        out = F.softplus(x)
        self._record([out], [x], lambda g: (
            _softplus_vjp(g[0], x),))
        return out

    def log_sigmoid(self, f):
        """``-softplus(-f)``: log sigmoid(f)."""
        return self.neg(self.softplus(self.neg(f)))

    def silu(self, x):
        """``jax.nn.silu``, a jit: unpriced, transposed by
        ``estimator.silu_vjp``."""
        out = F.silu(x)
        self._record([out], [x], lambda g: (_silu_vjp(g[0], x),))
        return out

    def abs(self, x):
        """``|x|``; its transpose passes the cotangent at 0, as JAX's
        ``select(x >= 0, g, -g)``."""
        out = torch.abs(x)
        if self.lin and self.slot(x) is not None:
            ge = x >= 0
            self._record([out], [x], lambda g: (
                torch.where(ge, g[0], g[0].neg()),))
        return out

    def astype(self, x, dtype):
        if x.dtype == dtype:
            return x
        out = x.to(dtype)
        src = x.dtype
        self._record([out], [x], lambda g: (g[0].to(src),))
        return out

    def at(self, x, dim: int, index: torch.Tensor):
        """``x[..., index, ...]`` along ``dim`` at a traced 0-d index, one
        normalized already (the reference's ``-1``: ``last_index``), as a
        ``dynamic_slice`` and a squeeze."""
        xs = tuple(x.shape)
        out = self._value(
            lambda: _dynamic_slice(x, index, 1, dim).squeeze(dim),
            lambda: xs[:dim % len(xs)] + xs[dim % len(xs) + 1:], x)

        d = dim % len(xs)

        def rule(g):
            # the index is normalized already (the caller's priced add)
            return (torch.index_copy(g[0].new_zeros(xs), d,
                                     index.long().reshape(1),
                                     g[0].unsqueeze(d)),)

        self._record([out], [x], rule)
        return out

    # -- composite ----------------------------------------------------------

    def rms_norm(self, x, scale, eps: float):
        """``layers.rms_norm``: the reference's custom VJP (its forward a
        ``"call"`` region, its transpose ``layers.rms_norm_bwd`` inline)."""
        out = layers.rms_norm_fwd(x, scale, eps)
        self._record([out], [x, scale], lambda g: layers.rms_norm_bwd(
            x, scale, g[0], eps))
        return out

    def custom(self, outs: Sequence[torch.Tensor], ins: Sequence,
               rule: Callable) -> None:
        """Record a linear op of the caller's: ``rule(cts of outs) -> cts
        of ins``."""
        self._record(outs, ins, rule)

    # -- loops ---------------------------------------------------------------

    def loop(self, body: Callable, carry: list, xs: list, consts: list,
             name: str):
        """``lax.scan(body, carry, xs)``: ``body(tape, consts, carry,
        x_slices) -> (carry, ys)``, each iteration one of the ``"scan"``
        region ``name`` (its transpose's ``name + ".T"``), the slices of
        ``xs`` (leading axis the iterations) taken inside. Linearized,
        each iteration's tape is kept and transposed in reverse; primal
        (inside a checkpointed block's forward), the loop runs inside a
        ``"call"`` region, as the reference's primal wraps it. Returns
        (carry, ys stacked)."""
        n = xs[0].shape[0]
        tapes, ys = [], []
        c0 = list(carry)
        ctx = (estimator.region("call", "closed_call") if not self.lin
               else contextlib.nullcontext())
        tracer = _copying_tracer(n)
        with ctx:
            for i in range(1 if tracer is not None else n):
                mark = len(tracer.graph.nodes) if tracer is not None else 0
                with estimator.region("scan", name):
                    t = Tape(self.lin)
                    xi = [x[i] for x in xs]
                    t.var(*consts, *[c for c in carry
                                     if isinstance(c, torch.Tensor)], *xi)
                    ins = (list(carry), xi)
                    carry, y = body(t, consts, carry, xi)
                    tapes.append((t, ins, list(carry), y))
                    ys.append(y)
            if tracer is not None:
                copies = _IterationCopies(tracer, mark, n, xs, xi, c0, carry,
                                        name)
                carry = copies.carry_out()
                ys = [[copies.at(v, i) for v in ys[0]] for i in range(n)]
        out_ys = [torch.stack([y[j] for y in ys]) for j in range(len(ys[0]))]
        if self.lin:
            step = _tape_step(tapes, consts, name)
            if tracer is not None:
                rule = (lambda g: _transpose_copied(
                    copies, g, len(carry), consts, name, step))
            else:
                rule = (lambda g: _transpose_all(step, carry, g, consts, n))
            self._record([*carry, *out_ys], [*consts, *c0, *xs], rule)
        return list(carry), out_ys

    def checkpoint_loop(self, body: Callable, carry: list, xs: list,
                        consts: list, name: str):
        """``lax.scan(jax.checkpoint(body), carry, xs)``: the forward the
        primal body (linearized or not: a checkpointed body saves only its
        inputs), inside ``"call"`` regions where the tape is primal (the
        reference's primal wraps the loop and the body); the transpose, for
        each iteration in reverse, inside a ``"call"`` region, the body
        recomputed linearized from its saved input carry and then
        transposed."""
        n = xs[0].shape[0]
        saved, ys = [], []
        c0 = list(carry)
        outer = (estimator.region("call", "closed_call") if not self.lin
                 else contextlib.nullcontext())
        tracer = _copying_tracer(n)
        with outer:
            for i in range(1 if tracer is not None else n):
                mark = len(tracer.graph.nodes) if tracer is not None else 0
                with estimator.region("scan", name):
                    inner = (estimator.region("call", "remat")
                             if not self.lin else contextlib.nullcontext())
                    with inner:
                        xi = [x[i] for x in xs]
                        saved.append(list(carry))
                        carry, y = body(Tape(False), consts, carry, xi)
                    ys.append(y)
            if tracer is not None:
                copies = _IterationCopies(tracer, mark, n, xs, xi, c0, carry,
                                        name)
                carry = copies.carry_out()
                ys = [[copies.at(v, i) for v in ys[0]] for i in range(n)]
        out_ys = [torch.stack([y[j] for y in ys]) for j in range(len(ys[0]))]
        if self.lin:
            step = _recompute_step(body, saved, consts, xs, name)
            if tracer is not None:
                rule = (lambda g: _transpose_copied(
                    copies, g, len(carry), consts, name, step))
            else:
                rule = (lambda g: _transpose_all(step, carry, g, consts, n))
            self._record([*carry, *out_ys], [*consts, *c0, *xs], rule)
        return list(carry), out_ys


def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else None


def _bshape(x, y) -> tuple:
    return tuple(torch.broadcast_shapes(*[t.shape for t in (x, y)
                                          if isinstance(t, torch.Tensor)]))


def _like(x, y) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else y


def _dot_shape(xs, ys, dims) -> list[int]:
    """The shape of ``dot_general`` of operands shaped ``xs``, ``ys``."""
    (xc, yc), (xb, yb) = dims
    return ([xs[d] for d in (*xb, *_remaining(len(xs), xc, xb))]
            + [ys[d] for d in _remaining(len(ys), yc, yb)])


def _balanced_eq(x, z, y) -> torch.Tensor:
    """JAX's ``_balanced_eq(x, z, y)``: ``[x == z] / (1 + [y == z])``, the
    share of ``max``'s cotangent operand ``x`` takes (a priced div; the
    two selections its operands, as the reference's). Untraced, the same
    values from the comparisons' casts (``torch.where`` of two numbers
    costs ~0.1 ms a call)."""
    if get_proxy_mode() is None:
        num = (x == z).to(z.dtype)
        return num / ((y == z).to(z.dtype) + 1)
    num = torch.where(x == z, 1.0, 0.0).to(z.dtype)
    den = torch.where(y == z, 2.0, 1.0).to(z.dtype)
    return num / den


def _zeros_like(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t)


def _transpose_all(step, final, g, consts, n: int):
    """A loop's transpose, every iteration traced: ``step`` for each
    iteration in reverse, the carry's and the constants' cotangents
    carried from one to the next (from zeros, made before the loop, as
    JAX instantiates them)."""
    k = len(final)
    ct_carry = [c if c is not None else _zeros_like(f)
                for c, f in zip(g[:k], final)]
    ct_consts = [_zeros_like(c) for c in consts]
    ct_xs = [None] * n
    for i in reversed(range(n)):
        ct_carry, ct_consts, ct_xs[i], _ = step(ct_carry, ct_consts, g[k:],
                                                i, i)
    return (*ct_consts, *ct_carry,
            *[torch.stack([c[j] for c in ct_xs]) for j in range(
                len(ct_xs[0]))])


def _acc(a, b):
    return b if a is None else _add_any(a, b)


def _or_zeros(c, like):
    return c if c is not None else _zeros_like(like)


# Tracing a token costs make_fx ~0.1 s (~100 aten ops at ~1 ms each on a
# CPU core), and an sLSTM at seq 512 scans 1,024 of them, forward and
# transposed, in each unit. Every iteration of a loop issues the same ops
# on the same shapes, its index the only difference: so under ``make_fx``
# a ``Tape.loop`` traces its first iteration and copies that iteration's
# nodes for the others, and its transpose traces the last iteration and
# copies it for the others (each copy with its own index, its own regions,
# and its reads of the forward's residuals and carries moved to the
# iteration's own). The graph is the one tracing every iteration gives
# (tests/test_torch_recurrent_train_schedules_full*.py).
COPY_TRACED_ITERATIONS = True


def _copying_tracer(n: int):
    """The tracer ``make_fx`` records into when a loop of ``n``
    iterations should copy its traced iteration, else None."""
    if not COPY_TRACED_ITERATIONS or n < 2:
        return None
    mode = get_proxy_mode()
    return None if mode is None else mode.tracer


def _node_of(t: torch.Tensor, tracer):
    """The graph node of a traced tensor (under ``torch.func``'s
    transforms, of the tensor it wraps)."""
    while is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return get_proxy_slot(t, tracer).proxy.node


def _placeholder(t: torch.Tensor, tracer, node):
    """A new traced tensor standing for the graph node ``node`` (of
    ``t``'s shape and dtype): an ``alias`` of ``t`` rewired to read
    ``node``."""
    out = torch.ops.aten.alias.default(t)
    ph = _node_of(out, tracer)
    ph.args = (node,)
    ph.meta[estimator.STAND_IN_KEY] = True
    return out


def _frame_depth(node, name: str) -> int:
    """The index of the ``"scan"`` frame ``name`` in ``node``'s regions
    (the innermost such frame): the loop iteration a copy renumbers."""
    scope = estimator.scope_of(node)
    return max(i for i, (kind, nm, _) in enumerate(scope)
               if kind == "scan" and nm == name)


def _body_nodes(graph, mark: int) -> list:
    n = len(graph.nodes) - mark
    return list(itertools.islice(reversed(graph.nodes), n))[::-1]


_COPIES = itertools.count()


def _copy_nodes(graph, body: list, depth: int, lookup) -> dict:
    """Append a copy of ``body``'s nodes, each argument mapped through
    the copy's own nodes first, then ``lookup``; each copy's regions from
    ``depth`` on given ids of its own. Returns original -> copy. Each copy
    is named by its original and a tag of the copy's own, a name no node
    has yet (``node_copy`` would search for a free ``<op>_<n>``, a scan
    over every such name in some torch versions)."""
    env: dict = {}
    ids: dict = {}
    tag = f"c{next(_COPIES)}"
    for nd in body:
        arg = lambda a: env.get(a, lookup(a))
        new = graph.create_node(
            nd.op, nd.target, torch.fx.node.map_arg(nd.args, arg),
            torch.fx.node.map_arg(nd.kwargs, arg), f"{nd.name}{tag}",
            nd.type)
        new.meta = copy.copy(nd.meta)
        estimator.set_scope(new, estimator.renumbered(
            estimator.scope_of(nd), depth, ids))
        env[nd] = new
    return env


class _IterationCopies:
    """A traced loop's first iteration copied for the others (module
    note above ``COPY_TRACED_ITERATIONS``): ``env[i]`` maps each node of
    iteration 0 — and each carry input — to iteration ``i``'s."""

    def __init__(self, tracer, mark: int, n: int, xs, xi, c0, c1,
                 name: str):
        graph = tracer.graph
        body = _body_nodes(graph, mark)
        depth = _frame_depth(body[0], name)
        selects = {_node_of(s, tracer): _node_of(x, tracer)
                   for s, x in zip(xi, xs)}
        c_in = [_node_of(c, tracer) for c in c0]
        c_out = [_node_of(c, tracer) for c in c1]
        self.tracer, self.n = tracer, n
        self.env = [{}]
        prev = c_out
        for i in range(1, n):
            carry = dict(zip(c_in, prev))
            env = _copy_nodes(graph, body, depth,
                              lambda a: carry.get(a, a))
            for sel, x in selects.items():
                env[sel].args = (x, 0, i)
            env.update(carry)
            self.env.append(env)
            prev = [env[c] for c in c_out]
        self._c1 = c1

    def at(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Iteration ``i``'s counterpart of iteration 0's traced ``t``."""
        if i == 0:
            return t
        node = _node_of(t, self.tracer)
        return _placeholder(t, self.tracer, self.env[i].get(node, node))

    def carry_out(self) -> list:
        """The last iteration's carry (kept: its cotangents' zeros are
        made like it)."""
        self.final = [self.at(c, self.n - 1) for c in self._c1]
        return self.final


def _tape_step(tapes, consts, name: str):
    """A ``Tape.loop``'s transposed iteration ``i``: iteration ``src``'s
    tape transposed for iteration ``i``'s cotangents (``src`` 0 where the
    forward was copied: its reads of the forward are moved after)."""
    def step(ct_carry, ct_consts, ct_ys, i, src):
        t, (cin, xin), cout, y = tapes[src]
        with estimator.region("scan", name + ".T"):
            cts = dict(zip(cout, ct_carry))
            sels = []
            for j, yj in enumerate(y):
                if ct_ys[j] is not None:
                    sel = ct_ys[j][i]
                    sels.append((sel, ct_ys[j]))
                    cts[yj] = _acc(cts.get(yj), sel)
            acc = t.transpose(cts)
            new_consts = [_add_any(cc, _or_zeros(t.ct_of(acc, c),
                                                          c))
                          for cc, c in zip(ct_consts, consts)]
            carry = [_or_zeros(t.ct_of(acc, c), c) for c in cin]
            ct_x = [_or_zeros(t.ct_of(acc, x), x) for x in xin]
        return carry, new_consts, ct_x, sels

    return step


def _recompute_step(body, saved, consts, xs, name: str):
    """A ``Tape.checkpoint_loop``'s transposed iteration ``i``: the body
    recomputed linearized from iteration ``src``'s saved carry input
    (``src`` 0 where the forward was copied: moved to ``i``'s after) and
    transposed, inside a ``"call"`` region."""
    def step(ct_carry, ct_consts, ct_ys, i, src):
        with estimator.region("scan", name + ".T"), \
                estimator.region("call", "remat"):
            t = Tape(True)
            c0 = saved[src]
            xin = [x[i] for x in xs]
            sels = list(zip(xin, xs))
            t.var(*consts, *[c for c in c0 if isinstance(c, torch.Tensor)],
                  *xin)
            cout, y = body(t, consts, c0, xin, keep=False)
            cts = dict(zip(cout, ct_carry))
            for j, yj in enumerate(y):
                if ct_ys[j] is not None:
                    sel = ct_ys[j][i]
                    sels.append((sel, ct_ys[j]))
                    cts[yj] = _acc(cts.get(yj), sel)
            acc = t.transpose(cts)
            new_consts = [_add_any(cc, _or_zeros(t.ct_of(acc, c),
                                                          c))
                          for cc, c in zip(ct_consts, consts)]
            carry = [_or_zeros(t.ct_of(acc, c), c) for c in c0]
            ct_x = [_or_zeros(t.ct_of(acc, x), x) for x in xin]
        return carry, new_consts, ct_x, sels

    return step


def _transpose_copied(copies: _IterationCopies, g, n_carry: int, consts,
                      name: str, step):
    """A loop's transpose under ``make_fx`` when its forward was copied:
    ``step`` traces the last iteration's transpose, its reads of the
    forward moved to the last iteration's (``copies.env``), then it is
    copied for the others in reverse, each copy's index, loop carries
    (the carry's and the constants' cotangents) and reads of the forward
    its own."""
    tracer, n = copies.tracer, copies.n
    graph = tracer.graph
    ct_carry = [c if c is not None else _zeros_like(o) for c, o in
                zip(g[:n_carry], copies.final)]
    ct_ys = g[n_carry:]
    ct_consts = [_zeros_like(c) for c in consts]
    mark = len(graph.nodes)
    new_carry, new_consts, ct_x, sels = step(ct_carry, ct_consts, ct_ys,
                                             n - 1, 0)
    body = _body_nodes(graph, mark)
    depth = _frame_depth(body[0], name + ".T")
    node = lambda v: _node_of(v, tracer)
    sel_nodes = {node(s): node(c) for s, c in sels}
    loops_in = [node(c) for c in (*ct_carry, *ct_consts)]
    loops_out = [node(c) for c in (*new_carry, *new_consts)]
    x_nodes = [node(c) for c in ct_x]
    per_iteration = {n - 1: x_nodes}
    prev = loops_out
    for i in reversed(range(n - 1)):
        carry = dict(zip(loops_in, prev))
        fwd = copies.env[i]
        env = _copy_nodes(graph, body, depth,
                          lambda a: carry.get(a, fwd.get(a, a)))
        for sel, src in sel_nodes.items():
            env[sel].args = (src, 0, i)
        per_iteration[i] = [env.get(v, v) for v in x_nodes]
        prev = [env.get(v, carry.get(v, v)) for v in loops_out]
    last = copies.env[n - 1]
    for nd in body:
        nd.args = torch.fx.node.map_arg(nd.args, lambda a: last.get(a, a))
        nd.kwargs = torch.fx.node.map_arg(nd.kwargs,
                                          lambda a: last.get(a, a))
    k = len(new_carry)
    outs = [_placeholder(v, tracer, p) for v, p in
            zip((*new_carry, *new_consts), prev)]
    ct_xs = [torch.stack([ct_x[j] if i == n - 1 else
                          _placeholder(ct_x[j], tracer, per_iteration[i][j])
                          for i in range(n)]) for j in range(len(ct_x))]
    return (*outs[k:], *outs[:k], *ct_xs)
