"""PIM MAC and blocked matmul: the port of the reference's K1, K2, K3 and
K5 kernel entries (``repro/kernels/pim_mac.py``).

``pim_matmul_grouped`` (K1) and ``pim_matmul`` (K2) replace the Pallas TPU
kernels ``_matmul_grouped_kernel`` and ``_matmul_kernel`` with one CUDA
kernel body for Hopper written by hand (``csrc/pim_matmul.cu``): K2 is K1
launched with one group, so a grouped launch equals the per-block launches
on the same padded blocks bit for bit. ``pim_matmul_grouped_q`` (K5)
replaces ``_matmul_grouped_q_kernel`` with the same body and a B-tile
loader that dequantizes the stored on-grid values by their column's scale
as it stages them, so K5(a, q, s) equals K1(a, q * s) bit for bit.
``pim_mac`` (K3) replaces
``_mac_kernel`` with ``csrc/pim_mac.cu``: ``acc + a*b`` with two
roundings. ``pim_mac_grouped`` has no kernel of its own: it concatenates
a ragged wave of triples into one K3 launch, as the reference's wrapper
does. Each kernel source states its bound and design.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in ``ref`` — the analogue of the
reference's interpret mode. ``launches`` counts each kernel's launches,
forward and backward.

Differentiable, as the reference's custom VJPs: given an input that
requires grad, a wrapper runs its kernel inside a
``torch.autograd.Function`` whose backward launches the same kernel with
the reference's formulas — K1: ``dA = K1(g, Bᵀ)`` (segment-summed over
the column groups of a shared A) and ``dB = K1(Aᵀ, g, col_groups)``; K2:
``dA = K2(g, Bᵀ)``, ``dB = K2(Aᵀ, g)``; K5: ``dA = K1(g, (q·s)ᵀ)``
(``q·s`` formed once; segment-summed as K1's), ``dq = K1(Aᵀ, g,
col_groups) · s`` and ``ds = 0`` (scales are placement constants); K3:
``da = K3(g, b, 0)``, ``db = K3(g, a, 0)``, ``dacc = g``. A cotangent
nobody asked for (``ctx.needs_input_grad``) launches nothing. The transposed operands are
made contiguous before the launch, as the reference's ``swapaxes``
materializes them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# csrc pim_matmul_grouped(a, b, c, G, col_groups, M, K, N, stream)
_MM_GROUPED_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)
# csrc pim_matmul_grouped_q(a, q, s, c, G, col_groups, M, K, N, stream)
_MM_GROUPED_Q_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)
# csrc pim_matmul(a, b, c, M, K, N, stream)
_MM_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
# csrc pim_mac(a, b, acc, out, n, stream)
_MAC_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,
                                          ctypes.c_void_p)
TILE_MN = 128       # csrc kBM, kBN: M and N are multiples of this
TILE_K = 8          # csrc kBK: K is a multiple of this


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


def _common(name: str, *tensors: torch.Tensor) -> str:
    """Checks every wrapper makes; returns the device type."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype} operand, want float32")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    if dev.type == "cuda":
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{name}: operands must be contiguous")
    return dev.type


def _check_tiles(name: str, m: int, k: int, n: int, bm: int, bn: int,
                 bk: int, device: str) -> None:
    if m % bm or n % bn or k % bk:
        raise ValueError(f"{name}: (M, K, N) = ({m}, {k}, {n}) must be "
                         f"multiples of (bm, bk, bn) = ({bm}, {bk}, {bn})")
    if device == "cuda" and (m % TILE_MN or n % TILE_MN or k % TILE_K
                             or not k):
        raise ValueError(f"{name}: the kernel tiles M and N by {TILE_MN} "
                         f"and K by {TILE_K}; got ({m}, {k}, {n})")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")


def pim_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
               bn: int = 128, bk: int = 128) -> torch.Tensor:
    """float32 ``C = A @ B`` over (bm, bn, bk) tiles: A [M, K], B [K, N],
    M, N, K multiples of bm, bn, bk. The per-block oracle's product.
    Differentiable (module docstring)."""
    if _wants_grad(a, b):
        return _Matmul.apply(a, b, bm, bn, bk)
    return _matmul(a, b, bm, bn, bk)


pim_matmul.launches = 0


def _matmul(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
            bk: int) -> torch.Tensor:
    """One K2 launch (its plain version on the CPU)."""
    dev = _common("pim_matmul", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"pim_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    _check_tiles("pim_matmul", m, k, n, bm, bn, bk, dev)
    if dev == "cpu":
        return ref.pim_matmul_ref(a, b, bk=bk)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    kernel = build.load("pim_matmul", _MM_ARGTYPES)
    with torch.cuda.device(a.device):
        rc = kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
                    torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "pim_matmul")
    pim_matmul.launches += 1
    return out


class _Matmul(torch.autograd.Function):
    """K2 with the reference's VJP: g is (m, n), so the cotangents' tiles
    are (bm, bk, bn) for dA and (bk, bn, bm) for dB."""

    @staticmethod
    def forward(ctx, a, b, bm, bn, bk):
        ctx.save_for_backward(a, b)
        ctx.tiles = (bm, bn, bk)
        return _matmul(a, b, bm, bn, bk)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        bm, bn, bk = ctx.tiles
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _matmul(g, b.T.contiguous(), bm, bk, bn)
        if ctx.needs_input_grad[1]:
            db = _matmul(a.T.contiguous(), g, bk, bn, bm)
        return da, db, None, None, None


def pim_matmul_grouped(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                       bn: int = 128, bk: int = 128,
                       col_groups: int = 1) -> torch.Tensor:
    """float32 ``C[g] = A[g // col_groups] @ B[g]`` for a stack of G =
    len(B) placed blocks in ONE launch: A [G / col_groups, M, K], B [G, K,
    N], C [G, M, N]. ``col_groups`` is the shared-A mode: a placed node's
    column blocks all consume one activation slab, never copied. Each
    group's result equals :func:`pim_matmul` on the same operands bit for
    bit. Differentiable (module docstring)."""
    if _wants_grad(a, b):
        return _MatmulGrouped.apply(a, b, bm, bn, bk, col_groups)
    return _matmul_grouped(a, b, bm, bn, bk, col_groups)


pim_matmul_grouped.launches = 0


def _matmul_grouped(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
                    bk: int, col_groups: int) -> torch.Tensor:
    """One K1 launch (its plain version on the CPU)."""
    dev = _common("pim_matmul_grouped", a, b)
    if (a.dim() != 3 or b.dim() != 3 or col_groups < 1
            or b.shape[0] != a.shape[0] * col_groups
            or a.shape[2] != b.shape[1]):
        raise ValueError(f"pim_matmul_grouped: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} with col_groups={col_groups}")
    g, k, n = b.shape
    m = a.shape[1]
    _check_tiles("pim_matmul_grouped", m, k, n, bm, bn, bk, dev)
    if dev == "cpu":
        return ref.pim_matmul_grouped_ref(a, b, col_groups=col_groups, bk=bk)
    out = torch.empty((g, m, n), dtype=torch.float32, device=a.device)
    kernel = build.load("pim_matmul_grouped", _MM_GROUPED_ARGTYPES,
                        source="pim_matmul")
    with torch.cuda.device(a.device):
        rc = kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), g,
                    col_groups, m, k, n,
                    torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "pim_matmul_grouped")
    pim_matmul_grouped.launches += 1
    return out


class _MatmulGrouped(torch.autograd.Function):
    """K1 with the reference's VJP: one grouped launch per cotangent; dA
    of a shared A is segment-summed over its column groups."""

    @staticmethod
    def forward(ctx, a, b, bm, bn, bk, col_groups):
        ctx.save_for_backward(a, b)
        ctx.tiles = (bm, bn, bk, col_groups)
        return _matmul_grouped(a, b, bm, bn, bk, col_groups)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        bm, bn, bk, col_groups = ctx.tiles
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _matmul_grouped(g, b.transpose(1, 2).contiguous(), bm, bk,
                                 bn, 1)
            if col_groups > 1:
                da = da.reshape(a.shape[0], col_groups,
                                *da.shape[1:]).sum(1)
        if ctx.needs_input_grad[1]:
            db = _matmul_grouped(a.transpose(1, 2).contiguous(), g, bk, bn,
                                 bm, col_groups)
        return da, db, None, None, None, None


def pim_matmul_grouped_q(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                         *, bm: int = 128, bn: int = 128, bk: int = 128,
                         col_groups: int = 1) -> torch.Tensor:
    """:func:`pim_matmul_grouped` over quantized stored weights: float32
    ``C[g] = A[g // col_groups] @ (Q[g] * S[g])`` in ONE launch. ``Q`` [G,
    K, N] holds each placed block's on-grid weight values (float32, from
    ``core.quant.quantize_axis``), ``S`` [G, 1, N] the per-(group, output
    column) scale, applied on load. Equals :func:`pim_matmul_grouped` on
    ``q * s`` bit for bit. Differentiable (module docstring)."""
    if _wants_grad(a, q, s):
        return _MatmulGroupedQ.apply(a, q, s, bm, bn, bk, col_groups)
    return _matmul_grouped_q(a, q, s, bm, bn, bk, col_groups)


pim_matmul_grouped_q.launches = 0


def _matmul_grouped_q(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      bm: int, bn: int, bk: int,
                      col_groups: int) -> torch.Tensor:
    """One K5 launch (its plain version on the CPU)."""
    dev = _common("pim_matmul_grouped_q", a, q, s)
    if (a.dim() != 3 or q.dim() != 3 or col_groups < 1
            or q.shape[0] != a.shape[0] * col_groups
            or a.shape[2] != q.shape[1]
            or tuple(s.shape) != (q.shape[0], 1, q.shape[2])):
        raise ValueError(f"pim_matmul_grouped_q: shapes {tuple(a.shape)} @ "
                         f"{tuple(q.shape)} * {tuple(s.shape)} with "
                         f"col_groups={col_groups}")
    g, k, n = q.shape
    m = a.shape[1]
    _check_tiles("pim_matmul_grouped_q", m, k, n, bm, bn, bk, dev)
    if dev == "cpu":
        return ref.pim_matmul_grouped_q_ref(a, q, s, col_groups=col_groups,
                                            bk=bk)
    out = torch.empty((g, m, n), dtype=torch.float32, device=a.device)
    kernel = build.load("pim_matmul_grouped_q", _MM_GROUPED_Q_ARGTYPES,
                        source="pim_matmul")
    with torch.cuda.device(a.device):
        rc = kernel(a.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                    g, col_groups, m, k, n,
                    torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "pim_matmul_grouped_q")
    pim_matmul_grouped_q.launches += 1
    return out


class _MatmulGroupedQ(torch.autograd.Function):
    """K5 with the reference's VJP: float32 cotangents against the
    dequantized weights — dA = K1(g, (q·s)ᵀ), segment-summed over a
    shared A's column groups, and dq = K1(Aᵀ, g, col_groups) · s, which
    ``quantize_ste``'s ``dw = dq / s`` turns into exactly ``Aᵀg``; ds =
    0."""

    @staticmethod
    def forward(ctx, a, q, s, bm, bn, bk, col_groups):
        ctx.save_for_backward(a, q, s)
        ctx.tiles = (bm, bn, bk, col_groups)
        return _matmul_grouped_q(a, q, s, bm, bn, bk, col_groups)

    @staticmethod
    def backward(ctx, g):
        a, q, s = ctx.saved_tensors
        bm, bn, bk, col_groups = ctx.tiles
        g = g.contiguous()
        da = dq = ds = None
        if ctx.needs_input_grad[0]:
            bt = (q * s).transpose(1, 2).contiguous()
            da = _matmul_grouped(g, bt, bm, bk, bn, 1)
            if col_groups > 1:
                da = da.reshape(a.shape[0], col_groups,
                                *da.shape[1:]).sum(1)
        if ctx.needs_input_grad[1]:
            dq = _matmul_grouped(a.transpose(1, 2).contiguous(), g, bk, bn,
                                 bm, col_groups) * s
        if ctx.needs_input_grad[2]:
            ds = torch.zeros_like(s)
        return da, dq, ds, None, None, None, None


def pim_mac(a: torch.Tensor, b: torch.Tensor,
            acc: torch.Tensor) -> torch.Tensor:
    """Elementwise float32 ``acc + a*b``, rounded twice (the product, then
    the sum); operands of one shape. Differentiable (module docstring)."""
    if _wants_grad(a, b, acc):
        return _Mac.apply(a, b, acc)
    return _mac(a, b, acc)


pim_mac.launches = 0


def _mac(a: torch.Tensor, b: torch.Tensor,
         acc: torch.Tensor) -> torch.Tensor:
    """One K3 launch (its plain version on the CPU)."""
    dev = _common("pim_mac", a, b, acc)
    if not a.shape == b.shape == acc.shape:
        raise ValueError(f"pim_mac: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(acc.shape)} differ")
    if dev == "cpu":
        return ref.pim_mac_ref(a, b, acc)
    out = torch.empty_like(acc)
    if not out.numel():
        return out
    kernel = build.load("pim_mac", _MAC_ARGTYPES)
    with torch.cuda.device(a.device):
        rc = kernel(a.data_ptr(), b.data_ptr(), acc.data_ptr(),
                    out.data_ptr(), out.numel(),
                    torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "pim_mac")
    pim_mac.launches += 1
    return out


class _Mac(torch.autograd.Function):
    """K3 with the reference's VJP: da and db are MACs into zero, dacc
    passes through."""

    @staticmethod
    def forward(ctx, a, b, acc):
        ctx.save_for_backward(a, b)
        return _mac(a, b, acc)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        need_a, need_b, need_acc = ctx.needs_input_grad
        zero = torch.zeros_like(g) if need_a or need_b else None
        da = _mac(g, b, zero) if need_a else None
        db = _mac(g, a, zero) if need_b else None
        return da, db, g if need_acc else None


def pim_mac_grouped(triples) -> list[torch.Tensor]:
    """One K3 launch for a *wave* of independent eltwise MACs.

    ``triples`` is a sequence of ``(a, b, acc)`` triples of arbitrary
    (ragged) shapes; each contributes ``acc + a*b``. Operands are flattened
    and concatenated so the whole wave rides a single :func:`pim_mac`
    launch; returns the per-triple outputs in order, reshaped back.
    Differentiable: the concatenation and the split are torch ops and the
    MAC carries the VJP, so the wave's backward is one K3 launch per
    cotangent.
    """
    triples = list(triples)
    if not triples:
        raise ValueError("pim_mac_grouped needs at least one (a, b, acc) "
                         "triple")
    if len(triples) == 1:
        return [pim_mac(*triples[0])]
    for a, b, acc in triples:
        if not a.shape == b.shape == acc.shape:
            raise ValueError(f"pim_mac_grouped: shapes {tuple(a.shape)}, "
                             f"{tuple(b.shape)}, {tuple(acc.shape)} differ")
    flat = pim_mac(*(torch.cat([t[i].reshape(-1) for t in triples])
                     for i in range(3)))
    sizes = [a.numel() for a, _, _ in triples]
    return [part.reshape(a.shape)
            for part, (a, _, _) in zip(torch.split(flat, sizes), triples)]
