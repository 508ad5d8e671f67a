"""PIM MAC and blocked matmul: the port of the reference's K1, K2, K3 and
K5 kernel entries (``repro/kernels/pim_mac.py``).

``pim_matmul_grouped`` (K1) and ``pim_matmul`` (K2) replace the Pallas TPU
kernels ``_matmul_grouped_kernel`` and ``_matmul_kernel`` with one CUDA
kernel body for Hopper written by hand (``csrc/pim_matmul.cu``): K2 is K1
launched with one group. ``pim_matmul_grouped_q`` (K5) replaces
``_matmul_grouped_q_kernel`` with the same body and a B stage that is
dequantized by its column's scale once it has landed, so K5(a, q, s)
equals K1(a, q * s) bit for bit. ``pim_mac`` (K3) replaces
``_mac_kernel`` with ``csrc/pim_mac.cu``: ``acc + a*b`` with two
roundings. ``pim_mac_grouped`` has no kernel of its own: it concatenates
a ragged wave of triples into one K3 launch, as the reference's wrapper
does. Each kernel source states its bound and design.

Split-K. A product whose output tiles cannot fill the card splits its K
into ``split_k(M, K, N)`` contiguous chunks of whole 128-deep tiles; each
chunk is an ascending ``fmaf`` chain from zero, and the chunk sums are
added in ascending chunk order (a second pass over a workspace this
module allocates; no float atomics, so a launch is bit-reproducible).
``split_k`` is the policy's one place and a function of the per-block
(M, K, N) alone, never of G, ``col_groups`` or the device: so a grouped
launch equals the per-block launches on the same padded blocks bit for
bit (the compiled program equals the per-block executor), and K5(a, q, s)
equals K1(a, q * s). It is 1 whenever K <= 256 — every forward and dA
launch of the mapper's paths, whose arithmetic is then one chain over all
of K. Above that, chunks take max(2, ceil(K/128 x T / 264)) tiles for T =
(M/128)(N/128) output tiles: at most about 264 blocks a group (two per SM
of a 132-SM card, a constant here), each chunk at least 256 deep. The
bound is operations on the padded work: conv1's dB at batch 256 (M 128,
K 147456, N 128; 4.83 GFLOP, 0.072 ms at 67 TFLOP/s) splits into 231
chunks of 640 (231 blocks), conv2's (M 256, K 16384) into 64 of 256 (128
blocks).

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in ``ref`` — the analogue of the
reference's interpret mode. ``launches`` counts each kernel's launches,
forward and backward (a split launch is one, its sum pass included).

Differentiable, as the reference's custom VJPs: given an input that
requires grad, a wrapper runs its kernel inside a
``torch.autograd.Function`` whose backward launches the same kernel with
the reference's formulas — K1: ``dA = K1(g, Bᵀ)`` (segment-summed over
the column groups of a shared A) and ``dB = K1(Aᵀ, g, col_groups)``; K2:
``dA = K2(g, Bᵀ)``, ``dB = K2(Aᵀ, g)``; K5: ``dA = K1(g, (q·s)ᵀ)``
(``q·s`` formed once; segment-summed as K1's), ``dq = K1(Aᵀ, g,
col_groups) · s`` and ``ds = 0`` (scales are placement constants); K3:
``da = K3(g, b, 0)``, ``db = K3(g, a, 0)``, ``dacc = g``. A cotangent
nobody asked for (``ctx.needs_input_grad``) launches nothing. On the card
``Aᵀ`` is read in place by the kernel's transposed-A loader (the same
bits as a launch on the materialized transpose); ``Bᵀ`` and, on the CPU,
``Aᵀ`` are made contiguous before the launch, as the reference's
``swapaxes`` materializes them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# csrc pim_matmul_grouped(a, b, c, ws, G, col_groups, M, K, N, splits,
# k_chunk, trans_a, stream)
_MM_GROUPED_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (
    ctypes.c_void_p,)
# csrc pim_matmul_grouped_q(a, q, s, c, ws, G, col_groups, M, K, N, splits,
# k_chunk, stream)
_MM_GROUPED_Q_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (
    ctypes.c_void_p,)
# csrc pim_matmul(a, b, c, ws, M, K, N, splits, k_chunk, trans_a, stream)
_MM_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p,)
# csrc pim_mac(a, b, acc, out, n, stream)
_MAC_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,
                                          ctypes.c_void_p)
TILE_MN = 128       # csrc kBM, kBN: M and N are multiples of this
TILE_K = 8          # csrc kBK: K is a multiple of this
SPLIT_TILE = 128    # csrc kChunkTile: a split chunk is whole tiles of this
SPLIT_MIN_K = 256   # no split at or below this K
SPLIT_MIN_TILES = 2     # a split chunk is at least this many tiles deep
SPLIT_BLOCKS = 264      # blocks a split group aims at, at most


def _ceil(x: int, y: int) -> int:
    return -(-x // y)


def split_k(m: int, k: int, n: int) -> int:
    """The number S of K chunks a launch of per-block shape (M, K, N)
    splits its contraction into (module docstring): 1 for K <= 256, else
    chunks of max(2, ceil(K/128 x T / 264)) 128-deep tiles for T =
    (M/128)(N/128) output tiles. A function of (M, K, N) alone, so every
    launch of one block shape sums in one order."""
    if k <= SPLIT_MIN_K:
        return 1
    tiles = max(1, m // TILE_MN) * max(1, n // TILE_MN)
    k_tiles = _ceil(k, SPLIT_TILE)
    depth = max(SPLIT_MIN_TILES, _ceil(k_tiles * tiles, SPLIT_BLOCKS))
    return _ceil(k_tiles, depth)


def chunk_depth(k: int, splits: int) -> int:
    """The depth of each of ``splits`` chunks of a K-deep contraction (the
    last may be shorter): all of K for one chunk, else whole 128-deep
    tiles. For ``splits = split_k(m, k, n)`` the chunks cover K exactly and
    none is empty."""
    if splits == 1:
        return k
    return SPLIT_TILE * _ceil(_ceil(k, SPLIT_TILE), splits)


def _split(g: int, m: int, k: int, n: int, device) -> tuple:
    """(splits, chunk depth, workspace) of one launch: the workspace [S, G,
    M, N] holds the chunks' partial products (none for one chunk)."""
    splits = split_k(m, k, n)
    if splits == 1:
        return 1, k, None
    ws = torch.empty((splits, g, m, n), dtype=torch.float32, device=device)
    return splits, chunk_depth(k, splits), ws


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


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


def _matmul(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
            trans_a: bool = False) -> torch.Tensor:
    """One K2 launch (its plain version on the CPU). ``trans_a``: ``a`` is
    [K, M] and the product is ``aᵀ @ b``, read in place on the card."""
    dev = _common("pim_matmul", a, b)
    lhs = a.mT if trans_a else a        # a view: the product's left operand
    if lhs.dim() != 2 or b.dim() != 2 or lhs.shape[1] != b.shape[0]:
        raise ValueError(f"pim_matmul: shapes {tuple(lhs.shape)} @ "
                         f"{tuple(b.shape)}")
    (m, k), n = lhs.shape, b.shape[1]
    _check_tiles("pim_matmul", m, k, n, bm, bn, bk, dev)
    if dev == "cpu":
        return ref.pim_matmul_ref(lhs.contiguous() if trans_a else a, b,
                                  bk=bk)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    splits, depth, ws = _split(1, m, k, n, a.device)
    kernel = build.load("pim_matmul", _MM_ARGTYPES)
    with torch.cuda.device(a.device):
        rc = kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(ws),
                    m, k, n, splits, depth, int(trans_a),
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
            db = _matmul(a, g, bk, bn, bm, trans_a=True)
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
                    bk: int, col_groups: int,
                    trans_a: bool = False) -> torch.Tensor:
    """One K1 launch (its plain version on the CPU). ``trans_a``: ``a`` is
    [G / col_groups, K, M] and each group's product is ``aᵀ @ b``, read in
    place on the card."""
    dev = _common("pim_matmul_grouped", a, b)
    lhs = a.mT if trans_a else a        # a view: the products' left operands
    if (lhs.dim() != 3 or b.dim() != 3 or col_groups < 1
            or b.shape[0] != lhs.shape[0] * col_groups
            or lhs.shape[2] != b.shape[1]):
        raise ValueError(f"pim_matmul_grouped: shapes {tuple(lhs.shape)} @ "
                         f"{tuple(b.shape)} with col_groups={col_groups}")
    g, k, n = b.shape
    m = lhs.shape[1]
    _check_tiles("pim_matmul_grouped", m, k, n, bm, bn, bk, dev)
    if dev == "cpu":
        return ref.pim_matmul_grouped_ref(
            lhs.contiguous() if trans_a else a, b, col_groups=col_groups,
            bk=bk)
    out = torch.empty((g, m, n), dtype=torch.float32, device=a.device)
    splits, depth, ws = _split(g, m, k, n, a.device)
    kernel = build.load("pim_matmul_grouped", _MM_GROUPED_ARGTYPES,
                        source="pim_matmul")
    with torch.cuda.device(a.device):
        rc = kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(ws), g,
                    col_groups, m, k, n, splits, depth, int(trans_a),
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
            db = _matmul_grouped(a, g, bk, bn, bm, col_groups, trans_a=True)
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
    splits, depth, ws = _split(g, m, k, n, a.device)
    kernel = build.load("pim_matmul_grouped_q", _MM_GROUPED_Q_ARGTYPES,
                        source="pim_matmul")
    with torch.cuda.device(a.device):
        rc = kernel(a.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                    _ptr(ws), g, col_groups, m, k, n, splits, depth,
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
            dq = _matmul_grouped(a, g, bk, bn, bm, col_groups,
                                 trans_a=True) * s
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
