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
roundings, over a whole ragged wave in one launch (``mac_wave``). Where
the reference's wrapper broadcasts, fills and concatenates a wave's
operands inside its jit, K3 reads each member's operands where they lie
— a tensor through its strides, a number as a float32 immediate — and
writes each output into one allocation (a member of ``OWN_ALLOCATION``
elements or more into one of its own); ``pim_mac``, ``pim_mac_grouped``
and the mapper's eltwise lowering all launch through it. Each kernel
source states its bound and design.

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
``da = K3(g, b, 0)``, ``db = K3(g, a, 0)`` (one wave each, the zero an
immediate), ``dacc = g``, each summed to a broadcast operand's shape. A
cotangent nobody asked for (``ctx.needs_input_grad``) launches nothing.
On the card
``Aᵀ`` is read in place by the kernel's transposed-A loader (the same
bits as a launch on the materialized transpose); ``Bᵀ`` and, on the CPU,
``Aᵀ`` are made contiguous before the launch, as the reference's
``swapaxes`` materializes them.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
import struct
from typing import Any, NamedTuple

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


# ---------------------------------------------------------------------------
# K3: the elementwise MAC over a wave of members
# ---------------------------------------------------------------------------


class MacMember(NamedTuple):
    """One member of a K3 wave: ``acc + a*b`` over ``shape``. ``a``, ``b``
    and ``acc`` are each a float32 tensor broadcastable to ``shape``, read
    where it lies, or a Python number, read as a float32 immediate.
    ``stride``: the layout the output is written in, a dense layout of
    ``shape`` (None, or one that is not dense: contiguous)."""

    shape: tuple
    a: Any
    b: Any
    acc: Any
    stride: tuple | None = None


def pim_mac(a: torch.Tensor, b: torch.Tensor,
            acc: torch.Tensor) -> torch.Tensor:
    """Elementwise float32 ``acc + a*b``, rounded twice (the product, then
    the sum); operands of one shape. Differentiable (module docstring)."""
    _same_shape("pim_mac", (a, b, acc))
    return mac_wave([MacMember(tuple(acc.shape), a, b, acc)])[0]


pim_mac.launches = 0
# operands copied before a launch because their strides do not collapse
# into MAC_DIMS dims (none on the LeNet-5 paths)
pim_mac.materialized = 0


def pim_mac_grouped(triples) -> list[torch.Tensor]:
    """One K3 launch for a *wave* of independent eltwise MACs.

    ``triples`` is a sequence of ``(a, b, acc)`` triples of arbitrary
    (ragged) shapes, each of one shape; each contributes ``acc + a*b``.
    The kernel reads every triple where it lies and writes each output
    into one allocation, so the wave is one launch with no concatenation
    or split around it; returns the per-triple outputs in order.
    Differentiable: the wave's backward is one K3 launch per cotangent.
    """
    triples = list(triples)
    if not triples:
        raise ValueError("pim_mac_grouped needs at least one (a, b, acc) "
                         "triple")
    for t in triples:
        _same_shape("pim_mac_grouped", t)
    return mac_wave([MacMember(tuple(acc.shape), a, b, acc)
                     for a, b, acc in triples], "pim_mac_grouped")


def _same_shape(name: str, triple) -> None:
    a, b, acc = triple
    if not a.shape == b.shape == acc.shape:
        raise ValueError(f"{name}: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(acc.shape)} differ")


def mac_wave(members, name: str = "pim_mac") -> list[torch.Tensor]:
    """K3 over a wave of :class:`MacMember` in ONE launch (its plain
    version on the CPU): each member's ``acc + a*b`` over its shape, the
    outputs in order. Numbers are rounded to float32 once (as
    ``torch.as_tensor(x, dtype=torch.float32)`` rounds them); a CPU 0-d
    tensor in a wave on the card is read as a number. Any number of
    members, one launch: up to ``MAC_MAX_MEMBERS`` the table is the
    kernel's parameter, above it a copy in device memory
    (``_launch_table``). Differentiable (``_MacWave``)."""
    members = [m if type(m) is MacMember else MacMember(*m)
               for m in members]
    if not members:
        raise ValueError(f"{name} needs at least one member")
    key, grad = _signature(members)
    if grad and torch.is_grad_enabled():
        members = _normalized(members, name)
        tensors = [x for m in members for x in m[1:4]
                   if isinstance(x, torch.Tensor)]
        slot = itertools.count()
        spec = [MacMember(m.shape, *(next(slot) if isinstance(x, torch.Tensor)
                                     else x for x in m[1:4]), m.stride)
                for m in members]
        return list(_MacWave.apply(spec, *tensors))
    return _mac(members, name, key)


MAC_DIMS = 4              # csrc kDims: a member's collapsed dims
# a member of this many elements or more gets an output allocation of its
# own, not a view of the wave's one allocation: each output is freed when
# its last reader is done (a wave of AdamW's first products at llama3-8b's
# full width is 23.8 GB, its members read at different times)
OWN_ALLOCATION = 1 << 20
MAC_BLOCK = 2048          # csrc kBlockElems: the elements a block takes
MAC_MAX_MEMBERS = 178     # csrc kMaxMembers: the most members a table
                          # passed by value (32,764 bytes) holds; a larger
                          # wave's table goes through device memory
# csrc member flags: bit r set, operand r is dense (a flat member's
# pointer with stride 1; a pointer without it reads one value)
_FLAG_STRIDED, _FLAG_VEC, _FLAG_WIDE = 8, 16, 32
# csrc struct Member, 184 bytes: out, ptr[3] (null: an immediate), n,
# stride[3][4], size[4], magic[3], imm[3], first_block, shift[3], flags
_MEMBER = struct.Struct("<4Qq12q4I3I3fi3BB")
_MEMBER_BYTES = 184
_FLAGS_AT = 183
_FLAG_BYTE = struct.Struct("<B")
_ADDRESSES = struct.Struct("<4Q")       # out, ptr[3]: what a call fills in
# the layout csrc reports (pim_mac_layout 0-3)
_MAC_LAYOUT = (_MEMBER_BYTES, MAC_MAX_MEMBERS, MAC_BLOCK, 176)
# csrc pim_mac_wave(table, members, blocks, stream)
_MAC_WAVE_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p)
# csrc pim_mac_wave_table(table, device_table, members, blocks, stream)
_MAC_TABLE_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p)


def _f32(x) -> float:
    """``x`` rounded to float32 (to nearest), as a Python float."""
    return ctypes.c_float(x).value


def _wave_device(members) -> torch.device:
    """The device a wave runs on: its tensor operands'; a CPU 0-d tensor
    goes with any device (it is read as a number)."""
    dev = None
    for m in members:
        for x in m[1:4]:
            if isinstance(x, torch.Tensor):
                if x.dim() or not x.is_cpu:
                    return x.device
                dev = x.device
    if dev is None:
        raise ValueError("pim_mac: a wave needs a tensor operand")
    return dev


def _operand(x, shape: tuple, device: torch.device, name: str):
    """A member's operand as K3 reads it: a float32 tensor on the wave's
    device, broadcastable to ``shape``, or a float32-rounded number."""
    if isinstance(x, torch.Tensor):
        if x.dtype is not torch.float32:
            raise TypeError(f"{name}: {x.dtype} operand, want float32")
        if x.device != device:
            if (x.dim() or not x.is_cpu
                    or (x.requires_grad and torch.is_grad_enabled())):
                raise ValueError(f"{name}: operands on {x.device} and "
                                 f"{device}")
            return _f32(x.item())
        xs = x.shape
        if xs != shape and (len(xs) > len(shape) or any(
                s != 1 and s != t for s, t in zip(reversed(xs),
                                                  reversed(shape)))):
            raise ValueError(f"{name}: operand of shape {tuple(xs)} does "
                             f"not broadcast to {shape}")
        return x
    if isinstance(x, (bool, int, float)):
        return _f32(x)
    raise TypeError(f"{name}: {type(x).__name__} operand")


def _normalized(members, name: str) -> list[MacMember]:
    """The members with every operand as K3 reads it (``_operand``),
    checked once each."""
    members = [m if type(m) is MacMember else MacMember(*m)
               for m in members]
    device = _wave_device(members)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{device}")
    out = []
    for m in members:
        shape = tuple(m.shape)
        a = _operand(m.a, shape, device, name)
        b = _operand(m.b, shape, device, name)
        acc = _operand(m.acc, shape, device, name)
        if not (isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor)
                or isinstance(acc, torch.Tensor)):
            raise ValueError(f"{name}: a member needs a tensor operand on "
                             f"{device}")
        out.append(m if (a is m.a and b is m.b and acc is m.acc
                         and shape is m.shape)
                   else MacMember(shape, a, b, acc, m.stride))
    return out


class _MacWave(torch.autograd.Function):
    """K3 over a wave with the reference's VJP, one launch per cotangent
    asked: ``da = g*b + 0`` for every member whose ``a`` wants one, in one
    wave, ``db = g*a + 0`` likewise (the zero an immediate), and ``dacc =
    g``; each reduced to its operand's shape by ``sum_to_size`` (what
    autograd's ``expand`` backward runs, on a contiguous cotangent, as
    before the wave read broadcast operands in place). Numbers take no
    gradient; an output nobody differentiates contributes nothing.
    ``spec``: the members with each tensor replaced by its index in
    ``tensors``."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        ctx.set_materialize_grads(False)
        ctx.spec = spec
        ctx.save_for_backward(*tensors)
        need = ctx.needs_input_grad[1:]
        # (da, db, dacc) asked by some member: the launches backward makes
        # for da and db, and whether it passes g through
        ctx.asked = tuple(any(isinstance(m[r], int) and need[m[r]]
                              for m in spec) for r in (1, 2, 3))
        return tuple(_mac([MacMember(m.shape, *(
            tensors[x] if isinstance(x, int) else x for x in m[1:4]),
            m.stride) for m in spec]))

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        out = [None] * len(tensors)
        waves = ([], [])            # (slot, member) of the da and db launches
        for m, g in zip(ctx.spec, grads):
            if g is None:
                continue
            sa, sb, sc = m[1:4]
            a, b = (tensors[x] if isinstance(x, int) else x for x in (sa, sb))
            if isinstance(sa, int) and need[sa]:
                waves[0].append((sa, MacMember(m.shape, g, b, 0.0)))
            if isinstance(sb, int) and need[sb]:
                waves[1].append((sb, MacMember(m.shape, g, a, 0.0)))
            if isinstance(sc, int) and need[sc]:
                out[sc] = _summed(g, tensors[sc].shape)
        for wave in waves:
            if wave:
                for (slot, _), d in zip(wave, _mac([mb for _, mb in wave])):
                    out[slot] = _summed(d, tensors[slot].shape)
        return (None, *out)


def _summed(g: torch.Tensor, shape) -> torch.Tensor:
    """``g`` reduced to a broadcast operand's ``shape``."""
    return g if g.shape == shape else g.contiguous().sum_to_size(shape)


def _mac(members, name: str = "pim_mac",
         key: tuple | None = None) -> list[torch.Tensor]:
    """One K3 launch over a wave (its plain version on the CPU): one
    output per member, on the card each a view of one fresh allocation
    (for one member, or one of ``OWN_ALLOCATION`` elements or more, an
    allocation of its own). The table is planned once per
    ``_signature`` of the wave (``_plan``, which checks the members) and
    kept; a call fills in its tensors' addresses and launches. ``key``:
    the wave's signature, where the caller has it."""
    if key is None:
        key = _signature(members)[0]
    plan = _PLANS.get(key)
    if plan is not None:
        return _launch(plan, [m[1:4] for m in members])
    device = _wave_device(members)
    if device.type != "cuda":               # each output laid out as here
        return ref.pim_mac_wave_ref([m._replace(stride=_out_layout(
            m.shape, m.stride and tuple(m.stride))[1])
            for m in _normalized(members, name)])
    plan = _plan(_normalized(members, name), device)
    values = [r.values for r in plan.rows]
    if plan.kept and all(x.device == device for m in members
                         for x in m[1:4] if isinstance(x, torch.Tensor)):
        if len(_PLANS) >= _PLANS_KEPT:
            _PLANS.clear()
        # kept without this call's operands: a plan must not hold tensors
        # alive (an AdamW wave's at full width are gigabytes)
        _PLANS[key] = plan._replace(rows=tuple(r._replace(values=())
                                               for r in plan.rows))
    return _launch(plan, values)


def _signature(members) -> tuple[tuple, bool]:
    """(all that a wave's table depends on but its tensors' addresses —
    each member's shape and output layout, each tensor's dtype, device
    index, shape and strides, each number (as its exact hex spelling, so
    that -0.0 and 0.0 differ) —, whether a tensor of it requires grad)."""
    key, grad = [], False
    tensor = torch.Tensor
    for shape, a, b, acc, stride in members:
        ops = []
        for x in (a, b, acc):
            if isinstance(x, tensor):
                ops.append((x.dtype, x.get_device(), x.shape, x.stride()))
                grad = grad or x.requires_grad
            else:
                ops.append(float(x).hex())
        key.append((shape if type(shape) is tuple else tuple(shape),
                    stride if stride is None or type(stride) is tuple
                    else tuple(stride), *ops))
    return tuple(key), grad


_PLANS: dict = {}          # _signature -> _Plan
_PLANS_KEPT = 1024


class _Plan(NamedTuple):
    """A wave's table, all but its addresses (``_plan``)."""

    table: bytes          # the members' rows packed, addresses zero
    table_type: type      # its ctypes array type
    rows: tuple           # MacRow per member, the empty ones included
    total: int            # float32 elements of the outputs' allocation
    live: int             # rows in the table (members with elements)
    blocks: int
    device: torch.device
    kept: bool            # reusable: no operand was copied for it


def _plan(members, device: torch.device | None = None) -> _Plan:
    """The table of a wave as ``_normalized`` leaves it (``wave_rows``)
    on ``device`` (its own by default), each row that can take the float4
    path marked for it (a call clears the mark where an operand read as
    float4 is not on 16 bytes)."""
    device = device or _wave_device(members)
    rows, total = wave_rows(members)
    rows = [r._replace(flags=r.flags | _FLAG_VEC) if _vec_ok(r) else r
            for r in rows]
    live = [r for r in rows if r.n]
    table = bytes(pack_rows(live))
    return _Plan(table, ctypes.c_char * len(table), tuple(rows), total,
                 len(live), sum(-(-r.n // MAC_BLOCK) for r in live),
                 device, not any(r.copied for r in rows))


def _vec_ok(row) -> bool:
    """Whether a row's layout lets it take the float4 path: a flat row,
    or a strided one read four elements at a time (``_row_plan``)."""
    return not row.flags & _FLAG_STRIDED or (
        not row.flags & _FLAG_WIDE and bool(row.dense))


_MAC_FN: list = []          # K3's C entries (table by value, in device
                            # memory), once the layout is checked


def _launch(plan: _Plan, values) -> list:
    """One launch of ``plan`` over the members' operands ``values`` (a,
    b, acc each), its outputs allocated here."""
    rows, device = plan.rows, plan.device

    def own(r):
        return torch.empty_strided(r.shape, r.out_stride,
                                   dtype=torch.float32, device=device)

    if len(rows) == 1:
        outs = [own(rows[0])]
    else:
        buf = torch.empty(plan.total, dtype=torch.float32, device=device)
        outs = [own(r) if r.offset < 0 else
                buf.as_strided(r.shape, r.out_stride, r.offset)
                for r in rows]
    if not plan.live:
        return outs
    table = filled_table(plan, values, outs)
    if not _MAC_FN:
        _mac_kernel()
    if device.index == torch._C._cuda_getDevice():
        rc = _launch_table(table, plan, device)
    else:
        with torch.cuda.device(device):
            rc = _launch_table(table, plan, device)
    _raise_on(rc, "pim_mac")
    pim_mac.launches += 1
    return outs


def _launch_table(table: ctypes.Array, plan: _Plan,
                  device: torch.device) -> int:
    """Launch K3 over the filled ``table`` on the current stream: by value
    up to ``MAC_MAX_MEMBERS`` rows, else from a copy in device memory. That
    copy goes through pinned memory and is enqueued on the launch's
    stream (no host sync); the stream-ordered allocators keep both
    buffers from reuse until the stream has passed the launch."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if plan.live <= MAC_MAX_MEMBERS:
        return _MAC_FN[0](table, plan.live, plan.blocks, stream)
    rows = torch.frombuffer(table, dtype=torch.uint8).pin_memory()
    on_card = rows.to(device, non_blocking=True)
    return _MAC_FN[1](table, on_card.data_ptr(), plan.live, plan.blocks,
                      stream)


def filled_table(plan: _Plan, values, out_base) -> ctypes.Array:
    """``plan``'s table with this call's addresses: each output at
    ``out_base`` plus its offset (``out_base`` a list: at each row's
    output tensor of it), each pointer operand of ``values`` at its
    tensor's; a flat row whose dense operand is not on 16 bytes loses the
    float4 path."""
    table = plan.table_type.from_buffer_copy(plan.table)
    at = 0
    for k, (r, vals) in enumerate(zip(plan.rows, values)):
        if not r.n:
            continue
        ptrs = [0, 0, 0]
        for i in r.pointers:
            ptrs[i] = vals[i].data_ptr()
        out = (out_base[k].data_ptr() if isinstance(out_base, list)
               else out_base + 4 * r.offset)
        _ADDRESSES.pack_into(table, at, out, *ptrs)
        if r.flags & _FLAG_VEC and any(ptrs[i] % 16 for i in r.dense):
            _FLAG_BYTE.pack_into(table, at + _FLAGS_AT,
                                 r.flags & ~_FLAG_VEC)
        at += _MEMBER_BYTES
    return table


def _mac_kernel() -> ctypes._CFuncPtr:
    """K3's C entry, after checking that the built library packs the
    table as this module does (kept in ``_MAC_FN``)."""
    layout = build.load("pim_mac_layout", (ctypes.c_int,), source="pim_mac")
    got = tuple(layout(i) for i in range(len(_MAC_LAYOUT)))
    if got != _MAC_LAYOUT:
        raise RuntimeError(f"pim_mac: csrc's table layout {got}, the "
                           f"wrapper packs {_MAC_LAYOUT}")
    _MAC_FN.extend((build.load("pim_mac_wave", _MAC_WAVE_ARGTYPES,
                               source="pim_mac"),
                    build.load("pim_mac_wave_table", _MAC_TABLE_ARGTYPES,
                               source="pim_mac")))
    return _MAC_FN[0]


class MacRow(NamedTuple):
    """One member as K3's table holds it (``wave_rows``)."""

    shape: tuple          # the member's shape
    out_stride: tuple     # its output's strides in the wave's allocation
    offset: int           # its output's first element there; -1: an
                          # allocation of its own (OWN_ALLOCATION)
    n: int                # elements
    first_block: int
    flags: int            # csrc member flags
    pointers: tuple       # the operands read from memory (0 a, 1 b, 2 acc)
    dense: tuple          # those of them read as float4 where they can be
    strides: tuple        # 3 x MAC_DIMS element strides of a, b, acc
    size: tuple           # MAC_DIMS collapsed dims, outermost first
    magic: tuple          # size[1:] as multiply-shift divisors
    shift: tuple
    imm: tuple            # a, b, acc's immediates (0.0 for a pointer)
    values: tuple         # a, b, acc as read (holds copies alive)
    copied: bool          # an operand was copied into the output's layout


@functools.lru_cache(maxsize=4096)
def _contiguous(shape: tuple) -> tuple:
    strides, step = [], 1
    for s in reversed(shape):
        strides.append(step)
        step *= s
    return tuple(reversed(strides))


@functools.lru_cache(maxsize=4096)
def _out_layout(shape: tuple, stride) -> tuple:
    """(the dims in iteration order, the output's strides): the order in
    which ``stride`` is a dense layout of ``shape``, outermost first,
    size-1 dims dropped; else row-major order and contiguous strides."""
    dims = [d for d in range(len(shape)) if shape[d] != 1]
    if stride is not None and len(stride) == len(shape):
        order = sorted(dims, key=lambda d: -stride[d])
        step = 1
        for d in reversed(order):
            if stride[d] != step:
                break
            step *= shape[d]
        else:
            return tuple(order), tuple(stride)
    return tuple(dims), _contiguous(shape)


def _broadcast_strides(xs: tuple, st: tuple, shape: tuple) -> list:
    """The element strides over ``shape``'s dims of an operand of shape
    ``xs`` and strides ``st``, 0 on a broadcast dim."""
    lead = len(shape) - len(xs)
    return [0 if d < lead or xs[d - lead] != s else st[d - lead]
            for d, s in enumerate(shape)]


def _collapse(sizes: list, cols: list) -> tuple:
    """Adjacent dims (outermost first) merged wherever every stride column
    runs on across them; (sizes, cols) outermost first."""
    out_sizes: list = []
    out_cols: list = [[] for _ in cols]
    for k in range(len(sizes) - 1, -1, -1):
        if out_sizes and all(c[k] == oc[-1] * out_sizes[-1]
                             for c, oc in zip(cols, out_cols)):
            out_sizes[-1] *= sizes[k]
        else:
            out_sizes.append(sizes[k])
            for c, oc in zip(cols, out_cols):
                oc.append(c[k])
    return out_sizes[::-1], [oc[::-1] for oc in out_cols]


def divisor(d: int) -> tuple[int, int]:
    """(magic, shift) with ``x // d == ((x * magic >> 32) + x) >> shift``
    for 0 <= x < 2^31 and 1 <= d <= 2^31: the kernel's multiply-shift
    division (shift = ceil(log2 d))."""
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


@functools.lru_cache(maxsize=4096)
def _row_plan(shape: tuple, stride, sig: tuple) -> tuple:
    """How K3 reads a member of ``shape`` whose output takes ``stride``
    and whose operands have the signature ``sig`` (per operand None for a
    number, else its (shape, strides)): (output strides, elements, the
    operands to copy into the output's layout first, the operands read
    from memory, the dense ones of a flat member, strides, size, magic,
    shift, flags). A function of metadata alone, so a graph's nodes are
    planned once.

    A member whose tensor operands all have its shape and its output's
    strides is read flat. Otherwise its dims are put in the order its
    output is dense in (``_out_layout``), size-1 dims dropped, and
    collapsed where every operand runs on (``_collapse``); operands that
    would leave more than ``MAC_DIMS`` dims, or a dim of 2^32 or more, are
    copied into the output's layout. A flat member reads each pointer
    dense (stride 1) or as one value (every stride 0); a member with any
    other pointer is strided and reads every pointer through its index
    map (``_FLAG_WIDE`` from 2^31 elements or an offset of 2^31: 64-bit
    coordinates and division)."""
    order, out_stride = _out_layout(shape, stride)
    n = math.prod(shape)
    ptrs = tuple(r for r in range(3) if sig[r] is not None)
    copies = ()
    if all(sig[r] == (shape, out_stride) for r in ptrs):
        size, cols = [n], [[1] for _ in ptrs]
    else:
        sizes = [shape[d] for d in order]
        while True:
            cols = []
            for r in ptrs:
                st = (out_stride if r in copies
                      else _broadcast_strides(*sig[r], shape))
                cols.append([st[d] for d in order])
            size, cols = _collapse(sizes, cols)
            if len(size) <= MAC_DIMS and (len(size) == 1 or
                                          max(size) < 1 << 32):
                break
            copies = tuple(r for r in ptrs if sig[r] != (shape, out_stride))
    pad = [0] * (MAC_DIMS - len(size))
    strides = [(0,) * MAC_DIMS] * 3
    for r, col in zip(ptrs, cols):
        strides[r] = tuple(pad + col)
    flat = len(size) == 1 and all(c[0] in (0, 1) for c in cols)
    dense = tuple(r for r, c in zip(ptrs, cols) if flat and c[0] == 1)
    flags = sum(1 << r for r in dense) | (0 if flat else _FLAG_STRIDED)
    size = [1] * len(pad) + size
    if not flat and (n >= 1 << 31 or any(
            sum((d - 1) * st for d, st in zip(size, strides[r])) >= 1 << 31
            for r in ptrs)):
        flags |= _FLAG_WIDE
    elif not flat and size[-1] % 4 == 0 and all(
            strides[r][-1] == 0 or (strides[r][-1] == 1 and not any(
                st % 4 for st in strides[r][:-1])) for r in ptrs):
        # four elements at a time; the operands read as float4 must sit
        # on 16 bytes (a call checks their addresses)
        dense = tuple(r for r in ptrs if strides[r][-1] == 1)
    if flat:                        # sizes unread: n is the member's extent
        size = [1] * MAC_DIMS
    magic, shift = zip(*(divisor(d) if d <= 1 << 31 else (0, 0)
                         for d in size[1:]))
    return (out_stride, n, copies, ptrs, dense,
            tuple(x for s in strides for x in s), tuple(size), magic,
            shift, flags)


def wave_rows(members) -> tuple[list[MacRow], int]:
    """K3's table for a wave as ``_normalized`` leaves it, and the float32
    elements of the one allocation its outputs take (each output on 16
    bytes; a member of ``OWN_ALLOCATION`` elements or more takes one of
    its own, offset -1): each member as ``_row_plan`` reads it, with its
    numbers; a copied operand is counted in ``pim_mac.materialized``."""
    rows, offset, first_block = [], 0, 0
    for shape, *values, stride in members:
        sig = tuple((x.shape, x.stride()) if isinstance(x, torch.Tensor)
                    else None for x in values)
        (out_stride, n, copies, pointers, dense, strides, size, magic,
         shift, flags) = _row_plan(shape, None if stride is None
                                   else tuple(stride), sig)
        for r in copies:
            values[r] = torch.empty_strided(
                shape, out_stride, dtype=torch.float32,
                device=values[r].device).copy_(values[r])
            pim_mac.materialized += 1
        imm = tuple(0.0 if r in pointers else values[r] for r in range(3))
        big = n >= OWN_ALLOCATION
        rows.append(MacRow(shape, out_stride, -1 if big else offset, n,
                           first_block, flags, pointers, dense, strides,
                           size, magic, shift, imm, tuple(values),
                           bool(copies)))
        offset += 0 if big else -(-n // 4) * 4
        first_block += -(-n // MAC_BLOCK)
    return rows, offset


def pack_rows(rows) -> ctypes.Array:
    """The rows as csrc's ``Member`` array, every address 0 (a launch
    fills them in: ``filled_table``)."""
    table = ctypes.create_string_buffer(_MEMBER_BYTES * len(rows))
    for i, r in enumerate(rows):
        _MEMBER.pack_into(table, i * _MEMBER_BYTES, 0, 0, 0, 0, r.n,
                          *r.strides, *r.size, *r.magic, *r.imm,
                          r.first_block, *r.shift, r.flags)
    return table
