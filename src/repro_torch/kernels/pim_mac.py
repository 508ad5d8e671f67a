"""PIM MAC and blocked matmul: the port of the reference's K1, K2 and K3
kernel entries (``repro/kernels/pim_mac.py``).

``pim_matmul_grouped`` (K1) and ``pim_matmul`` (K2) replace the Pallas TPU
kernels ``_matmul_grouped_kernel`` and ``_matmul_kernel`` with one CUDA
kernel body for Hopper written by hand (``csrc/pim_matmul.cu``): K2 is K1
launched with one group, so a grouped launch equals the per-block launches
on the same padded blocks bit for bit. ``pim_mac`` (K3) replaces
``_mac_kernel`` with ``csrc/pim_mac.cu``: ``acc + a*b`` with two
roundings. ``pim_mac_grouped`` has no kernel of its own: it concatenates
a ragged wave of triples into one K3 launch, as the reference's wrapper
does. Each kernel source states its bound and design.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in ``ref`` — the analogue of the
reference's interpret mode. ``launches`` counts each kernel's launches.

The reference's kernels carry custom VJPs; the port has no
``torch.autograd.Function`` for them yet (ROADMAP.md, queue item 3.1), so
a wrapper given an input that requires grad raises rather than return a
result cut off from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# csrc pim_matmul_grouped(a, b, c, G, col_groups, M, K, N, stream)
_MM_GROUPED_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)
# csrc pim_matmul(a, b, c, M, K, N, stream)
_MM_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
# csrc pim_mac(a, b, acc, out, n, stream)
_MAC_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,
                                          ctypes.c_void_p)
TILE_MN = 128       # csrc kBM, kBN: M and N are multiples of this
TILE_K = 8          # csrc kBK: K is a multiple of this


def _no_grad(name: str, *tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward in the port yet (ROADMAP.md, queue "
            f"item 3.1); pass tensors that do not require grad")


def _common(name: str, *tensors: torch.Tensor) -> str:
    """Checks every wrapper makes; returns the device type."""
    _no_grad(name, *tensors)
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
    M, N, K multiples of bm, bn, bk. The per-block oracle's product."""
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


pim_matmul.launches = 0


def pim_matmul_grouped(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                       bn: int = 128, bk: int = 128,
                       col_groups: int = 1) -> torch.Tensor:
    """float32 ``C[g] = A[g // col_groups] @ B[g]`` for a stack of G =
    len(B) placed blocks in ONE launch: A [G / col_groups, M, K], B [G, K,
    N], C [G, M, N]. ``col_groups`` is the shared-A mode: a placed node's
    column blocks all consume one activation slab, never copied. Each
    group's result equals :func:`pim_matmul` on the same operands bit for
    bit."""
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


pim_matmul_grouped.launches = 0


def pim_mac(a: torch.Tensor, b: torch.Tensor,
            acc: torch.Tensor) -> torch.Tensor:
    """Elementwise float32 ``acc + a*b``, rounded twice (the product, then
    the sum); operands of one shape."""
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


pim_mac.launches = 0


def pim_mac_grouped(triples) -> list[torch.Tensor]:
    """One K3 launch for a *wave* of independent eltwise MACs.

    ``triples`` is a sequence of ``(a, b, acc)`` triples of arbitrary
    (ragged) shapes; each contributes ``acc + a*b``. Operands are flattened
    and concatenated so the whole wave rides a single :func:`pim_mac`
    launch; returns the per-triple outputs in order, reshaped back.
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
