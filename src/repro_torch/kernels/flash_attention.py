"""Paged-KV decode attention: the port of the reference's K4 kernel entry.

``paged_decode_attention_grouped`` replaces the Pallas TPU kernel of the
same name (``repro/kernels/flash_attention.py:paged_decode_attention_grouped``,
kernel body ``_paged_decode_kernel``) with a CUDA kernel for Hopper written
by hand (``csrc/paged_decode_attention.cu``): one launch covers every
batch slot, KV blocks are read straight out of the shared pool through
the block table, and the online-softmax state stays in float32. The
kernel source states its bound and design.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.paged_decode_attention_ref`` —
the analogue of the reference's interpret mode. ``launches`` counts the
kernel launches, so a run can show its decode path went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc paged_decode_attention(q, k, v, table, pos, out, B, H, G, D, bs, W,
# dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
_MAX_REP = 16           # csrc kMaxRep
_MAX_HEAD_DIM = 256     # csrc kThreads * kMaxDChunks


def _check(q, k_store, v_store, block_table, pos) -> None:
    tensors = {"q": q, "k_store": k_store, "v_store": v_store,
               "block_table": block_table, "pos": pos}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    if k_store.dtype != q.dtype or v_store.dtype != q.dtype:
        raise TypeError(f"k/v_store dtypes {k_store.dtype}/{v_store.dtype} "
                        f"must equal q's {q.dtype}")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("block_table and pos must be int32")
    if q.dim() != 3 or k_store.dim() != 4 or block_table.dim() != 2:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_store "
                         f"{tuple(k_store.shape)}, block_table "
                         f"{tuple(block_table.shape)}: want [B, H, D], "
                         f"[N, bs, G, D], [B, W]")
    b, h, d = q.shape
    _, _, g, dk = k_store.shape
    if v_store.shape != k_store.shape or dk != d:
        raise ValueError(f"v_store {tuple(v_store.shape)} / k_store "
                         f"{tuple(k_store.shape)} do not match q's head dim "
                         f"{d}")
    if block_table.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} and pos "
                         f"{tuple(pos.shape)} must have {b} rows")
    if h % g or h // g > _MAX_REP or d > _MAX_HEAD_DIM:
        raise ValueError(f"H={h}, G={g}, D={d}: need G | H, H/G <= "
                         f"{_MAX_REP}, D <= {_MAX_HEAD_DIM}")


def paged_decode_attention_grouped(q: torch.Tensor, k_store: torch.Tensor,
                                   v_store: torch.Tensor,
                                   block_table: torch.Tensor,
                                   pos: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV pool for all slots in one launch.

    q: [B, H, D] (one new token per slot); k/v_store: [N, bs, G, D] (the
    pool, new token already scattered in); block_table: [B, W] int32
    physical block ids, entries past a slot's position clamped to the
    scratch block; pos: [B] int32 per-slot positions. Returns [B, H, D]
    in q's dtype. Every valid table entry must name a block of the pool.
    """
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_store, v_store,
                                              block_table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_grouped runs on cuda or "
                         f"cpu tensors, got {q.device}")
    _check(q, k_store, v_store, block_table, pos)
    b, h, d = q.shape
    _, bs, g, _ = k_store.shape
    out = torch.empty_like(q)
    kernel = build.load("paged_decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = kernel(
            q.data_ptr(), k_store.data_ptr(), v_store.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, h, g, d, bs, block_table.shape[1], _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(cudaError {rc})")
    paged_decode_attention_grouped.launches += 1
    return out


paged_decode_attention_grouped.launches = 0
