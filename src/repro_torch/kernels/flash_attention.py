"""Attention kernels: the port of the reference's K7, K4 and K6 kernel
entries.

``flash_attention`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/flash_attention.py:flash_attention``, kernel body
``_flash_kernel``) with a CUDA kernel for Hopper written by hand
(``csrc/flash_attention.cu``): causal GQA attention over whole sequences,
the kv head read in place, the online-softmax state in float32, KV tiles
in the causal future skipped. It is forward only, as the reference gives
it no VJP.

``paged_decode_attention_grouped`` replaces the Pallas TPU kernel of the
same name (``repro/kernels/flash_attention.py:paged_decode_attention_grouped``,
kernel body ``_paged_decode_kernel``) with CUDA kernels for Hopper written
by hand (``csrc/paged_decode_attention.cu``): one call covers every batch
slot, KV blocks are read straight out of the shared pool through the
block table, and the softmax state stays in float32. A call is two
kernels on one stream (split-KV): each slot's table is cut into splits of
``split_policy`` blocks, whose partial softmax states a second kernel
combines in split order; it counts as one launch.
``paged_decode_attention_grouped_q`` does the same over a quantized pool
(``_paged_decode_kernel_q`` → ``csrc/paged_decode_attention_q.cu``), on
the same splits and passes (``csrc/paged_decode_split.cuh``), with kernels
of its own names: each split copies its rows' codes and scales, and
dequantizes each code where it is read. Each kernel source states its
bound and design.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in ``ref`` — the analogue of the
reference's interpret mode. ``launches`` counts each kernel's launches,
so a run can show its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc flash_attention(q, k, v, out, B, S, H, G, D, dtype, scale, stream)
_FLASH_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_void_p)
_FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)   # csrc dispatch


def flash_head_dim(d: int) -> int:
    """The head dim K7 is compiled for that takes a head dim ``d``: the
    least of ``_FLASH_HEAD_DIMS`` at or above it. The wrapper zero-pads
    q, k and v up to it: zero columns add nothing to QKᵀ and give zero
    output columns, which it slices off. Raises above 256."""
    for dp in _FLASH_HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"flash_attention: head dim {d} above the kernel's "
                     f"largest, {_FLASH_HEAD_DIMS[-1]}")


def _flash_scale(d: int) -> float:
    """1/sqrt(d) in float32, as the kernel computed it from its own D
    before it took padded head dims."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _check_flash(q, k, v, q_chunk: int, kv_chunk: int) -> None:
    """K7's contract, the reference wrapper's: q [B, S, H, D], k/v
    [B, S, G, D] with G | H, one dtype (float32 or bfloat16), and S a
    multiple of ``min(chunk, S)`` for both chunks."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         f"[B, S, H, D] and [B, S, G, D]")
    b, s, h, d = q.shape
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (need G | H)")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; want one of float32, bfloat16")
    for name, chunk in (("q_chunk", q_chunk), ("kv_chunk", kv_chunk)):
        if chunk < 1 or s % min(chunk, s):
            raise ValueError(f"flash_attention: S={s} is not a multiple of "
                             f"min({name}={chunk}, S)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention is forward only (the reference "
                         "kernel has no VJP): call it on tensors that do "
                         "not require grad, or under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_chunk: int = 256, kv_chunk: int = 256) -> torch.Tensor:
    """Causal GQA attention: q [B, S, H, D], k/v [B, S, G, D] -> [B, S, H,
    D] in q's dtype; query head h reads kv head h // (H / G).

    ``q_chunk`` / ``kv_chunk`` are the reference's tiling contract only
    (S must be a multiple of each, clamped to S); the kernel's own tile
    is 64 query rows by 64 keys, the ragged end masked. A head dim D up
    to 256 runs on the card: one that the kernel is not compiled for is
    zero-padded up to the next one (``flash_head_dim``), the scores
    still scaled by 1/sqrt(D). Forward only.
    """
    _check_flash(q, k, v, q_chunk, kv_chunk)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    b, s, h, d = q.shape
    dp = flash_head_dim(d)
    if dp != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    elif not (q.is_contiguous() and k.is_contiguous()
              and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    out = torch.empty_like(q)
    kernel = build.load("flash_attention", _FLASH_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, s, h, k.shape[2], dp, _DTYPE_CODE[q.dtype],
                    _flash_scale(d),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention.launches += 1
    return out if dp == d else out[..., :d]


flash_attention.launches = 0
# csrc paged_decode_attention(q, k, v, table, pos, out, ws_acc, ws_ml, B,
# H, G, D, bs, W, nb, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
_MAX_REP = 16           # csrc kMaxRep
_MAX_HEAD_DIM = 256     # csrc kThreads * kMaxDChunks
_SPLIT_KEYS = 32        # keys per split


def split_policy(w: int, bs: int) -> tuple[int, int]:
    """K4's split-KV schedule over a block table of ``w`` entries of
    ``bs``-key blocks: (table entries per split, splits per slot), 32
    keys a split. It depends on the shapes alone — never on the
    positions — so the wrapper never reads ``pos`` on the host and a
    slot's output does not depend on the other slots."""
    per = max(1, _SPLIT_KEYS // bs)
    return per, -(-w // per)


def _check(q, k_store, v_store, block_table, pos, *,
           store_dtype: torch.dtype | None = None) -> None:
    """K4's contract; ``store_dtype`` (default q's) is the pool's."""
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
    store_dtype = q.dtype if store_dtype is None else store_dtype
    if k_store.dtype != store_dtype or v_store.dtype != store_dtype:
        raise TypeError(f"k/v_store dtypes {k_store.dtype}/{v_store.dtype} "
                        f"must be {store_dtype}")
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


def _check_copies(k_store, v_store, step: int) -> None:
    """What the split kernel's 16-byte row copies need: a head dim that
    is a multiple of ``step`` elements, pools starting on 16 bytes."""
    if k_store.shape[-1] % step:
        raise ValueError(f"head dim {k_store.shape[-1]}: the kernel copies "
                         f"16 bytes at a time and needs D % {step} == 0 for "
                         f"{k_store.dtype} rows")
    for name, t in (("k_store", k_store), ("v_store", v_store)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_split(q, k_store, v_store, block_table, pos) -> None:
    """K4's contract: ``_check``'s, and what the split kernel's 16-byte
    copies need — D a multiple of 8, pools starting on 16 bytes."""
    _check(q, k_store, v_store, block_table, pos)
    _check_copies(k_store, v_store, 8)


def _split_workspace(q, n_split: int) -> tuple[torch.Tensor, int, int]:
    """One float32 workspace for a split call: each split's unnormalised
    acc [B, G, n_split, rep, D], then its (max, sum) per query row [B, G,
    n_split, rep, 2]. Returns it (held by the caller through the launch)
    and the addresses of the two parts."""
    b, h, d = q.shape
    rows = b * h * n_split
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    return ws, ws.data_ptr(), ws.data_ptr() + 4 * rows * d


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
    _check_split(q, k_store, v_store, block_table, pos)
    b, h, d = q.shape
    _, bs, g, _ = k_store.shape
    w = block_table.shape[1]
    per, n_split = split_policy(w, bs)
    out = torch.empty_like(q)
    ws, ws_acc, ws_ml = _split_workspace(q, n_split)
    kernel = build.load("paged_decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = kernel(
            q.data_ptr(), k_store.data_ptr(), v_store.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            ws_acc, ws_ml, b, h, g, d, bs, w, per, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(cudaError {rc})")
    paged_decode_attention_grouped.launches += 1
    return out


paged_decode_attention_grouped.launches = 0


# csrc paged_decode_attention_q(q, k, k_scale, v, v_scale, table, pos, out,
# ws_acc, ws_ml, B, H, G, D, bs, W, nb, dtype, codes, n_exp, n_mant, bias,
# stream)
_ARGTYPES_Q = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 12
               + (ctypes.c_void_p,))
# csrc ``codes``: 0 int8 grid codes, 1 uint8 / 2 16-bit sign|exp|mant codes
_CODES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2}


def _check_q(q, k_store, k_scale, v_store, v_scale, block_table, pos,
             kv_dtype: str) -> None:
    s = quant.spec(kv_dtype)
    if s.name == "fp32":
        raise ValueError("kv_dtype='fp32' pools hold values, not codes: "
                         "use paged_decode_attention_grouped")
    want = quant.code_dtype(s)
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"k/v_scale dtypes {k_scale.dtype}/{v_scale.dtype} "
                        f"must be float32")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(k_store.shape[:3]) + (1,):
            raise ValueError(f"{name} {tuple(t.shape)} must be [N, bs, G, 1]"
                             f" for codes {tuple(k_store.shape)}")
    # the rest of the contract is K4's, with the codes in the values' place
    _check(q, k_store, v_store, block_table, pos, store_dtype=want)


def _check_split_q(q, k_store, k_scale, v_store, v_scale, block_table, pos,
                   kv_dtype: str) -> None:
    """K6's contract on the card: ``_check_q``'s, and what the split
    kernel's 16-byte copies of the codes need — D times the bytes of a
    code a multiple of 16, pools starting on 16 bytes."""
    _check_q(q, k_store, k_scale, v_store, v_scale, block_table, pos,
             kv_dtype)
    _check_copies(k_store, v_store, 16 // k_store.element_size())


def paged_decode_attention_grouped_q(q: torch.Tensor, k_store: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_store: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     block_table: torch.Tensor,
                                     pos: torch.Tensor, *,
                                     kv_dtype: str) -> torch.Tensor:
    """:func:`paged_decode_attention_grouped` over a quantized pool.

    k/v_store: [N, bs, G, D] packed codes of grid ``kv_dtype``
    (``quant.code_dtype``: int8, uint8, or int16 holding the fp16 grid's
    16 bits); k/v_scale: [N, bs, G, 1] float32 per-(token, kv head)
    scales; the rest as for K4. Dequantizes every code on load as
    ``quant.dequantize_kv`` does; scores, softmax and the PV product in
    float32. Returns [B, H, D] in q's dtype.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged_decode_attention_grouped_q runs on cuda or "
                         f"cpu tensors, got {q.device}")
    if q.device.type == "cpu":
        _check_q(q, k_store, k_scale, v_store, v_scale, block_table, pos,
                 kv_dtype)
        return ref.paged_decode_attention_q_ref(
            q, k_store, k_scale, v_store, v_scale, block_table, pos,
            kv_dtype)
    _check_split_q(q, k_store, k_scale, v_store, v_scale, block_table, pos,
                   kv_dtype)
    s = quant.spec(kv_dtype)
    b, h, d = q.shape
    _, bs, g, _ = k_store.shape
    w = block_table.shape[1]
    per, n_split = split_policy(w, bs)
    out = torch.empty_like(q)
    ws, ws_acc, ws_ml = _split_workspace(q, n_split)
    kernel = build.load("paged_decode_attention_q", _ARGTYPES_Q)
    with torch.cuda.device(q.device):
        rc = kernel(
            q.data_ptr(), k_store.data_ptr(), k_scale.data_ptr(),
            v_store.data_ptr(), v_scale.data_ptr(), block_table.data_ptr(),
            pos.data_ptr(), out.data_ptr(), ws_acc, ws_ml, b, h, g, d, bs, w,
            per, _DTYPE_CODE[q.dtype], _CODES[k_store.dtype], s.n_exp,
            s.n_mant, s.bias if s.kind == "float" else 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention_q kernel launch failed "
                           f"(cudaError {rc})")
    paged_decode_attention_grouped_q.launches += 1
    return out


paged_decode_attention_grouped_q.launches = 0


# ---------------------------------------------------------------------------
# K4 and K6 as ops the mapper's capture keeps whole
# ---------------------------------------------------------------------------
#
# The reference's graph does not look inside a ``pallas_call``: a decode
# site's attention on the kernel path is one equation with no priced node,
# its output drawing edges from every input. The port's capture
# (``core.estimator.capture``, ``make_fx``) would trace a Python wrapper's
# plain version op by op, so the traced step reaches K4 and K6 through
# these custom ops: one opaque node each, whose fake implementation gives
# the output's shape. Called on real tensors they are the wrappers above —
# the kernel on a CUDA tensor (counted in the wrapper's ``launches``), the
# plain version on a CPU tensor — and never fall back.


@torch.library.custom_op("repro_torch::paged_decode", mutates_args=())
def paged_decode_op(q: torch.Tensor, k_store: torch.Tensor,
                    v_store: torch.Tensor, block_table: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """:func:`paged_decode_attention_grouped` (K4) as one op."""
    return paged_decode_attention_grouped(q.contiguous(), k_store, v_store,
                                          block_table, pos)


@paged_decode_op.register_fake
def _paged_decode_fake(q, k_store, v_store, block_table, pos):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::paged_decode_q", mutates_args=())
def paged_decode_q_op(q: torch.Tensor, k_store: torch.Tensor,
                      k_scale: torch.Tensor, v_store: torch.Tensor,
                      v_scale: torch.Tensor, block_table: torch.Tensor,
                      pos: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """:func:`paged_decode_attention_grouped_q` (K6) as one op."""
    return paged_decode_attention_grouped_q(
        q.contiguous(), k_store, k_scale, v_store, v_scale, block_table,
        pos, kv_dtype=kv_dtype)


@paged_decode_q_op.register_fake
def _paged_decode_q_fake(q, k_store, k_scale, v_store, v_scale, block_table,
                         pos, kv_dtype):
    return torch.empty_like(q, memory_format=torch.contiguous_format)
