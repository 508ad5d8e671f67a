#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. ``build``     — compile every CUDA kernel of the port with nvcc, one
   process per source, all started together (six sources; K1, K2 and K5
   share one).
2. ``kernels``   — hold each kernel against its plain PyTorch version on
   the card at the shapes of the serve phases (K4; K6 for each KV grid,
   with bf16 and f32 q), each (slot, head) row to its own scale, with a
   control that the tolerance fails a kernel reading one row past pos;
   and time kernel, plain version and one PyTorch library call computing
   the same function.
3. ``parity``    — llama3-8b at full width, 2 layers, float32: the serve
   engine with the kernel and with the gather path gives identical tokens
   and per-tick logits within 1e-4 x max|logit| over an unquantized pool
   (K4), and within 1e-3 over int8 and fp8_e4m3 pools (K6), where a
   value near a rounding boundary may take the neighbouring code on one
   path (``PARITY_TOL``; the codes that differ are counted, and the
   quantized pool's logits against the fp32 pool's are read as the
   control).
4. ``serve``     — llama3-8b at its full published config in bfloat16
   serves 16 requests; K4 must run once per layer per tick.
5. ``profile``   — a short second load on the same engine under
   ``torch.profiler``: device time by kernel group against wall time.
6. ``serve_kvq`` — the same model serves 16 requests over an fp8_e4m3 KV
   pool (kernel path, replayed prompts); K6 must run once per layer per
   tick, K4 never. ``profile_kvq`` profiles a second load on it.
7. ``pim_lenet``   — the paper's LeNet-5 through the mapper: the compiled
   program (K1 and K3) and the per-block executor (K2 and K3) at batch 256
   and 4096 over digit images, with seeded random parameters and non-zero
   biases, bit-equal to each other and within 1e-4 of the plain
   ``lenet_apply`` (TF32 off); launches per call, ms per call, images/s,
   peak memory, and a profile of the program's device time by kernel
   group against wall time. The shapes of the batch-256 launches are
   logged for the next phase.
8. ``kernels_pim`` — K1, K2 and K3 at the shapes ``pim_lenet`` launched
   them at batch 256 (K1 at each placed node's grouped shape, K2 at each
   placed block's, K3 at each add's and one grouped wave of the adds), on
   seeded random data, each held against its plain version (TF32 off; K1
   and K2 per output row to its own max|out|, with a control that
   dropping the last K tile fails that limit; K3 bit for bit), K1 equal
   to K2 and to itself on a second run bit for bit, each K1/K2 launch's
   K split recorded (one chunk at every K <= 256), and timed beside its
   bound and a library call.
9. ``pim_train`` — the paper's LeNet-5 trained through the mapper:
   ``Trainer(backend="pim")`` (the whole AdamW step compiled once) and
   ``backend="jit"`` (the plain eager step) from the same seeded
   parameters, TF32 off, batch 64: the first 10 losses agree within
   rtol 1e-4, atol 1e-5, the loss at step 300 is below step 0's, one
   compiled step equals the per-block executor bit for bit; launches per
   step, ms per step, images/s, peak memory, ``train.step_wall_s``. Then
   20 steps at batch 4096 with a profile of the compiled step. The
   batch-64 step's launches are logged, and ``kernels_pim`` (``"path":
   "pim_train"``) holds and times K1, K2 and K3 at their shapes as in 8.
10. ``pim_grad`` — gradients of ``lenet_loss`` at batch 256 through the
   mapper against ``torch.func.grad`` of the plain loss (rtol = atol =
   1e-4): autograd through a compiled ``lenet_loss`` program (its
   backward's K1 and K3 launches are exactly the cotangents autograd
   asked for, no native product is differentiated), and the compiled
   program of ``grad(lenet_loss)`` (its backward products are K1
   launches, as in the train step); the typical |grad| per leaf, and
   controls: each backward K1 and K3 launch dropped must fail the check,
   and the readings of each scaled by 1.01. Then autograd through the
   per-block executor of the same schedule (7 K2 and 5 K3 forward; its
   backward's K2 launches, K2's VJP, and K3 launches are the cotangents
   asked): its gradients within 1e-4 of the compiled program's and of
   plain autograd.
11. ``kernels_pim`` (``"path": "pim_grad_backward"``) — the VJP of each K1
   node (dA with and without a shared A, dB) and K3 node of ``pim_grad``'s
   autograd graph at its shapes: the cotangents equal the launches they
   make, which are those of the main path's backward, held against the
   plain formula as in 8, and timed; K2's VJP the same way at the K2
   nodes of ``pim_grad``'s executor backward, whose launches it equals.
   Every K1/K2 launch records its K split (S chunks of whole 128-deep
   tiles), equals the other kernel on the same blocks and itself on a
   second run bit for bit; dB reads Aᵀ in place and equals the launch on
   the materialized transpose, both timed beside the transpose copy;
   ``split_db`` lists each split dB launch (conv1's and conv2's) with
   its time, ``bmm``/``mm`` and bound.
12. ``pim_lenet_q`` — phase 7 with the weights on each quantized grid
   (int8, fp8_e4m3, fp8_e5m2, fp16 at batch 256, int8 at 4096): 5 K5 and
   5 K3 launches per call, no K1; the compiled program bit-equal to the
   per-block executor, and within 1e-4 of the plain ``lenet_apply`` over
   the weights each grid stores (``fake_quant`` per output column, TF32
   off); ms per call, images/s, and the K5 launch shapes.
13. ``kernels_pim`` (``"path": "pim_lenet_q"`` and ``"pim_train_q"``) — K5
   at those launches' shapes over int8-grid weights, against its plain
   version (as K1 in 8) and against K1 on ``q * s`` bit for bit; timed
   with its bound and the library call (``q * s`` then ``bmm``).
14. ``pim_train_q`` — ``Trainer(backend="pim", weight_dtype="int8")``,
   AdamW, batch 64, 301 steps: 11 K5 per step and no K1 or K2; the first
   5 losses within 2% of ``pim_train``'s fp32 run from the same
   parameters and batches, whose ms per step it is set beside; the last
   below the first; one compiled step bit-equal to the executor and
   within 1e-4 of the plain step over fake-quantized stationary operands
   (``run_fake_quant_plain``).
15. ``pim_grad_q`` — phase 10's autograd check through a compiled int8
   ``lenet_loss``, the path of K5's VJP and the straight-through
   quantizer: the backward's K1 and K3 launches are the cotangents asked,
   the gradients within 1e-4 of plain autograd at the dequantized
   weights, and every backward launch dropped fails that check.
16. ``kernels_attn`` — K7 through ``ops.attention``, its only entry, at the
   reference's test shapes ((B, S, H, G, D) (1,128,4,2,64), (2,128,8,8,32),
   (1,64,6,3,16), chunks of 64) and llama3-8b's heads (H 32, G 8, D 128,
   B 1, S 2048 and 8192), float32 and bfloat16: each call one launch, held
   against ``flash_attention_ref`` (TF32 off) per (batch, query, head)
   row at rtol = atol = 2e-5 (f32) or 2e-2 (bf16), atol x the row's
   max|out|, with a control that
   dropping the last query tile's diagonal KV tile fails that limit in
   that tile; at llama3-8b's heads timed
   against the plain version and ``scaled_dot_product_attention``
   (causal, GQA), beside the causal-flops bound.
17. ``pim_fp`` — K8 over 2^20 random float32 bit patterns of every
   exponent, the reference's edge table, and normal pairs whose product
   is subnormal or within three ulps of 2^-126: one launch, equal bit for
   bit (NaN as NaN) to its plain version and to the port's bit-plane
   ``core.fp.fp32_mul_pim`` on the card, and to ``torch.mul`` of the DAZ'd
   inputs wherever the exact product is normal (below 2^-126 IEEE may
   round up to 2^-126 where the procedure flushes); ``fp32_add_pim`` equal
   to IEEE
   addition where the sum is normal or zero, ``pim_dot`` to a sequential
   float32 sum; K8 timed at 2^24 elements against its plain version and
   ``torch.mul`` beside its byte bound and its SASS integer instructions
   per element.

Then the card's name and power limit, one line with every kernel's
numbers, and as the last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero. Needs one CUDA device; imports nothing
of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 40, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    """Build every source, one nvcc each, all started together; each
    source's own build time is reported beside the total, so their sum is
    what building them one after another would take."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build

    def timed(name):
        t = time.perf_counter()
        path = build.build(name)
        return path.name, time.perf_counter() - t

    names = build.sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(timed, names))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_by_library": libs})


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------

K4 = {"name": "paged_decode_attention_grouped", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
      "replaces": "src/repro/kernels/flash_attention.py:174"}
K6 = {"name": "paged_decode_attention_grouped_q", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/paged_decode_attention_q.cu",
      "replaces": "src/repro/kernels/flash_attention.py:278"}
# (KV grid, q dtype) of K6's checks: every grid with bf16 q, as the
# serve_kvq phase runs it, and with f32 q, held to f32 rounding
K6_CASES = tuple((g, t) for t in ("bfloat16", "float32")
                 for g in ("int8", "fp8_e4m3", "fp8_e5m2", "fp16"))
SERVE_KV_DTYPE = "fp8_e4m3"
# serve-phase shapes: batch 8, llama3-8b heads, 16-token blocks, 1024 max_len
K4_SHAPES = dict(B=8, H=32, G=8, D=128, bs=16, W=64)
K4_POS = (0, 15, 16, 255, 511, 700, 1000, 1023)   # 0, block edges, W*bs-1
K4_TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # x max|out| per row
N_COPIES = 8        # rotated pool copies: the working set exceeds the L2


def k4_table(rng):
    """The serve shapes' block table and positions: every slot's valid
    blocks are distinct random blocks of the pool, its table tail is the
    scratch block 0."""
    s = K4_SHAPES
    b, bs, w = s["B"], s["bs"], s["W"]
    n = 1 + b * w
    pos = np.asarray(K4_POS, np.int32)
    table = np.zeros((b, w), np.int32)
    for i, p in enumerate(pos):
        nv = p // bs + 1
        table[i, :nv] = rng.choice(n - 1, nv, replace=False) + 1
    return n, table, pos


def k4_inputs(dtype, rng, device):
    """Inputs at the serve phase's shapes (``k4_table``); block 0 holds
    large finite values that must never be read."""
    import torch
    s = K4_SHAPES
    b, h, g, d, bs = s["B"], s["H"], s["G"], s["D"], s["bs"]
    n, table, pos = k4_table(rng)
    pools = []
    for _ in range(N_COPIES):
        kv = rng.standard_normal((2, n, bs, g, d), np.float32)
        kv[:, 0] = 3.0e4
        pools.append(torch.from_numpy(kv).to(device, dtype))
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32)).to(
        device, dtype)
    return (q, pools, torch.from_numpy(table).to(device),
            torch.from_numpy(pos).to(device))


def k4_bound(q, pos, dtype_name) -> tuple[float, str]:
    """Least time for this call: the bytes the function must move (q and
    pos read once, the K and V rows at positions 0..pos[b] of each slot
    read once with the table entries they sit in, the output written
    once) over HBM rate, against its flops over the peak rate of its
    type. Whole blocks and the table's tail are the kernel's tiling, not
    the function's, and are not counted."""
    s = K4_SHAPES
    item = q.element_size()
    p = pos.cpu().numpy().astype(np.int64)
    rows = int((p + 1).sum())               # K/V rows the function reads
    entries = int((p // s["bs"] + 1).sum())  # table entries they sit in
    nbytes = (2 * q.numel() * item + 2 * rows * s["G"] * s["D"] * item
              + entries * 4 + pos.numel() * 4)
    flops = 4 * rows * s["H"] * s["D"]       # q.k and p.v per query head
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def over_limit(out, want, tol):
    """The error of ``out`` against ``want`` as a fraction of ``tol`` x
    max|want| of each (slot, head) row: [B, H]. The long slots average
    hundreds of rows, so their outputs are ~40x smaller than the
    position-0 slot's; each row is held at its own scale."""
    want = want.float()
    err = (out.float() - want).abs().amax(-1)
    return err / (tol * want.abs().amax(-1)).clamp_min(1e-30)


def hold_and_time(label, q, pos, pools, kernel, plain, heads) -> dict:
    """Hold ``kernel(pool, pos)`` against ``plain(pool, pos)`` on the
    first pool within ``K4_TOL`` x max|out| of each (slot, head), then
    time kernel and plain version over the rotated pools, and the library
    yardstick: SDPA over K/V that ``heads(pool)`` gathered through the
    table beforehand ([B, H, L, D] each, untimed), its error held to the
    same tolerance. The mask is additive (-inf past pos): in bf16 the
    default backend (cuDNN) lets masked keys through under a boolean mask.

    A control shows the tolerance fails a wrong kernel: the plain version
    reading one row past pos (clamped at the table's end) must exceed it
    in every slot that this changes."""
    import torch
    import torch.nn.functional as F
    qname = str(q.dtype).split(".")[1]
    tol = K4_TOL[qname]
    out, want = kernel(pools[0], pos), plain(pools[0], pos)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite output")
    err = float((out.float() - want.float()).abs().max())
    ratio = float(over_limit(out, want, tol).max())
    if not ratio <= 1:
        raise AssertionError(f"{label}: error {ratio} x the limit {tol} x "
                             f"max|out| of a (slot, head)")
    s = K4_SHAPES
    length = s["W"] * s["bs"]
    moved = pos < length - 1
    off_by_one = over_limit(plain(pools[0], torch.clamp(pos + 1,
                                                        max=length - 1)),
                            want, tol).amax(-1)[moved]
    control = float(off_by_one.min())
    if not control > 1:
        raise AssertionError(f"{label}: reading one row past pos gives "
                             f"only {control} x the limit in some slot")

    def rotated(fn):
        it = iter(range(1 << 30))
        return lambda: fn(pools[next(it) % N_COPIES], pos)

    kernel_ms = cuda_ms(rotated(kernel))
    plain_ms = cuda_ms(rotated(plain))
    keep = (torch.arange(length, device=DEVICE)[None]
            <= pos[:, None]).view(s["B"], 1, 1, length)
    bias = torch.zeros(keep.shape, dtype=q.dtype, device=DEVICE
                       ).masked_fill(~keep, float("-inf"))
    gathered = [heads(p) for p in pools]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, *gathered[0],
                                         attn_mask=bias)[:, :, 0]
    lib_err = float((lib.float() - want.float()).abs().max())
    lib_ratio = float(over_limit(lib, want, tol).max())
    if not lib_ratio <= 1:
        raise AssertionError(f"SDPA yardstick {label}: error {lib_ratio} x "
                             f"the limit {tol} x max|out| of a (slot, head)")
    it = iter(range(1 << 30))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, *gathered[next(it) % N_COPIES], attn_mask=bias))
    return {"max_err": err, "tol": tol, "max_err_over_limit": ratio,
            "off_by_one_min_over_limit": control,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "library_max_err_over_limit": lib_ratio}


def to_heads(k, v, table, dtype):
    """K/V [N, bs, G, D] gathered through the table and repeated to every
    query head: [B, H, L, D] each, in ``dtype``."""
    s = K4_SHAPES
    length, rep = s["W"] * s["bs"], s["H"] // s["G"]
    return tuple(x[table.long()].reshape(s["B"], length, s["G"], s["D"])
                 .repeat_interleave(rep, dim=2).transpose(1, 2)
                 .to(dtype).contiguous() for x in (k, v))


def phase_kernels(seed: int) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, pools, table, pos = k4_inputs(dtype, rng, DEVICE)
        r = hold_and_time(
            f"K4 {name}", q, pos, pools,
            lambda p, at: paged_decode_attention_grouped(q, p[0], p[1],
                                                         table, at),
            lambda p, at: ref.paged_decode_attention_ref(q, p[0], p[1],
                                                         table, at),
            lambda p: to_heads(p[0], p[1], table, dtype))
        bound_ms, bound_by = k4_bound(q, pos, name)
        results[name] = {"dtype": name, **r, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        del pools
        torch.cuda.empty_cache()
    emit({"phase": "kernels", **K4, "shapes": K4_SHAPES,
          "positions": list(K4_POS),
          "launches": paged_decode_attention_grouped.launches,
          "results": list(results.values())})
    return results


def k6_inputs(kv_dtype, dtype, rng, device):
    """K6's inputs at the serve shapes (``k4_table``): ``N_COPIES`` pools
    of random K/V quantized on the card with the port's quantizer, whose
    scratch block 0 holds the grid's max-magnitude codes and scales of
    3e4 — garbage that must never be read."""
    import torch
    from repro_torch.core import quant
    s = K4_SHAPES
    b, h, g, d, bs = s["B"], s["H"], s["G"], s["D"], s["bs"]
    n, table, pos = k4_table(rng)
    spec = quant.spec(kv_dtype)
    top = ((1 << spec.n_mant) - 1 if spec.kind == "int" else
           (((1 << spec.n_exp) - 1) << spec.n_mant) | ((1 << spec.n_mant) - 1))
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    pools = []
    for _ in range(N_COPIES):
        kv = torch.randn((2, n, bs, g, d), generator=gen, device=device)
        codes, scales = quant.quantize_kv(kv, kv_dtype)
        codes[:, 0] = top
        scales[:, 0] = 3.0e4
        pools.append((codes, scales))
        del kv
    q = torch.randn((b, h, d), generator=gen, device=device).to(dtype)
    return (q, pools, torch.from_numpy(table).to(device),
            torch.from_numpy(pos).to(device))


def k6_bound(q, codes, pos) -> tuple[float, str]:
    """Least time for this K6 call: the bytes the function must move (q
    and pos read once; the codes and the float32 scales of the K and V
    rows at positions 0..pos[b] read once with the table entries they sit
    in; the output written once) over HBM rate, against its float32
    operations (q.k and p.v per query head, one dequantizing multiply per
    K/V element) over the float32 peak."""
    s = K4_SHAPES
    p = pos.cpu().numpy().astype(np.int64)
    rows = int((p + 1).sum())
    entries = int((p // s["bs"] + 1).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * rows * s["G"] * (s["D"] * codes.element_size() + 4)
              + entries * 4 + pos.numel() * 4)
    flops = 4 * rows * s["H"] * s["D"] + 2 * rows * s["G"] * s["D"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels_q(seed: int) -> dict:
    """K6 against its plain version for every grid, timed as K4 is. The
    library yardstick's K/V are dequantized as well as gathered
    beforehand: no single PyTorch call dequantizes and attends, so it
    times the attention alone."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped_q)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 10)
    results = {}
    for kv_dtype, qname in K6_CASES:
        dtype = getattr(torch, qname)
        q, pools, table, pos = k6_inputs(kv_dtype, dtype, rng, DEVICE)

        def args(pool, at):
            (kc, vc), (ks, vs) = pool
            return (q, kc, ks, vc, vs, table, at)

        def heads(pool):
            (kc, vc), (ks, vs) = pool
            return to_heads(quant.dequantize_kv(kc, ks, kv_dtype),
                            quant.dequantize_kv(vc, vs, kv_dtype), table,
                            dtype)

        r = hold_and_time(
            f"K6 {kv_dtype}/{qname}", q, pos, pools,
            lambda p, at: paged_decode_attention_grouped_q(
                *args(p, at), kv_dtype=kv_dtype),
            lambda p, at: ref.paged_decode_attention_q_ref(*args(p, at),
                                                           kv_dtype),
            heads)
        bound_ms, bound_by = k6_bound(q, pools[0][0], pos)
        results[(kv_dtype, qname)] = {"kv_dtype": kv_dtype, "dtype": qname,
                                      **r, "bound_ms": bound_ms,
                                      "bound_by": bound_by}
        del pools
        torch.cuda.empty_cache()
    emit({"phase": "kernels", **K6, "shapes": K4_SHAPES,
          "positions": list(K4_POS),
          "launches": paged_decode_attention_grouped_q.launches,
          "results": list(results.values())})
    return results


# ---------------------------------------------------------------------------
# 3. parity: kernel vs gather path at full width, 2 layers, float32
# ---------------------------------------------------------------------------


def make_prompts(rng, n, lo, hi, vocab):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)),
                         dtype=np.int32) for _ in range(n)]


# Logits of the kernel and the gather path, relative to max|logit|. The
# two paths sum in different orders, so a K/V vector of the second layer
# differs in its last bits between them; over a quantized pool, a value
# that lies that close to a rounding boundary takes the neighbouring code
# on one path, and that whole grid step (1/16 of the value in fp8_e4m3)
# moves the logits by some 1e-4 of their range. So quantized pools are
# held to 1e-3, and ``pool_flips`` counts the codes that differ and checks
# each is one grid step.
PARITY_TOL = {False: 1e-4, True: 1e-3}


def pool_flips(pool_a, pool_b, kv_dtype) -> dict:
    """Codes that differ between two quantized pools written through the
    same block trajectory, with the largest scale difference; raises
    unless every differing value is within twice the grid's error bound
    of the other. The scratch block 0 is left out: idle slots and prefill
    padding write there at one index, and which write lands is not
    defined on the card."""
    from repro_torch.core import quant
    flips, worst_scale = 0, 0.0
    for leaf in ("k", "v"):
        sa, sb = pool_a[leaf + "_scale"][:, 1:], pool_b[leaf + "_scale"][:, 1:]
        ca, cb = pool_a[leaf][:, 1:], pool_b[leaf][:, 1:]
        flips += int((ca != cb).sum())
        worst_scale = max(worst_scale, float(
            ((sa - sb).abs() / sb.abs().clamp_min(1e-30)).max()))
        a = quant.dequantize_kv(ca, sa, kv_dtype)
        b = quant.dequantize_kv(cb, sb, kv_dtype)
        bound = 2 * quant.error_bound(b, kv_dtype, sb) + 1e-5 * b.abs().amax(
            -1, keepdim=True)
        if not bool(((a - b).abs() <= bound).all()):
            raise AssertionError(f"parity {kv_dtype}: pools differ by more "
                                 f"than one grid step")
    return {"code_flips": flips, "max_scale_rel_diff": worst_scale}


def quantization_reading(ticks, fp32_ticks, tol) -> float:
    """The control of the quantized parity: the kernel path's logits over
    the quantized pool against those over the fp32 pool, as a fraction of
    the parity limit, over the ticks up to the first whose tokens differ
    (later logits follow other tokens). Every value of that pool is up to
    half a grid step off the fp32 one: a path that decoded all its codes
    one step wrong, or attended in a coarser precision, reads like this."""
    worst = 0.0
    for a, b in zip(ticks, fp32_ticks):
        worst = max(worst, float((a - b).abs().max())
                    / (tol * float(b.abs().max())))
        if not bool((a.argmax(-1) == b.argmax(-1)).all()):
            break
    return worst


def phase_parity(seed: int) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped, paged_decode_attention_grouped_q)
    from repro_torch.models import DecoderLM
    from repro_torch.serve import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              dtype="float32")
    model = DecoderLM(cfg, device=DEVICE).init(seed)
    prompts = make_prompts(np.random.default_rng(seed), 4, 17, 40,
                           cfg.vocab_size)

    def drive(attn_kernel, kv_dtype):
        ticks = []

        def sample(logits):
            ticks.append(logits.clone())
            return torch.argmax(logits, -1)

        eng = ServeEngine(cfg, model, batch=4, max_len=64, paged=True,
                          kv_block_size=16, prefill="batch",
                          attn_kernel=attn_kernel, sample=sample,
                          kv_dtype=kv_dtype, device=DEVICE)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_tokens=8))
        return {r.rid: r.out for r in eng.run()}, ticks, eng.cache

    fp32_ticks = None
    for kv_dtype, kernel in (("fp32", paged_decode_attention_grouped),
                             ("int8", paged_decode_attention_grouped_q),
                             ("fp8_e4m3", paged_decode_attention_grouped_q)):
        kernel.launches = 0
        got, lk, pool_k = drive(True, kv_dtype)
        fp32_ticks = lk if fp32_ticks is None else fp32_ticks
        launches = kernel.launches
        want, lg, pool_g = drive(False, kv_dtype)
        if got != want:
            raise AssertionError(f"parity {kv_dtype}: tokens differ: kernel "
                                 f"{got} vs gather {want}")
        if len(lk) != len(lg):
            raise AssertionError(f"parity {kv_dtype}: tick counts differ")
        if launches != cfg.n_layers * len(lk):
            raise AssertionError(f"parity {kv_dtype}: {kernel.__name__} ran "
                                 f"{launches} times, want {cfg.n_layers} x "
                                 f"{len(lk)} ticks")
        worst = 0.0
        tol = PARITY_TOL[kv_dtype != "fp32"]
        for a, b in zip(lk, lg):
            err = float((a - b).abs().max())
            lim = tol * float(b.abs().max())
            worst = max(worst, err / lim)
            if not err <= lim:
                raise AssertionError(f"parity {kv_dtype}: logits differ by "
                                     f"{err} > {lim}")
        line = {"phase": "parity", "config": "llama3-8b n_layers=2 float32",
                "requests": len(prompts), "ticks": len(lk),
                "tokens_identical": True, "max_err_over_limit": worst}
        if kv_dtype != "fp32":
            line.update(kv_dtype=kv_dtype, kernel=kernel.__name__,
                        launches=launches, tol=tol,
                        quantization_over_limit=quantization_reading(
                            lk, fp32_ticks, tol),
                        **pool_flips(pool_k, pool_g, kv_dtype))
        emit(line)


# ---------------------------------------------------------------------------
# 4. serve: llama3-8b full published config, bfloat16
# ---------------------------------------------------------------------------


def phase_serve(seed: int) -> dict:
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped)
    from repro_torch.models import DecoderLM
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=DEVICE).init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"serve: {n_params} params, want "
                             f"{cfg.param_count() + cfg.d_model}")
    prompts = make_prompts(np.random.default_rng(seed + 1), 16, 64, 512,
                           cfg.vocab_size)
    finite = []

    def sample(logits):
        if logits.shape != (8, cfg.vocab_size):
            raise AssertionError(f"serve: logits {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return torch.argmax(logits, -1)

    eng = ServeEngine(cfg, model, batch=8, max_len=1024, kv_block_size=16,
                      paged=True, attn_kernel=True, prefill="batch",
                      sample=sample, device=DEVICE)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=32))
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attention_grouped.launches = 0
    tr = obs.enable()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_decode_attention_grouped.launches
    obs.disable()
    if launches != cfg.n_layers * eng._tick or launches == 0:
        raise AssertionError(f"serve: {launches} kernel launches, want "
                             f"{cfg.n_layers} x {eng._tick} ticks")
    if len(done) != len(prompts) or any(
            len(r.out) != 32 or not all(0 <= t < cfg.vocab_size
                                        for t in r.out) for r in done):
        raise AssertionError("serve: not every request finished with 32 "
                             "valid tokens")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("serve: non-finite logits")
    decode_s = sum(e.dur_s for e in tr.spans(name="decode:tick"))
    prefill_s = sum(e.dur_s for e in tr.spans(name="prefill:batch"))
    generated = sum(len(r.out) for r in done)
    emit({"phase": "serve", "config": "llama3-8b full (32 layers) bfloat16",
          "params": n_params, "init_s": init_s, "requests": len(done),
          "ticks": eng._tick, "generated_tokens": generated,
          "wall_s": wall_s, "decode_s": decode_s, "prefill_s": prefill_s,
          "decode_tok_per_s": generated / decode_s,
          "mean_ttft_s": float(np.mean([r.ttft_s for r in done])),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "k4_launches": launches, "preemptions": eng.preemptions})
    return {"launches": launches, "engine": eng}


def phase_profile(eng, seed: int, phase: str = "profile",
                  prompt_len: int = 256, warm_ticks: int = 1) -> None:
    """Where a decode tick's time goes: a second load (8 requests of
    ``prompt_len`` prompt tokens, 8 output tokens each) on a serve
    phase's engine. The first ``warm_ticks`` ticks (admission, and
    prefill or prompt replay) run untraced; the remaining ticks run
    under ``torch.profiler``: device time of every kernel, grouped into
    K4, K6, matrix products and the rest, against the host's wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request
    prompts = make_prompts(np.random.default_rng(seed + 2), 8, prompt_len,
                           prompt_len, eng.cfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=100 + i, prompt=p, max_tokens=8))
    for _ in range(warm_ticks):
        eng.tick_once()
    torch.cuda.synchronize()
    ticks0 = eng._tick
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups = {"k4": 0.0, "k6": 0.0, "matmul": 0.0, "other": 0.0}
    n_kernels = 0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        us = e.self_device_time_total
        name = e.key.lower()
        n_kernels += e.count
        if "paged_decode_kernel" in name:
            groups["k4"] += us
        elif "paged_decode_q_kernel" in name:
            groups["k6"] += us
        elif any(k in name for k in ("gemm", "gemv", "xmma", "cutlass",
                                     "nvjet")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    device_s = sum(groups.values()) / 1e6
    ticks = eng._tick - ticks0
    emit({"phase": phase, "requests": len(prompts), "ticks": ticks,
          "wall_s": wall_s, "device_kernel_s": device_s,
          "device_kernel_s_per_tick": device_s / ticks,
          "device_busy_share_under_profiler": device_s / wall_s,
          "kernels_launched": n_kernels,
          "device_s_by_group": {k: v / 1e6 for k, v in groups.items()},
          "top_kernels": [{"name": e.key[:80], "count": e.count,
                           "device_s": e.self_device_time_total / 1e6}
                          for e in top]})


# ---------------------------------------------------------------------------
# 6. serve_kvq: the same model over an fp8_e4m3 KV pool
# ---------------------------------------------------------------------------


def phase_serve_kvq(model, seed: int) -> dict:
    """llama3-8b full config, bf16, over a ``SERVE_KV_DTYPE`` pool: the
    kernel path with replayed prompts (a bf16 model with a quantized pool
    runs nowhere else, as in the reference). 16 requests of 64–256 prompt
    tokens, 32 output tokens each, all submitted at once."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped, paged_decode_attention_grouped_q)
    from repro_torch.serve import Request, ServeEngine
    cfg = model.cfg
    prompts = make_prompts(np.random.default_rng(seed + 3), 16, 64, 256,
                           cfg.vocab_size)
    finite = []

    def sample(logits):
        if logits.shape != (8, cfg.vocab_size):
            raise AssertionError(f"serve_kvq: logits {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return torch.argmax(logits, -1)

    eng = ServeEngine(cfg, model, batch=8, max_len=1024, kv_block_size=16,
                      paged=True, attn_kernel=True, prefill="replay",
                      kv_dtype=SERVE_KV_DTYPE, sample=sample, device=DEVICE)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in eng.cache.values())
    kv_blocks = eng.kv.num_blocks
    bf16_bytes = (cfg.n_layers * kv_blocks * eng.block_size * 2
                  * cfg.n_kv_heads * cfg.resolved_head_dim * 2)
    d = cfg.resolved_head_dim
    if pool_bytes * 2 * d != bf16_bytes * (d + 4):     # 132/256 = 0.516
        raise AssertionError(f"serve_kvq: pool {pool_bytes} B, bf16 pool "
                             f"{bf16_bytes} B: want the ratio (D+4)/2D")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attention_grouped.launches = 0
    paged_decode_attention_grouped_q.launches = 0
    tr = obs.enable()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_decode_attention_grouped_q.launches
    k4_launches = paged_decode_attention_grouped.launches
    obs.disable()
    if launches != cfg.n_layers * eng._tick or launches == 0:
        raise AssertionError(f"serve_kvq: {launches} K6 launches, want "
                             f"{cfg.n_layers} x {eng._tick} ticks")
    if k4_launches != 0:
        raise AssertionError(f"serve_kvq: K4 ran {k4_launches} times")
    if len(done) != len(prompts) or any(
            len(r.out) != 32 or not all(0 <= t < cfg.vocab_size
                                        for t in r.out) for r in done):
        raise AssertionError("serve_kvq: not every request finished with "
                             "32 valid tokens")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("serve_kvq: non-finite logits")
    decode_s = sum(e.dur_s for e in tr.spans(name="decode:tick"))
    generated = sum(len(r.out) for r in done)
    emit({"phase": "serve_kvq",
          "config": "llama3-8b full (32 layers) bfloat16",
          "kv_dtype": SERVE_KV_DTYPE, "prefill": "replay",
          "requests": len(done), "ticks": eng._tick,
          "generated_tokens": generated, "wall_s": wall_s,
          "decode_s": decode_s, "tick_ms": decode_s / eng._tick * 1e3,
          "decode_tok_per_s": generated / decode_s,
          "mean_ttft_s": float(np.mean([r.ttft_s for r in done])),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "kv_blocks": kv_blocks, "pool_bytes": pool_bytes,
          "bf16_pool_bytes": bf16_bytes,
          "pool_ratio": pool_bytes / bf16_bytes,
          "kv_bytes_read": eng.kv_bytes_read,
          "kv_bytes_written": eng.kv_bytes_written,
          "k6_launches": launches, "k4_launches": k4_launches,
          "preemptions": eng.preemptions})
    return {"launches": launches, "engine": eng}


# ---------------------------------------------------------------------------
# 7. pim_lenet: the paper's LeNet-5 through the mapper
# ---------------------------------------------------------------------------


K1 = {"name": "pim_matmul_grouped", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
      "replaces": "src/repro/kernels/pim_mac.py:319"}
K2 = {"name": "pim_matmul", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
      "replaces": "src/repro/kernels/pim_mac.py:230"}
K3 = {"name": "pim_mac", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_mac.cu",
      "replaces": "src/repro/kernels/pim_mac.py:124"}
K5 = {"name": "pim_matmul_grouped_q", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
      "replaces": "src/repro/kernels/pim_mac.py:433"}
# the (weight grid, batch) cases pim_lenet serves; kernels_pim runs the
# first one's launches
PIM_SERVE = (("fp32", 256), ("fp32", 4096))
# K1/K2 against the plain blocked product, per output row as a fraction of
# the row's max|out|: the two sum each product in another order
PIM_MM_TOL = 1e-5
PIM_TOL = dict(rtol=1e-4, atol=1e-4)    # the mapper's verify tolerance



def wall_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean wall time of one ``fn()`` call that ends synchronized."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


PIM_KEYS = ("k1", "k2", "k3", "k5")


def pim_kernels():
    from repro_torch.kernels.pim_mac import (pim_mac, pim_matmul,
                                             pim_matmul_grouped,
                                             pim_matmul_grouped_q)
    return pim_matmul_grouped, pim_matmul, pim_mac, pim_matmul_grouped_q


def reset_counts() -> None:
    for k in pim_kernels():
        k.launches = 0


def read_counts() -> dict:
    return dict(zip(PIM_KEYS, (k.launches for k in pim_kernels())))


def profile_groups(name: str) -> str:
    """Kernel group of a profiled device kernel: K5 (the dequantizing
    instantiation of K1's body), K1 (with its split-K sum pass), K3,
    native convolutions (cuDNN), copies/fills/concatenations, or the
    rest."""
    name = name.lower()
    if "pim_matmul_kernel<true" in name:
        return "k5"
    if "pim_matmul" in name:
        return "k1"
    if "pim_mac_kernel" in name:
        return "k3"
    if any(k in name for k in ("conv", "cudnn", "wgrad", "dgrad", "fprop",
                               "implicit_gemm", "xmma")):
        return "native_conv"
    if any(k in name for k in ("copy", "fill", "cat", "memset", "memcpy")):
        return "copy_fill_cat"
    return "other"


def profile_device(fn, calls: int) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler`` after a warm
    call: device time by ``profile_groups`` against the host's wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups = dict.fromkeys(("k1", "k5", "k3", "native_conv",
                            "copy_fill_cat", "other"), 0.0)
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += e.count
        groups[profile_groups(e.key)] += e.self_device_time_total
    device_s = sum(groups.values()) / 1e6
    return {"calls": calls, "wall_ms_per_call": wall_s / calls * 1e3,
            "device_ms_per_call": device_s / calls * 1e3,
            "device_busy_share_under_profiler": device_s / wall_s,
            "kernels_per_call": n_kernels / calls,
            "device_ms_per_call_by_group": {
                k: v / calls / 1e3 for k, v in groups.items()}}


def faulty(fn, fault, index: int):
    """``fn`` with the ``fault`` (a function of its output) applied to the
    output of its ``index``-th call from now; ``index`` None: no fault."""
    calls = [0]

    def call(*args, **kw):
        out = fn(*args, **kw)
        calls[0] += 1
        return out if calls[0] - 1 != index else fault(out)
    return call


@contextlib.contextmanager
def recording_launches(fault=None, index=None):
    """Log the argument shapes of every K1, K2, K3 and K5 launch the
    mapper's lowering makes while open. The lowering's wrappers are
    wrapped, not replaced: they launch and count as always. With a
    ``fault``, the output of the ``index``-th K1 launch goes through it
    (``faulty``): a control that a check must catch."""
    from repro_torch.mapper import lowering
    log = {"k1": [], "k2": [], "k3": [], "k5": []}
    orig = {name: getattr(lowering, name)
            for name in ("pim_matmul_grouped", "pim_matmul", "pim_mac",
                         "pim_mac_grouped", "pim_matmul_grouped_q")}
    k1_call = faulty(orig["pim_matmul_grouped"], fault, index)

    def k1(a, b, **kw):
        log["k1"].append((b.shape[0], kw.get("col_groups", 1), a.shape[1],
                          a.shape[2], b.shape[2]))
        return k1_call(a, b, **kw)

    def k5(a, q, s, **kw):
        log["k5"].append((q.shape[0], kw.get("col_groups", 1), a.shape[1],
                          a.shape[2], q.shape[2]))
        return orig["pim_matmul_grouped_q"](a, q, s, **kw)

    def k2(a, b, **kw):
        log["k2"].append((a.shape[0], a.shape[1], b.shape[1]))
        return orig["pim_matmul"](a, b, **kw)

    def k3(a, b, acc):
        log["k3"].append(a.numel())
        return orig["pim_mac"](a, b, acc)

    def k3_wave(triples):             # one K3 launch over the whole wave
        log["k3"].append(sum(a.numel() for a, _, _ in triples))
        return orig["pim_mac_grouped"](triples)

    for name, fn in zip(orig, (k1, k2, k3, k3_wave, k5)):
        setattr(lowering, name, fn)
    try:
        yield log
    finally:
        for name, fn in orig.items():
            setattr(lowering, name, fn)


@contextlib.contextmanager
def recording_helpers(fault=None, key=None, index=None):
    """Log every single launch made through the kernel module's helpers
    ``_matmul_grouped`` (K1: G, col_groups, M, K, N), ``_matmul`` (K2: M,
    K, N), ``_mac`` (K3: elements) and ``_matmul_grouped_q`` (K5, as K1)
    while open: the autograd Functions' backward passes launch through
    them. A product logs its logical shape: with ``trans_a`` the stored
    ``a`` is [.., K, M], read as its transpose. With a ``fault``, the
    output of the ``index``-th launch of kernel ``key`` goes through it
    (``faulty``)."""
    mod = importlib.import_module("repro_torch.kernels.pim_mac")
    log = {"k1": [], "k2": [], "k3": [], "k5": []}
    names = {"k1": "_matmul_grouped", "k2": "_matmul", "k3": "_mac",
             "k5": "_matmul_grouped_q"}
    orig = {k: getattr(mod, n) for k, n in names.items()}
    calls = {k: faulty(fn, fault, index if k == key else None)
             for k, fn in orig.items()}

    def k1(a, b, bm, bn, bk, cg, trans_a=False):
        m, k = a.shape[1:][::-1] if trans_a else a.shape[1:]
        log["k1"].append((b.shape[0], cg, m, k, b.shape[2]))
        return calls["k1"](a, b, bm, bn, bk, cg, trans_a=trans_a)

    def k2(a, b, bm, bn, bk, trans_a=False):
        m, k = a.shape[::-1] if trans_a else a.shape
        log["k2"].append((m, k, b.shape[1]))
        return calls["k2"](a, b, bm, bn, bk, trans_a=trans_a)

    def k3(a, b, acc):
        log["k3"].append(a.numel())
        return calls["k3"](a, b, acc)

    def k5(a, q, s, bm, bn, bk, cg):
        log["k5"].append((q.shape[0], cg, a.shape[1], a.shape[2],
                          q.shape[2]))
        return calls["k5"](a, q, s, bm, bn, bk, cg)

    for k, fn in zip(names, (k1, k2, k3, k5)):
        setattr(mod, names[k], fn)
    try:
        yield log
    finally:
        for k, fn in orig.items():
            setattr(mod, names[k], fn)


def launch_shapes(prog, prog_log, ex_log, mm: str) -> dict:
    """The logged launches of one compiled call (``mm``: K1, or K5 on a
    quantized grid; K3) and one executor run (K2), each named by the node
    (and block) its plan step lowers: ``mm`` (G, col_groups, M, K, N) per
    placed node, K2 (M, K, N) per placed block, K3 the element count of
    each add; each row one launch (a count of 1, as ``phase_kernels_pim``
    takes them)."""
    placed = [st.node for st in prog.ctx.steps if st.kind == "placed"]
    nodes = [nd for nd in placed if nd.kind != "eltwise"]
    blocks = [f"{nd.name}@{blk.row0},{blk.col0}" for nd in nodes
              for blk in prog.schedule.placement.iter_blocks(nd.idx, 0)]
    adds = [nd.name for nd in placed if nd.kind == "eltwise"]
    want = (len(nodes), len(blocks), len(adds), prog_log["k3"])
    got = (len(prog_log[mm]), len(ex_log["k2"]), len(prog_log["k3"]),
           ex_log["k3"])
    if got != want:
        raise AssertionError(f"pim_lenet: logged launches {got[:3]} do not "
                             f"follow the plan's {want[:3]} (or the "
                             f"executor's adds differ in size)")
    return {mm: [(nd.name, *sh, 1)
                 for nd, sh in zip(nodes, prog_log[mm])],
            "k2": [(b, *sh, 1) for b, sh in zip(blocks, ex_log["k2"])],
            "k3": [(add, n, 1) for add, n in zip(adds, prog_log["k3"])]}


def seeded_params(seed: int, bias_seed: int):
    """LeNet-5 parameters from ``seed`` with seeded non-zero biases (the
    adds the mapper lowers to K3 then carry values)."""
    import torch
    from repro_torch.models import lenet
    params = lenet.init_lenet(seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(bias_seed)
    for leaves in params.values():
        leaves["b"] = torch.randn(leaves["b"].shape, generator=gen,
                                  device=DEVICE)
    return params


def fake_quant_params(params, dtype: str) -> dict:
    """Each weight as the placed block stores it, dequantized: the
    port's ``fake_quant`` per output column of its (k, n) view — every
    node of the LeNet-5 serve and loss graphs is one block on a sub-fp32
    grid, so a column's scale is the block column's. On fp32, the
    parameters themselves."""
    from repro_torch.core import quant
    if dtype == "fp32":
        return params
    return {layer: {"w": quant.fake_quant(
        v["w"].reshape(-1, v["w"].shape[-1]), dtype).reshape(v["w"].shape),
        "b": v["b"]} for layer, v in params.items()}


def phase_pim_lenet(seed: int, cases) -> dict:
    """``compile_lenet("serve", weight_dtype=grid)`` and
    ``ScheduleExecutor`` on the card for each (grid, batch) of ``cases``,
    over digit images, with seeded random parameters (non-zero biases, so
    the adds lowered to K3 carry values). Per call: 5 placed products (K1
    on fp32, K5 on a quantized grid) and 5 K3; the executor one K2 per
    placed block (7 on fp32, 5 on a quantized grid) and 5 K3; logits
    bit-equal to the executor's and within 1e-4 of plain ``lenet_apply``
    over ``fake_quant_params`` (TF32 off). The first case is the main
    path: every count set to 0 just before one program call and one
    executor run, read just after, with the shapes of their launches
    logged for ``kernels_pim``. Emitted as ``pim_lenet`` (fp32) or
    ``pim_lenet_q``."""
    import torch
    from repro_torch import mapper
    from repro_torch.data import make_digits
    from repro_torch.mapper.executor import full_float32, max_deviation
    from repro_torch.models import lenet
    params = seeded_params(seed, seed + 30)
    launches = shapes = None
    for dtype, batch in cases:
        phase = "pim_lenet" if dtype == "fp32" else "pim_lenet_q"
        mm = "k1" if dtype == "fp32" else "k5"
        blocks = 7 if dtype == "fp32" else 5
        imgs, _ = make_digits(batch, seed=seed + batch)
        x = torch.from_numpy(imgs).to(DEVICE)
        prog = mapper.compile_lenet("serve", batch=batch, weight_dtype=dtype)
        ex = mapper.ScheduleExecutor(prog.schedule)
        reset_counts()
        with recording_launches() as prog_log:
            out = prog(params, x)
        prog_counts = read_counts()
        with recording_launches() as ex_log:
            oracle = ex.run(params, x)
        torch.cuda.synchronize()
        counts = read_counts()
        ex_counts = {k: counts[k] - prog_counts[k] for k in counts}
        if launches is None:
            launches = counts
            shapes = launch_shapes(prog, prog_log, ex_log, mm)
        want = ({"k1": 0, "k2": 0, "k3": 5, "k5": 0, mm: 5},
                {"k1": 0, "k2": blocks, "k3": 5, "k5": 0})
        if (prog_counts, ex_counts) != want:
            raise AssertionError(f"{phase} {dtype} {batch}: launches "
                                 f"{prog_counts} compiled, {ex_counts} "
                                 f"per-block; want {want}")
        if (prog.matmul_launches, prog.kernel_launches,
                prog.placed_blocks) != (5, 10, blocks):
            raise AssertionError(f"{phase} {dtype} {batch}: program "
                                 f"counters")
        if out.shape != (batch, 10) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{phase} {dtype} {batch}: logits "
                                 f"{tuple(out.shape)} not finite")
        if not torch.equal(out, oracle):
            raise AssertionError(f"{phase} {dtype} {batch}: compiled "
                                 f"program and executor differ")
        stored = fake_quant_params(params, dtype)
        with torch.no_grad(), full_float32():
            err = max_deviation(out, lenet.lenet_apply(stored, x), **PIM_TOL)
            fp32_dev = float((out - lenet.lenet_apply(params, x)).abs().max())
            torch.cuda.reset_peak_memory_stats()
            prog(params, x)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            prog_ms = wall_ms(lambda: prog(params, x))
            ex_ms = wall_ms(lambda: ex.run(params, x), iters=5)
            plain_ms = wall_ms(lambda: lenet.lenet_apply(stored, x))
            prof = profile_device(lambda: prog(params, x), calls=5)
        emit({"phase": phase, "weight_dtype": dtype, "batch": batch,
              "config": "lenet5 (paper, 21655 params) serve, weights on "
                        f"the {dtype} grid, float32 accumulation",
              "launches_per_call": {"compiled": prog_counts,
                                    "per_block": ex_counts},
              "placed_blocks": prog.placed_blocks,
              "subarrays": prog.schedule.placement.n_subarrays,
              "compiled_equals_executor": True,
              "plain": "lenet_apply over the stored (fake_quant) weights",
              "max_abs_err_vs_plain": err,
              "max_abs_dev_vs_fp32_plain": fp32_dev,
              "ms_per_call": prog_ms, "images_per_s": batch / prog_ms * 1e3,
              "executor_ms_per_call": ex_ms, "plain_ms_per_call": plain_ms,
              "max_memory_allocated_gb": peak / 1e9,
              "modeled_pim_latency_s": prog.schedule.report.latency_s,
              f"{mm}_launch_shapes": prog_log[mm],
              "profile": prof})
        del out, oracle, x
        torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes}


# ---------------------------------------------------------------------------
# 8. kernels_pim: K1, K2, K3 at the shapes of a main path's launches
# ---------------------------------------------------------------------------

def pim_bound(nbytes: int, flops: int) -> tuple[float, float]:
    """(byte time, operation time) in ms: bytes over HBM rate, float32
    operations over the float32 peak."""
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / PEAK_FLOPS["float32"] * 1e3)


def pim_timing(kernel, plain, library, nbytes: int, flops: int) -> dict:
    """Kernel, plain version and library call timed, beside the bound of
    ``nbytes`` moved and ``flops`` float32 operations."""
    t_bytes, t_ops = pim_bound(nbytes, flops)
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def row_ratio(out, want, tol) -> float:
    """Max over output rows of the error against ``tol`` x the row's
    max|want|."""
    err = (out - want).abs().amax(-1)
    return float((err / (tol * want.abs().amax(-1)).clamp_min(1e-30)).max())


def mm_limit(k: int) -> float:
    """The per-row limit of a K-deep product: ``PIM_MM_TOL`` up to K = 256
    (every serve shape), then growing as sqrt(K), as the rounding of a
    K-term float32 sum does — ``pim_grad``'s dB contracts over M, up to
    147,456 terms at batch 256."""
    return PIM_MM_TOL * max(1.0, (k / 256) ** 0.5)


def split_of(g: int, m: int, k: int, n: int) -> dict:
    """The K split of a K1/K2/K5 launch of G groups of per-block shape (M,
    K, N) (``pim_mac.split_k``): S, the chunk depth and the thread blocks
    of the product. Fails if a launch with K <= 256 splits: every forward
    and dA launch keeps its one ascending chain over K."""
    from repro_torch.kernels.pim_mac import TILE_MN, chunk_depth, split_k
    splits = split_k(m, k, n)
    if k <= 256 and splits != 1:
        raise AssertionError(f"({m}, {k}, {n}) splits {splits} ways")
    return {"splits": splits, "chunk": chunk_depth(k, splits),
            "blocks": g * (m // TILE_MN) * (n // TILE_MN) * splits}


def hold_matmul(label, kernel, plain, dropped, tol=PIM_MM_TOL) -> dict:
    """Hold ``kernel()`` against ``plain()`` per output row, to ``tol`` x
    the row's max|out|; the control ``dropped()`` (the plain product
    without its last K tile) must exceed the limit."""
    import torch
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite output")
    ratio = row_ratio(out, want, tol)
    if not ratio <= 1:
        raise AssertionError(f"{label}: error {ratio} x the limit "
                             f"{tol} x max|out| of a row")
    control = row_ratio(dropped(), want, tol)
    if not control > 1:
        raise AssertionError(f"{label}: dropping the last K tile gives only "
                             f"{control} x the limit")
    return {"max_err": float((out - want).abs().max()), "tol": tol,
            "max_err_over_limit": ratio, "control_over_limit": control,
            "out": out}


def counted(rows) -> list:
    """Each distinct launch shape (a tuple, or K3's element count) once,
    with its number of launches last."""
    return [(*(row if isinstance(row, tuple) else (row,)), n)
            for row, n in collections.Counter(rows).items()]


def phase_kernels_pim(seed: int, shapes: dict, path: str, batch: int,
                      wave: bool = False) -> dict:
    """K1, K2 and K3 at the ``shapes`` of one of ``path``'s main-path runs,
    each distinct shape once with its number of launches (``counted``), on
    seeded random data, against their plain versions on the card, and
    timed: kernel, plain version, bound (each operand read once and the
    output written once; 2 MK N float32 operations for a product, 2 per
    MAC element) and the library call — ``torch.bmm`` on the same padded
    stacks (shared-A slabs repeated beforehand, untimed) for K1,
    ``torch.mm`` for K2, both with TF32 off, and ``torch.addcmul`` for K3
    (time only: it may round once). K1 and K2 are held per output row to
    ``mm_limit`` of their contraction; K3 bit for bit. Each K1 and K2 row
    records its K split (``split_of``: S = 1 at every K <= 256), and a K1
    launch equals K2 on each block and itself on a second run bit for
    bit. With ``wave`` the K3 launches (one per add) are also made as one
    grouped wave."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import (pim_mac, pim_mac_grouped,
                                             pim_matmul, pim_matmul_grouped)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    k1 = []
    for name, g, cg, m, k, n, count in shapes["k1"]:
        a, b = randn(g // cg, m, k), randn(g, k, n)
        r = hold_matmul(
            f"K1 {path} {name}",
            lambda: pim_matmul_grouped(a, b, col_groups=cg),
            lambda: ref.pim_matmul_grouped_ref(a, b, col_groups=cg),
            lambda: ref.pim_matmul_grouped_ref(a[..., :k - 128],
                                               b[:, :k - 128],
                                               col_groups=cg),
            mm_limit(k))
        out = r.pop("out")
        for i in range(g):              # K1 == K2 on the same blocks
            if not torch.equal(out[i], pim_matmul(a[i // cg], b[i])):
                raise AssertionError(f"K1 {path} {name}: group {i} differs "
                                     f"from K2")
        if not torch.equal(out, pim_matmul_grouped(a, b, col_groups=cg)):
            raise AssertionError(f"K1 {path} {name}: a second run differs")
        a_rep = a.repeat_interleave(cg, 0)
        k1.append({"node": name, "G": g, "col_groups": cg, "M": m, "K": k,
                   "N": n, "count": count, **r, **split_of(g, m, k, n),
                   "k1_equals_k2": True, "rerun_equal": True,
                   **pim_timing(
                       lambda: pim_matmul_grouped(a, b, col_groups=cg),
                       lambda: ref.pim_matmul_grouped_ref(a, b,
                                                          col_groups=cg),
                       lambda: torch.bmm(a_rep, b),
                       4 * (a.numel() + b.numel() + g * m * n),
                       2 * g * m * k * n)})
        del a, b, a_rep, out
    k2 = []
    for name, m, k, n, count in shapes["k2"]:
        a, b = randn(m, k), randn(k, n)
        r = hold_matmul(f"K2 {path} {name}", lambda: pim_matmul(a, b),
                        lambda: ref.pim_matmul_ref(a, b),
                        lambda: ref.pim_matmul_ref(a[:, :k - 128],
                                                   b[:k - 128]),
                        mm_limit(k))
        r.pop("out")
        k2.append({"block": name, "M": m, "K": k, "N": n, "count": count,
                   **r, **split_of(1, m, k, n),
                   **pim_timing(
                       lambda: pim_matmul(a, b),
                       lambda: ref.pim_matmul_ref(a, b),
                       lambda: torch.mm(a, b),
                       4 * (a.numel() + b.numel() + m * n),
                       2 * m * k * n)})
        del a, b
    k3 = []
    waves = []
    for name, n, count in shapes["k3"] + ([("wave", None, 0)] if wave
                                          else []):
        if n is None:                   # the adds as one K3 launch
            flat = [torch.cat([t[i] for t in waves]) for i in range(3)]
            got = pim_mac_grouped(waves)
            if not all(torch.equal(x, pim_mac(*t))
                       for x, t in zip(got, waves)):
                raise AssertionError(f"K3 {path} wave: differs from per-add "
                                     f"K3")
            a, b, acc = flat
            n = a.numel()
        else:
            a, b, acc = randn(n), randn(n), randn(n)
            if wave:
                waves.append((a, b, acc))
        out, want = pim_mac(a, b, acc), ref.pim_mac_ref(a, b, acc)
        if not torch.equal(out, want):
            raise AssertionError(f"K3 {path} {name}: not bit-equal to the "
                                 f"plain version")
        fused = int((torch.addcmul(acc, a, b) != out).sum())
        k3.append({"node": name, "n": n, "count": count,
                   "max_err": float((out - want).abs().max()),
                   "bit_equal": True,
                   "addcmul_elements_differing": fused,
                   **pim_timing(
                       lambda: pim_mac(a, b, acc),
                       lambda: ref.pim_mac_ref(a, b, acc),
                       lambda: torch.addcmul(acc, a, b),
                       16 * n, 2 * n)})
    del waves
    torch.cuda.empty_cache()
    emit({"phase": "kernels_pim", "path": path, "batch": batch,
          "tol": "mm_limit(K)",
          "results": [{**K1, "shapes": k1}, {**K2, "shapes": k2},
                      {**K3, "shapes": k3}]})
    return {"k1": k1, "k2": k2, "k3": [r for r in k3 if r["count"]]}


# ---------------------------------------------------------------------------
# 9. pim_train: LeNet-5 training through the mapper, Trainer(backend="pim")
# ---------------------------------------------------------------------------

# batch 64 is the reference example's (examples/train_lenet.py); at 4096
# the card, not the host, should set the pace
TRAIN_BATCHES = (64, 4096)
TRAIN_STEPS = 301          # the batch-64 pim run: loss at step 300 < step 0
TRAIN_PARITY_STEPS = 10    # pim against the plain step, loss by loss
TRAIN_BIG_STEPS = 20       # the batch-4096 run
TRAIN_LR = 2e-3            # AdamW, as the reference's example and test
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)   # the reference's pim-vs-jit test
PIM_GRAD_BATCH = 256
PIM_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # the reference's _tree_close


def adamw_train_step(opt):
    """The reference example's step: loss and grads of ``lenet_loss``,
    then one AdamW update."""
    import torch
    from repro_torch.models import lenet

    def train_step(params, opt_state, batch):
        imgs, labels = batch
        grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
            params, imgs, labels)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss
    return train_step


def make_trainer(backend, params0, batches, steps, ckpt_dir, **kw):
    """A ``Trainer`` on the card from copies of ``params0``, AdamW at
    ``TRAIN_LR``; ``batches`` holds each step's batch, made beforehand on
    the card (``DigitsDataset(seed=0)``), so a step's time is the step's
    own. One checkpoint, at the end. ``kw`` goes to the ``Trainer``
    (``weight_dtype``)."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer, TrainerConfig
    opt = make_optimizer("adamw", lr=TRAIN_LR)

    def init_state():
        p = {k: {j: v.clone() for j, v in layer.items()}
             for k, layer in params0.items()}
        return p, opt.init(p)

    tc = TrainerConfig(total_steps=steps, ckpt_every=steps + 1,
                       ckpt_dir=str(ckpt_dir), async_ckpt=False)
    return Trainer(tc, train_step=adamw_train_step(opt),
                   init_state=init_state, batch_fn=batches.__getitem__,
                   backend=backend, device=DEVICE, **kw)


def digit_batches(batch: int, steps: int) -> list:
    import torch
    from repro_torch.data import DigitsDataset
    ds = DigitsDataset(batch_size=batch, seed=0)
    return [tuple(torch.from_numpy(x).to(DEVICE) for x in ds.batch(s))
            for s in range(steps)]


def step_wall_s() -> dict:
    """``train.step_wall_s`` of the run since the registry's reset, and
    the mean of its steps after the first (which pays the first launches
    and cuDNN's set-up; ``train.first_step_wall_s``)."""
    from repro_torch import obs
    snap = obs.metrics().snapshot()
    h = snap["histograms"]["train.step_wall_s"]
    first = snap["gauges"]["train.first_step_wall_s"]
    return {**{k: h[k] for k in ("count", "mean", "p50", "p95", "max")},
            "first_s": first,
            "steady_mean": (h["sum"] - first) / (h["count"] - 1)}


def leaves_differing(a, b) -> dict:
    """The leaves of two pytrees that are not bit-equal, with their
    largest difference."""
    from repro_torch._tree import leaves_with_path
    la, lb = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    if la.keys() != lb.keys():
        return {"structure": f"{sorted(la)} != {sorted(lb)}"}
    return {p: float((la[p].double() - lb[p].double()).abs().max())
            for p in la if not la[p].equal(lb[p])}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: the native backward convolutions
    may otherwise sum in an order that changes from run to run, and no
    two runs could be held bit for bit."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def phase_pim_train(seed: int) -> dict:
    """``Trainer(backend="pim")`` and ``Trainer(backend="jit")`` (the plain
    eager step) on the card from the same seeded parameters, TF32 off.
    The batch-64 pim run is the main path: every count set to 0 just
    before its 301 steps and read just after. Then one compiled step
    against the per-block executor, bit for bit, with the shapes of both
    logged for ``kernels_pim``, and a profile of the compiled step; then
    20 steps at batch 4096 with a profile of the compiled step."""
    import tempfile

    import torch
    from repro_torch import mapper, obs
    from repro_torch.mapper.executor import full_float32
    from repro_torch.models import lenet
    from repro_torch.optim import make_optimizer
    params0 = lenet.init_lenet(seed, device=DEVICE)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, full_float32():
        tmp = pathlib.Path(tmp)
        batch = TRAIN_BATCHES[0]
        batches = digit_batches(batch, TRAIN_STEPS)
        t0 = time.perf_counter()
        pim = make_trainer("pim", params0, batches, TRAIN_STEPS, tmp / "p")
        build_s = time.perf_counter() - t0
        prog = pim.pim_program
        obs.metrics().reset()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = pim.run()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        wall = step_wall_s()
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
        if (counts["k2"] or counts["k5"] or counts["k1"] != 11 * TRAIN_STEPS
                or counts["k3"] % TRAIN_STEPS or not counts["k3"]):
            raise AssertionError(f"pim_train: launches {counts} over "
                                 f"{TRAIN_STEPS} steps; want 11 K1 and a "
                                 f"fixed number of K3 per step, no K2")
        losses = res["losses"]
        if not all(np.isfinite(losses)):
            raise AssertionError("pim_train: non-finite loss")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"pim_train: loss {losses[-1]} at step "
                                 f"{TRAIN_STEPS - 1} not below {losses[0]}")
        jit = make_trainer("jit", params0, batches, TRAIN_PARITY_STEPS,
                           tmp / "j")
        obs.metrics().reset()
        jit_losses = jit.run()["losses"]
        jit_wall = step_wall_s()
        np.testing.assert_allclose(losses[:TRAIN_PARITY_STEPS], jit_losses,
                                   **LOSS_TOL)
        ex = mapper.ScheduleExecutor(prog.schedule, device=DEVICE)
        state = (pim.params, pim.opt_state, batches[0])
        with deterministic_cudnn():
            with recording_launches() as prog_log:
                got = prog(*state)
            c0 = read_counts()
            with recording_launches() as ex_log:
                want = ex.run(*state)
            torch.cuda.synchronize()
            c1 = read_counts()
            again = prog(*state)
        ex_counts = {k: c1[k] - c0[k] for k in c1}
        diff = leaves_differing(got, want)
        if diff or leaves_differing(got, again):
            raise AssertionError(f"pim_train: compiled step and executor "
                                 f"differ: {diff}; program run twice: "
                                 f"{leaves_differing(got, again)}")
        if (ex_counts["k1"] or ex_counts["k2"] != len(ex_log["k2"])
                or len(prog_log["k3"]) != per_step["k3"]):
            raise AssertionError(f"pim_train: executor launches "
                                 f"{ex_counts}, logged {len(ex_log['k2'])}")
        prof = profile_device(lambda: prog(*state), calls=3)
        emit({"phase": "pim_train", "batch": batch,
              "config": "lenet5 (paper, 21655 params) AdamW lr 2e-3, "
                        "float32, DigitsDataset(seed=0)",
              "steps": TRAIN_STEPS, "build_s": build_s,
              "losses_first": losses[:TRAIN_PARITY_STEPS],
              "loss_last": losses[-1],
              "plain_losses_first": jit_losses,
              "max_loss_dev_vs_plain": float(np.max(np.abs(
                  np.subtract(losses[:TRAIN_PARITY_STEPS], jit_losses)))),
              "launches_per_step": per_step,
              "executor_launches_per_step": ex_counts,
              "compiled_equals_executor": True,
              "nodes": len(prog.schedule.graph.nodes),
              "placed_blocks": prog.placed_blocks,
              "ms_per_step": wall["steady_mean"] * 1e3,
              "images_per_s": batch / wall["steady_mean"],
              "plain_ms_per_step": jit_wall["steady_mean"] * 1e3,
              "train.step_wall_s": wall,
              "plain_train.step_wall_s": jit_wall,
              "max_memory_allocated_gb": peak / 1e9,
              "modeled_pim_latency_s": prog.schedule.report.latency_s,
              "profile": prof})
        out["launches"] = counts
        out["executor_launches"] = ex_counts
        out["losses"] = losses
        out["ms_per_step"] = wall["steady_mean"] * 1e3
        out["shapes"] = {"k1": prog_log["k1"], "k2": ex_log["k2"],
                         "k3": prog_log["k3"]}
        del pim, jit, got, want, again, state, batches, ex
        torch.cuda.empty_cache()

        batch = TRAIN_BATCHES[1]
        batches = digit_batches(batch, TRAIN_BIG_STEPS)
        big = make_trainer("pim", params0, batches, TRAIN_BIG_STEPS,
                           tmp / "b")
        torch.cuda.reset_peak_memory_stats()
        obs.metrics().reset()
        losses = big.run()["losses"]
        wall = step_wall_s()
        ms = wall["steady_mean"] * 1e3
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            raise AssertionError("pim_train 4096: non-finite loss")
        prog = big.pim_program
        state = (big.params, big.opt_state, batches[0])
        plain = adamw_train_step(make_optimizer("adamw", lr=TRAIN_LR))
        plain_ms = wall_ms(lambda: plain(*state), iters=5)
        prog_ms = wall_ms(lambda: prog(*state), iters=5)
        prof = profile_device(lambda: prog(*state), calls=3)
        emit({"phase": "pim_train", "batch": batch,
              "steps": TRAIN_BIG_STEPS, "losses": losses,
              "ms_per_step": ms, "images_per_s": batch / ms * 1e3,
              "train.step_wall_s": wall,
              "program_ms_per_call": prog_ms,
              "plain_ms_per_step": plain_ms,
              "max_memory_allocated_gb": peak / 1e9,
              "placed_blocks": prog.placed_blocks,
              "profile": prof})
        del big, batches, state
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 10. pim_grad: autograd through a compiled lenet_loss program
# ---------------------------------------------------------------------------


def backward_nodes(loss) -> dict:
    """The kernel nodes of ``loss``'s autograd graph, each by its saved
    operands and the cotangents autograd will ask of it: K1 (A's shape,
    B's shape, tiles, (dA, dB) wanted), K2 (as K1), K5 (A's shape, Q's
    shape, tiles, (dA, dq, ds) wanted), K3 (elements, (da, db, dacc)
    wanted). Fails if a native matrix product or convolution is in the
    graph."""
    nodes = {"k1": [], "k2": [], "k3": [], "k5": []}
    seen, stack = set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        name = type(fn).__name__
        if name in ("MmBackward0", "BmmBackward0", "ConvolutionBackward0",
                    "AddmmBackward0"):
            raise AssertionError(f"pim_grad: native {name} in the graph")
        wanted = tuple(f is not None for f, _ in fn.next_functions)
        if name in ("_MatmulGroupedBackward", "_MatmulBackward"):
            a, b = fn.saved_tensors
            key = "k1" if name == "_MatmulGroupedBackward" else "k2"
            nodes[key].append((tuple(a.shape), tuple(b.shape), fn.tiles,
                               wanted[:2]))
        elif name == "_MatmulGroupedQBackward":
            a, q, _ = fn.saved_tensors
            nodes["k5"].append((tuple(a.shape), tuple(q.shape), fn.tiles,
                                wanted[:3]))
        elif name == "_MacBackward":
            nodes["k3"].append((fn.saved_tensors[0].numel(), wanted))
        stack.extend(f for f, _ in fn.next_functions)
    return nodes


def asked(nodes) -> dict:
    """The backward launches ``nodes`` ask of K1, K2 and K3: one per
    operand that wants a cotangent (K3's accumulator takes the cotangent
    as it is; K5's dA and dq are K1 launches, its ds none)."""
    return {"k1": sum(sum(w[:2]) for *_, w in nodes["k1"] + nodes["k5"]),
            "k2": sum(sum(w) for *_, w in nodes["k2"]),
            "k3": sum(sum(w[:2]) for _, w in nodes["k3"])}


def close_ratio(got, want, rtol: float, atol: float) -> float:
    """Max over the leaves' elements of |got - want| / (atol + rtol x
    |want|): above 1 fails ``max_deviation`` at the same rtol and atol."""
    from torch.utils import _pytree as pytree
    return max(float(((g - w).abs() / (atol + rtol * w.abs())).max())
               for g, w in zip(pytree.tree_leaves(got),
                               pytree.tree_leaves(want), strict=True)
               if g.numel())


def grad_magnitudes(grads, rtol: float, atol: float) -> dict:
    """Per leaf: max and median |grad|, and the smallest error in the
    leaf's scale that the rtol/atol check catches (rtol + atol /
    max|grad|)."""
    from repro_torch._tree import leaves_with_path
    out = {}
    for path, v in leaves_with_path(grads):
        top = float(v.abs().max())
        out[path] = {"max_abs": top, "median_abs": float(v.abs().median()),
                     "catches_scale_error_above": rtol + atol / top}
    return out


def grad_controls(run, launches: dict, plain) -> dict:
    """``run(fault, key, index)`` gives gradients with ``fault`` applied
    to the output of launch ``index`` of kernel ``key``. Each launch in
    ``launches`` is dropped (zeroed) and, apart, scaled by 1.01, one at a
    time; every dropped launch must fail the gradient check against
    ``plain``, and the scaled ones' readings (error over the limit) say
    how fine an error the check sees."""
    import torch
    out = {}
    for key, n in launches.items():
        dropped = [close_ratio(run(torch.zeros_like, key, i), plain,
                               **PIM_GRAD_TOL) for i in range(n)]
        scaled = [close_ratio(run(lambda t: t * 1.01, key, i), plain,
                              **PIM_GRAD_TOL) for i in range(n)]
        if not all(r > 1 for r in dropped):
            raise AssertionError(f"pim_grad: a dropped {key} launch passes "
                                 f"the gradient check: {dropped}")
        out[key] = {"dropped_over_limit": dropped,
                    "scaled_1pct_over_limit": scaled}
    return out


def phase_pim_grad(seed: int, weight_dtype: str = "fp32") -> dict:
    """Gradients of ``lenet_loss`` at batch 256 through the mapper with the
    weights on ``weight_dtype``'s grid, against ``torch.func.grad`` of the
    plain loss taken at ``fake_quant_params`` (TF32 off; with the
    straight-through quantizer the weight gradient is Aᵀg at the stored
    point), rtol = atol = 1e-4. ``autograd``: autograd through
    ``compile_schedule(build_schedule(lenet_loss))`` — the main path,
    counts set to 0 just before the program's call and its backward,
    read after each. The forward is 5 placed products (K1, or K5 on a
    quantized grid, the path of K5's VJP and the straight-through
    quantizer) and 5 K3; the backward's K1 and K3 launches must be every
    cotangent autograd asked for (K5's dA and dq are K1 launches), and
    their shapes are logged for the backward kernel checks. On fp32 also
    ``grad_graph``: the compiled program of ``torch.func.grad(lenet_loss)``
    itself, whose backward products are K1 launches of the graph, as in
    the train step. For each, the typical |grad| per leaf beside the
    limit, and controls: each K1 and K3 launch of the backward dropped,
    then scaled by 1.01. The autograd step's wall time and a profile of
    its device time by kernel group (``profile_device``). Emitted as
    ``pim_grad`` or ``pim_grad_q``."""
    import torch
    from repro_torch import mapper
    from repro_torch.data import make_digits
    from repro_torch.mapper.executor import full_float32, max_deviation
    from repro_torch.models import lenet
    phase = "pim_grad" if weight_dtype == "fp32" else "pim_grad_q"
    mm = "k1" if weight_dtype == "fp32" else "k5"
    batch = PIM_GRAD_BATCH
    params = seeded_params(seed, seed + 40)
    imgs, labels = make_digits(batch, seed=seed + 41)
    x = torch.from_numpy(imgs).to(DEVICE)
    y = torch.from_numpy(labels).to(DEVICE)
    abstract = (mapper.abstract_like(params),
                *mapper.abstract_like((x, y)))
    prog = mapper.compile_schedule(
        mapper.build_schedule(lenet.lenet_loss, *abstract,
                              weight_dtype=weight_dtype),
        use_cache=False, device=DEVICE)
    tree = {k: {j: v.clone().requires_grad_(True) for j, v in layer.items()}
            for k, layer in params.items()}
    leaves = [v for layer in tree.values() for v in layer.values()]

    def as_tree(grads):
        it = iter(grads)
        return {k: {j: next(it) for j in layer} for k, layer in tree.items()}

    with full_float32():
        reset_counts()
        loss = prog(tree, x, y)
        torch.cuda.synchronize()
        forward = read_counts()
        if forward != {"k1": 0, "k2": 0, "k3": 5, "k5": 0, mm: 5}:
            raise AssertionError(f"{phase}: forward launches {forward}")
        nodes = backward_nodes(loss)
        want = asked(nodes)
        reset_counts()
        with recording_helpers() as launched:
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        backward = read_counts()
        if ((backward["k1"], backward["k3"]) != (want["k1"], want["k3"])
                or backward["k2"] or backward["k5"] or not backward["k1"]
                or not backward["k3"]):
            raise AssertionError(f"{phase}: backward launches {backward}, "
                                 f"autograd asked for {want}")
        stored = fake_quant_params(params, weight_dtype)
        plain = torch.func.grad(lenet.lenet_loss)(stored, x, y)
        err = max_deviation(as_tree(grads), plain, **PIM_GRAD_TOL)

        def autograd_run(fault, key, index):
            loss = prog(tree, x, y)
            with recording_helpers(fault, key, index):
                return as_tree(torch.autograd.grad(loss, leaves))

        controls = grad_controls(
            autograd_run, {k: want[k] for k in ("k1", "k3")}, plain)

        def step():
            return torch.autograd.grad(prog(tree, x, y), leaves)

        ms = wall_ms(step, iters=10)
        prof = profile_device(step, 5)
        plain_ms = wall_ms(lambda: torch.func.grad(lenet.lenet_loss)(
            stored, x, y), iters=10)
        graph = (grad_graph_check(abstract, params, x, y, plain)
                 if weight_dtype == "fp32" else None)
        executor = (executor_grad_check(prog.schedule, tree, leaves, as_tree,
                                        x, y, grads, plain)
                    if weight_dtype == "fp32" else None)
    emit({"phase": phase, "batch": batch, "weight_dtype": weight_dtype,
          "tol": PIM_GRAD_TOL,
          "grad_magnitudes": grad_magnitudes(plain, **PIM_GRAD_TOL),
          "autograd": {"launches_forward": forward,
                       "launches_backward": backward,
                       "cotangents_asked": want, f"{mm}_nodes": nodes[mm],
                       "max_abs_err_vs_plain": err, "controls": controls,
                       "ms_forward_backward": ms, "profile": prof},
          "grad_graph": graph,
          "executor": executor and {k: v for k, v in executor.items()
                                    if k not in ("nodes", "launched")},
          "plain_ms": plain_ms})
    return {"forward": forward, "backward": backward, "nodes": nodes,
            "launched": launched, "executor": executor}


def executor_grad_check(schedule, tree, leaves, as_tree, x, y, prog_grads,
                        plain) -> dict:
    """Autograd through the per-block executor (``ScheduleExecutor.run``)
    of the same ``lenet_loss`` schedule: counts set to 0 just before its
    forward and its backward, read after each. The forward is 7 K2 (one
    per placed block) and 5 K3; the backward's K2 launches (K2's VJP
    ``_Matmul``) and K3 launches must be every cotangent autograd asked
    of them, with no K1 or K5. Its gradients agree with the compiled
    program's and with plain autograd's (``plain``) within rtol = atol =
    1e-4; whether they equal the compiled program's bit for bit is
    recorded, and its step is profiled as the compiled one's."""
    import torch
    from repro_torch import mapper
    from repro_torch.mapper.executor import max_deviation
    ex = mapper.ScheduleExecutor(schedule, device=DEVICE)
    reset_counts()
    loss = ex.run(tree, x, y)
    torch.cuda.synchronize()
    forward = read_counts()
    if forward != {"k1": 0, "k2": 7, "k3": 5, "k5": 0}:
        raise AssertionError(f"pim_grad executor: forward launches "
                             f"{forward}")
    nodes = backward_nodes(loss)
    want = asked(nodes)
    reset_counts()
    with recording_helpers() as launched:
        flat = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    backward = read_counts()
    grads = as_tree(flat)
    if ((backward["k2"], backward["k3"]) != (want["k2"], want["k3"])
            or backward["k1"] or backward["k5"] or not backward["k2"]):
        raise AssertionError(f"pim_grad executor: backward launches "
                             f"{backward}, autograd asked for {want}")
    err_plain = max_deviation(grads, plain, **PIM_GRAD_TOL)
    err_prog = max_deviation(grads, as_tree(prog_grads), **PIM_GRAD_TOL)

    def step():
        return torch.autograd.grad(ex.run(tree, x, y), leaves)

    ms = wall_ms(step, iters=5)
    return {"launches_forward": forward, "launches_backward": backward,
            "cotangents_asked": want, "k2_nodes": nodes["k2"],
            "max_abs_err_vs_plain": err_plain,
            "max_abs_dev_vs_compiled": err_prog,
            "bit_equal_to_compiled": all(map(torch.equal, flat, prog_grads)),
            "ms_forward_backward": ms, "profile": profile_device(step, 3),
            "nodes": nodes, "launched": launched}


def grad_graph_check(abstract, params, x, y, plain) -> dict:
    """The compiled program of ``torch.func.grad(lenet_loss)`` (fp32): 11
    K1 launches, some K3, no K2; its gradients against ``plain``, with
    each K1 launch dropped and scaled as in ``grad_controls``."""
    import torch
    from repro_torch import mapper
    from repro_torch.mapper.executor import max_deviation
    from repro_torch.models import lenet
    gprog = mapper.compile_schedule(
        mapper.build_schedule(torch.func.grad(lenet.lenet_loss), *abstract),
        use_cache=False, device=DEVICE)
    reset_counts()
    with recording_launches() as glog:
        ggrads = gprog(params, x, y)
    torch.cuda.synchronize()
    gcounts = read_counts()
    if gcounts["k2"] or gcounts["k1"] != 11 or not gcounts["k3"]:
        raise AssertionError(f"pim_grad: grad graph launches {gcounts}; "
                             f"want 11 K1, some K3, no K2")
    gerr = max_deviation(ggrads, plain, **PIM_GRAD_TOL)

    def graph_run(fault, key, index):
        with recording_launches(fault, index):
            return gprog(params, x, y)

    gcontrols = grad_controls(graph_run, {"k1": len(glog["k1"])}, plain)
    gms = wall_ms(lambda: gprog(params, x, y), iters=10)
    return {"launches": gcounts, "max_abs_err_vs_plain": gerr,
            "controls": gcontrols, "ms": gms}


# ---------------------------------------------------------------------------
# 11. kernels_pim, backward: the VJPs of K1 and K3 at pim_grad's shapes
# ---------------------------------------------------------------------------


def phase_kernels_pim_backward(seed: int, grad_run: dict) -> dict:
    """The backward of each K1 and K3 node of ``pim_grad``'s autograd
    graph (``backward_nodes``), each distinct node once with its count:
    random operands of the node's shapes, the cotangents it was asked for
    through its autograd Function, whose launches, over every node, must
    be those the main path's backward made. Each launch is held against
    the plain formula on the plain kernels (K1 each output row to
    ``mm_limit`` of its contraction, with the dropped-K-tile control; K3
    bit for bit) and timed with its bound and a library call (``bmm``
    with TF32 off, on Aᵀ as a view for dB; ``mul``). Each K1 and K2
    launch records its K split (``split_of``), equals itself on a second
    run and the other kernel on the same blocks bit for bit (K1 group by
    group against K2; K2 against K1 with one group), and dB, which reads
    Aᵀ in place, equals the launch on the materialized transpose; dB's
    row also times that launch and the transpose copy it no longer
    needs. K2's VJP is held and timed the same way (``mm``) at each K2
    node of the executor's autograd graph in ``pim_grad``; its launches
    must be those of the executor's backward. ``split_db`` gathers each
    split dB launch's numbers."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import (pim_mac, pim_matmul,
                                             pim_matmul_grouped)
    mod = importlib.import_module("repro_torch.kernels.pim_mac")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 50)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    def segsum(x, cg):
        return x.reshape(x.shape[0] // cg, cg, *x.shape[1:]).sum(1)

    def cotangents(fn, operands, wanted, g):
        """``fn``'s cotangents for the operands ``wanted``, and the
        launches they made."""
        leaves = [t.clone().requires_grad_(w)
                  for t, w in zip(operands, wanted)]
        out = fn(*leaves)
        with recording_helpers() as log:
            got = torch.autograd.grad(out, [t for t in leaves
                                            if t.requires_grad], g)
        it = iter(got)
        return [next(it) if w else None for w in wanted], log

    def same_bits(label, launch, out, others) -> dict:
        """``launch()`` a second time equals ``out`` bit for bit, and so
        does each ``(i, other)``: ``out[i] == other()``."""
        if not torch.equal(launch(), out):
            raise AssertionError(f"{label}: a second run differs")
        for i, other in others:
            if not torch.equal(out[i], other()):
                raise AssertionError(f"{label}: block {i} differs from the "
                                     f"other kernel's launch")
        return {"rerun_equal": True, "k1_equals_k2": True}

    made = collections.Counter()
    k1 = []
    for a_shape, b_shape, (bm, bn, bk, cg), wanted, count in counted(
            grad_run["nodes"]["k1"]):
        a, b = randn(*a_shape), randn(*b_shape)
        g_, k, n = b_shape
        m = a_shape[1]
        g = randn(g_, m, n)
        (da, db), log = cotangents(
            lambda p, q: pim_matmul_grouped(p, q, bm=bm, bn=bn, bk=bk,
                                            col_groups=cg),
            (a, b), wanted, g)
        for sh in log["k1"]:
            made["k1", sh] += count
        lead = {"G": g_, "col_groups": cg, "M": m, "K": k, "N": n,
                "count": count}
        if da is not None:             # dA = K1(g, Bᵀ), summed over groups
            bt = b.transpose(1, 2).contiguous()
            r = hold_matmul(
                f"K1 dA {lead}",
                lambda: segsum(pim_matmul_grouped(g, bt), cg),
                lambda: segsum(ref.pim_matmul_grouped_ref(g, bt), cg),
                lambda: segsum(ref.pim_matmul_grouped_ref(
                    g[..., :n - 128], bt[:, :n - 128]), cg),
                mm_limit(n))
            if not torch.equal(r.pop("out"), da):
                raise AssertionError(f"K1 dA {lead}: autograd differs from "
                                     f"the launch")
            raw = pim_matmul_grouped(g, bt)
            k1.append({"cotangent": "dA", "shared_a": cg > 1, **lead, **r,
                       **split_of(g_, m, n, k),
                       **same_bits(f"K1 dA {lead}",
                                   lambda: pim_matmul_grouped(g, bt), raw,
                                   [(i, lambda i=i: pim_matmul(g[i], bt[i]))
                                    for i in range(g_)]),
                       **pim_timing(
                           lambda: pim_matmul_grouped(g, bt),
                           lambda: ref.pim_matmul_grouped_ref(g, bt),
                           lambda: torch.bmm(g, bt),
                           4 * (g.numel() + bt.numel() + g_ * m * k),
                           2 * g_ * m * k * n)})
            del bt, raw
        if db is not None:             # dB = K1(Aᵀ, g, col_groups)
            at = a.transpose(1, 2).contiguous()

            def in_place():            # the main path's launch: Aᵀ read
                return mod._matmul_grouped(a, g, bk, bn, bm, cg,
                                           trans_a=True)

            r = hold_matmul(
                f"K1 dB {lead}", in_place,
                lambda: ref.pim_matmul_grouped_ref(at, g, col_groups=cg),
                lambda: ref.pim_matmul_grouped_ref(at[..., :m - 128],
                                                   g[:, :m - 128],
                                                   col_groups=cg),
                mm_limit(m))
            out = r.pop("out")
            if not (torch.equal(out, db) and torch.equal(
                    out, pim_matmul_grouped(at, g, col_groups=cg))):
                raise AssertionError(f"K1 dB {lead}: autograd, the launch "
                                     f"and the launch on the materialized "
                                     f"transpose differ")
            a_rep = a.repeat_interleave(cg, 0)
            row = {"cotangent": "dB", "shared_a": cg > 1, **lead, **r,
                   **split_of(g_, k, m, n),
                   **same_bits(f"K1 dB {lead}", in_place, out,
                               [(i, lambda i=i: mod._matmul(
                                   a[i // cg], g[i], bk, bn, bm,
                                   trans_a=True)) for i in range(g_)]),
                   "in_place_equals_materialized": True,
                   "materialized_ms": cuda_ms(
                       lambda: pim_matmul_grouped(at, g, col_groups=cg)),
                   "transpose_copy_ms": cuda_ms(
                       lambda: a.transpose(1, 2).contiguous()),
                   **pim_timing(
                       in_place,
                       lambda: ref.pim_matmul_grouped_ref(
                           at, g, col_groups=cg),
                       lambda: torch.bmm(a_rep.transpose(1, 2), g),
                       4 * (a.numel() + g.numel() + g_ * k * n),
                       2 * g_ * m * k * n)}
            k1.append(row)
            del at, a_rep, out
        del a, b, g, da, db
    k3 = []
    for n, wanted, count in counted(grad_run["nodes"]["k3"]):
        a, b, acc, g = randn(n), randn(n), randn(n), randn(n)
        zero = torch.zeros_like(g)
        (da, db, dacc), log = cotangents(pim_mac, (a, b, acc), wanted, g)
        for sh in log["k3"]:
            made["k3", sh] += count
        if dacc is not None and not torch.equal(dacc, g):
            raise AssertionError(f"K3 dacc {n}: not the cotangent")
        for name, other, got in (("da", b, da), ("db", a, db)):
            if got is None:
                continue
            out = pim_mac(g, other, zero)
            if not (torch.equal(out, got)
                    and torch.equal(out, ref.pim_mac_ref(g, other, zero))):
                raise AssertionError(f"K3 {name} {n}: not bit-equal to the "
                                     f"plain version")
            # the function is g * other: 12 n bytes, n operations; the
            # zero accumulator the VJP reads is overhead against that
            k3.append({"cotangent": name, "n": n, "count": count,
                       "max_err": 0.0, "bit_equal": True,
                       **pim_timing(
                           lambda: pim_mac(g, other, zero),
                           lambda: ref.pim_mac_ref(g, other, zero),
                           lambda: torch.mul(g, other),
                           12 * n, n)})
    path = collections.Counter(
        {(key, sh): c for key in ("k1", "k3") for sh, c in
         collections.Counter(grad_run["launched"][key]).items()})
    if made != path:
        raise AssertionError(f"kernels_pim backward: the held nodes launch "
                             f"{sorted(made.items())}, pim_grad's backward "
                             f"{sorted(path.items())}")
    k2 = []
    made_k2 = collections.Counter()
    for a_shape, b_shape, (bm, bn, bk), wanted, count in counted(
            grad_run["executor"]["nodes"]["k2"]):
        a, b = randn(*a_shape), randn(*b_shape)
        (m, k), n = a_shape, b_shape[1]
        g = randn(m, n)
        (da, db), log = cotangents(
            lambda p, q: pim_matmul(p, q, bm=bm, bn=bn, bk=bk), (a, b),
            wanted, g)
        for sh in log["k2"]:
            made_k2[sh] += count
        lead = {"M": m, "K": k, "N": n, "count": count}
        bt = b.T.contiguous()
        at = a.T.contiguous()
        # (name, the main path's launch, its operands as materialized,
        # the contraction, the cotangent autograd gave)
        for name, launch, lhs, rhs, c, got in (
                ("dA", lambda: pim_matmul(g, bt), g, bt, n, da),
                ("dB", lambda: mod._matmul(a, g, bk, bn, bm, trans_a=True),
                 at, g, m, db)):
            if got is None:
                continue
            r = hold_matmul(f"K2 {name} {lead}", launch,
                            lambda: ref.pim_matmul_ref(lhs, rhs),
                            lambda: ref.pim_matmul_ref(lhs[:, :c - 128],
                                                       rhs[:c - 128]),
                            mm_limit(c))
            out = r.pop("out")
            if not (torch.equal(out, got)
                    and torch.equal(out, pim_matmul(lhs, rhs))):
                raise AssertionError(f"K2 {name} {lead}: autograd, the "
                                     f"launch and the launch on the "
                                     f"materialized operands differ")
            p, q = lhs.shape[0], rhs.shape[1]
            k2.append({"cotangent": name, **lead, **r,
                       **split_of(1, p, c, q),
                       **same_bits(f"K2 {name} {lead}",
                                   lambda: launch()[None], out[None],
                                   [(0, lambda: pim_matmul_grouped(
                                       lhs[None], rhs[None])[0])]),
                       **pim_timing(
                           launch, lambda: ref.pim_matmul_ref(lhs, rhs),
                           lambda: torch.mm(lhs, rhs) if name == "dA"
                           else torch.mm(a.T, g),
                           4 * (lhs.numel() + rhs.numel() + p * q),
                           2 * p * c * q)})
            del out
        del a, b, g, da, db, at, bt
    if made_k2 != collections.Counter(grad_run["executor"]["launched"]["k2"]):
        raise AssertionError(f"kernels_pim backward: the held K2 nodes "
                             f"launch {sorted(made_k2.items())}, the "
                             f"executor's backward "
                             f"{grad_run['executor']['launched']['k2']}")
    torch.cuda.empty_cache()
    split_db = [{"kernel": key, "G": r.get("G", 1), **{f: r[f] for f in (
        "M", "K", "N", "splits", "chunk", "blocks", "ms", "library_ms",
        "bound_ms", "max_err_over_limit", "control_over_limit")}}
        for key, rows in (("k1", k1), ("k2", k2)) for r in rows
        if r["cotangent"] == "dB" and r["splits"] > 1]
    emit({"phase": "kernels_pim", "path": "pim_grad_backward",
          "batch": PIM_GRAD_BATCH, "tol": "mm_limit(contraction)",
          "split_db": split_db,
          "results": [{**K1, "shapes": k1}, {**K3, "shapes": k3},
                      {**K2, "path": "pim_grad executor", "shapes": k2}]})
    return {"k1": k1, "k2": k2, "k3": k3}


# ---------------------------------------------------------------------------
# 12. pim_lenet_q: LeNet-5 served on quantized weight grids (K5), by
# phase_pim_lenet over Q_SERVE
# ---------------------------------------------------------------------------

# (weight grid, batch) of pim_lenet_q; the first is the main path, whose
# launch shapes kernels_pim holds K5 at
Q_SERVE = (("int8", 256), ("fp8_e4m3", 256), ("fp8_e5m2", 256),
           ("fp16", 256), ("int8", 4096))
Q_TRAIN_DTYPE = "int8"
Q_PARITY_STEPS = 5         # int8 against fp32, loss by loss
Q_LOSS_RTOL = 0.02         # the reference's test_trainer_int8_losses_...


# ---------------------------------------------------------------------------
# 13. kernels_pim, K5: at the shapes of a quantized path's launches
# ---------------------------------------------------------------------------


def phase_kernels_pim_q(seed: int, shapes: list, path: str,
                        batch: int) -> list:
    """K5 at the ``shapes`` (``(name, G, col_groups, M, K, N, count)``) of
    one of ``path``'s runs, on seeded random activations and weights
    quantized to the int8 grid (``quantize_axis``, as the lowering
    quantizes them), against its plain version per output row to
    ``mm_limit`` (with the dropped-K-tile control) and against K1 on
    ``q * s`` bit for bit; timed beside its bound (each operand read once
    — Q as float32 — the output written once; 2 MKN operations per group
    and the KN dequantizing multiplies) and the library call: ``q * s``
    then ``torch.bmm`` (TF32 off)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import (pim_matmul_grouped,
                                             pim_matmul_grouped_q)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 60)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    rows = []
    for name, g, cg, m, k, n, count in shapes:
        a = randn(g // cg, m, k)
        q, s = quant.quantize_axis(randn(g, k, n), Q_TRAIN_DTYPE, 1)
        r = hold_matmul(
            f"K5 {path} {name}",
            lambda: pim_matmul_grouped_q(a, q, s, col_groups=cg),
            lambda: ref.pim_matmul_grouped_q_ref(a, q, s, col_groups=cg),
            lambda: ref.pim_matmul_grouped_q_ref(a[..., :k - 128],
                                                 q[:, :k - 128], s,
                                                 col_groups=cg),
            mm_limit(k))
        if not torch.equal(r.pop("out"),
                           pim_matmul_grouped(a, q * s, col_groups=cg)):
            raise AssertionError(f"K5 {path} {name}: differs from K1 on "
                                 f"q * s")
        a_rep = a.repeat_interleave(cg, 0)
        rows.append({"node": name, "G": g, "col_groups": cg, "M": m,
                     "K": k, "N": n, "count": count, **r,
                     **split_of(g, m, k, n),
                     "k5_equals_k1_on_q_times_s": True,
                     **pim_timing(
                         lambda: pim_matmul_grouped_q(a, q, s,
                                                      col_groups=cg),
                         lambda: ref.pim_matmul_grouped_q_ref(
                             a, q, s, col_groups=cg),
                         lambda: torch.bmm(a_rep, q * s),
                         4 * (a.numel() + q.numel() + s.numel()
                              + g * m * n),
                         2 * g * m * k * n + g * k * n)})
        del a, q, s, a_rep
    torch.cuda.empty_cache()
    emit({"phase": "kernels_pim", "path": path, "batch": batch,
          "weight_dtype": Q_TRAIN_DTYPE, "tol": "mm_limit(K)",
          "results": [{**K5, "shapes": rows}]})
    return rows


# ---------------------------------------------------------------------------
# 14. pim_train_q: LeNet-5 trained on the int8 weight grid
# ---------------------------------------------------------------------------


def phase_pim_train_q(seed: int, fp32: dict) -> dict:
    """``Trainer(backend="pim", weight_dtype="int8")`` on the card, AdamW
    at ``TRAIN_LR``, batch 64, ``TRAIN_STEPS`` steps from ``pim_train``'s
    seeded parameters and batches — the main path, every count set to 0
    just before and read just after: 11 K5 and a fixed number of K3 per
    step, no K1 or K2. Its first 5 losses within 2% relative of the fp32
    pim trainer's (``fp32``: ``pim_train``'s run of as many steps, whose
    ms per step it is timed beside), and its loss at the last step below
    its first. Then one compiled step against the per-block executor, bit
    for bit (deterministic cuDNN), and against
    ``run_fake_quant_plain`` — the step with native ops over each placed
    product's stationary operand fake-quantized, which shares nothing
    with the lowering — at rtol = atol = 1e-4, with the step's K5 launch
    shapes logged and a profile of the compiled step."""
    import tempfile

    import torch
    from repro_torch import mapper, obs
    from repro_torch.mapper.executor import (full_float32, max_deviation,
                                             run_fake_quant_plain)
    from repro_torch.models import lenet
    params0 = lenet.init_lenet(seed, device=DEVICE)
    batch, steps = TRAIN_BATCHES[0], TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp, full_float32():
        batches = digit_batches(batch, steps)
        t0 = time.perf_counter()
        q = make_trainer("pim", params0, batches, steps, tmp,
                         weight_dtype=Q_TRAIN_DTYPE)
        build_s = time.perf_counter() - t0
        prog = q.pim_program
        obs.metrics().reset()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses = q.run()["losses"]
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        wall = step_wall_s()
        if (counts["k1"] or counts["k2"] or counts["k5"] != 11 * steps
                or counts["k3"] % steps or not counts["k3"]):
            raise AssertionError(f"pim_train_q: launches {counts} over "
                                 f"{steps} steps; want 11 K5 and a fixed "
                                 f"number of K3 per step, no K1 or K2")
        if not all(np.isfinite(losses)):
            raise AssertionError("pim_train_q: non-finite loss")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"pim_train_q: loss {losses[-1]} at step "
                                 f"{steps - 1} not below {losses[0]}")
        fp32_losses = fp32["losses"][:Q_PARITY_STEPS]
        rel = [abs(a - b) / max(abs(b), 1e-6)
               for a, b in zip(losses, fp32_losses)]
        if not max(rel) < Q_LOSS_RTOL:
            raise AssertionError(f"pim_train_q: int8 losses "
                                 f"{losses[:Q_PARITY_STEPS]} off fp32's "
                                 f"{fp32_losses} by {rel}")
        ex = mapper.ScheduleExecutor(prog.schedule, device=DEVICE)
        state = (q.params, q.opt_state, batches[0])
        with deterministic_cudnn():
            with recording_launches() as prog_log:
                got = prog(*state)
            want = ex.run(*state)
        diff = leaves_differing(got, want)
        if diff:
            raise AssertionError(f"pim_train_q: compiled step and executor "
                                 f"differ: {diff}")
        err = max_deviation(got, run_fake_quant_plain(prog.schedule, *state),
                            **PIM_TOL)
        prof = profile_device(lambda: prog(*state), calls=3)
        emit({"phase": "pim_train_q", "batch": batch,
              "weight_dtype": Q_TRAIN_DTYPE,
              "config": "lenet5 (paper, 21655 params) AdamW lr 2e-3, int8 "
                        "weight grid, DigitsDataset(seed=0)",
              "steps": steps, "build_s": build_s,
              "losses_first": losses[:Q_PARITY_STEPS],
              "loss_last": losses[-1], "fp32_losses_first": fp32_losses,
              "max_rel_loss_dev_vs_fp32": max(rel),
              "launches_per_step": {k: v / steps for k, v in counts.items()},
              "compiled_equals_executor": True,
              "max_abs_err_vs_fake_quant_plain_step": err,
              "placed_blocks": prog.placed_blocks,
              "replicas": sum(p.replicas for p in
                              prog.schedule.placement.node_placements
                              .values()),
              "subarrays": prog.schedule.placement.n_subarrays,
              "ms_per_step": wall["steady_mean"] * 1e3,
              "images_per_s": batch / wall["steady_mean"],
              "fp32_pim_ms_per_step": fp32["ms_per_step"],
              "train.step_wall_s": wall,
              "max_memory_allocated_gb": peak / 1e9,
              "modeled_pim_latency_s": prog.schedule.report.latency_s,
              "k5_launch_shapes": prog_log["k5"], "profile": prof})
        del q, got, want, state, batches, ex
        torch.cuda.empty_cache()
    return {"launches": counts, "shapes": {"k5": prog_log["k5"]}}


# ---------------------------------------------------------------------------
# 16. kernels_attn: causal GQA flash attention (K7) through ops.attention
# ---------------------------------------------------------------------------

K7 = {"name": "flash_attention", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
      "replaces": "src/repro/kernels/flash_attention.py:101"}
# (B, S, H, G, D) of the reference's sweep (tests/test_kernels.py), chunks
# of 64; then llama3-8b's heads at S 2048 and 8192, the default chunks
ATTN_TEST_SHAPES = ((1, 128, 4, 2, 64), (2, 128, 8, 8, 32), (1, 64, 6, 3, 16))
ATTN_LLAMA_SHAPES = tuple((1, s, 32, 8, 128) for s in (2048, 8192))
# the reference's tolerances (rtol = atol), atol here x max|out| of each
# (batch, query, head) row
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_TILE = 64      # csrc kBQ = kBK: the kernel's query and key tiles


def attn_over_limit(out, want, tol):
    """The reference's check, ``assert_allclose(rtol=tol, atol=tol)``,
    with atol scaled to each row's own size: the largest |out - want| /
    (tol (max|want| of the row + |want|)) of each (batch, query, head) row
    of [B, S, H, D], so [B, S, H]. Late queries average thousands of keys
    and their outputs are ~100x smaller than the first query's, so a
    fixed atol, or one scaled to a whole head, could not see their
    errors. The rtol term stays, as in the reference: its bf16 oracle
    rounds the scores to bf16, which alone moves it off an oracle with
    float32 scores by about tol x max|want| of a row
    (``phase_kernels_attn`` reads both against that oracle)."""
    want = want.float()
    scale = want.abs().amax(-1, keepdim=True) + want.abs()
    return ((out.float() - want).abs()
            / (tol * scale).clamp_min(1e-30)).amax(-1)


def last_tile_without_diagonal(s: int, device):
    """The control's mask [S, S]: causal, except that the rows of the last
    ``ATTN_TILE``-row query tile do not read that tile's own (diagonal)
    keys — the fault of a kernel that skips the last query tile's last KV
    tile. Those rows are the latest, so their outputs are the smallest
    and their limits the tightest."""
    import torch
    pos = torch.arange(s, device=device)
    keep = pos[None] <= pos[:, None]
    last = (s - 1) // ATTN_TILE * ATTN_TILE
    keep[last:, last:] = False
    return keep, last


def attn_bound(q, k) -> tuple[float, str]:
    """Least time for one call: the causal flops 4 B H D S (S + 1) / 2 at
    the peak rate of q's type, against q, k, v and the output moved once
    over HBM rate."""
    b, s, h, d = q.shape
    flops = 4 * b * h * d * s * (s + 1) // 2
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[1]] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels_attn(seed: int) -> dict:
    """K7 through its public entry ``ops.attention`` — the reference's only
    way to its kernel (no model calls it) — at the reference's test shapes
    (chunks of 64) and llama3-8b's heads (S 2048 and 8192), float32 and
    bfloat16, on seeded random q, k, v. The main path is one
    ``ops.attention`` call per case, the launch count set to 0 just before
    each and read after it. Each output is held against
    ``flash_attention_ref`` on the card (TF32 off), every (batch, query,
    head) row to the reference's rtol = atol = ``ATTN_TOL`` with atol x
    the row's own max|out| (``attn_over_limit``), as K4 holds its rows;
    the control — the plain version with the last query tile's diagonal
    KV tile dropped (``last_tile_without_diagonal``) — must exceed that
    limit in some row of that tile. At llama3-8b's heads the kernel, the
    plain version and ``F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)`` (held to the same limit) are timed beside the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.mapper.executor import full_float32
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 60)
    cases = [(name, shape, chunk) for name in ("float32", "bfloat16")
             for shapes, chunk in ((ATTN_TEST_SHAPES, 64),
                                   (ATTN_LLAMA_SHAPES, 256))
             for shape in shapes]
    results, launches = [], 0
    with torch.no_grad(), full_float32():
        for name, (b, s, h, g, d), chunk in cases:
            dtype, tol = getattr(torch, name), ATTN_TOL[name]
            q, k, v = (torch.randn(shape, generator=gen, device=DEVICE)
                       .to(dtype) for shape in ((b, s, h, d), (b, s, g, d),
                                                (b, s, g, d)))
            label = f"K7 {name} {(b, s, h, g, d)}"
            flash_attention.launches = 0
            out = ops.attention(q, k, v, q_chunk=chunk, kv_chunk=chunk)
            torch.cuda.synchronize()
            if flash_attention.launches != 1:
                raise AssertionError(f"{label}: ops.attention made "
                                     f"{flash_attention.launches} K7 "
                                     f"launches, want 1")
            launches += flash_attention.launches
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{label}: non-finite output")
            want = ref.flash_attention_ref(q, k, v)
            ratio = float(attn_over_limit(out, want, tol).max())
            if not ratio <= 1:
                raise AssertionError(f"{label}: error {ratio} x the limit "
                                     f"of a row")
            keep, last = last_tile_without_diagonal(s, DEVICE)
            dropped = ref._masked_attention(q, k, v, keep)
            control = attn_over_limit(dropped[:, last:], want[:, last:],
                                      tol)
            del dropped
            if not float(control.max()) > 1:
                raise AssertionError(
                    f"{label}: dropping the last query tile's diagonal KV "
                    f"tile gives only {float(control.max())} x the limit")
            r = {"dtype": name, "shape": dict(zip("BSHGD", (b, s, h, g, d))),
                 "chunk": chunk, "tol": tol,
                 "max_err": float((out.float() - want.float()).abs().max()),
                 "max_err_over_limit": ratio,
                 "last_tile_max_err_over_limit": float(attn_over_limit(
                     out[:, last:], want[:, last:], tol).max()),
                 # the row limit without the rtol term, for comparison
                 "max_err_over_tol_row_max": float(
                     over_limit(out, want, tol).max()),
                 "control_max_over_limit": float(control.max()),
                 "control_rows_over_limit": float((control > 1).float()
                                                  .mean())}
            del control
            if name == "bfloat16":
                causal = torch.ones((s, s), dtype=torch.bool,
                                    device=DEVICE).tril()
                f32_scores = ref._masked_attention(
                    q.float(), k.float(), v.float(), causal).to(dtype)
                r.update(oracle_vs_f32_scores_over_tol_row_max=float(
                             over_limit(want, f32_scores, tol).max()),
                         kernel_vs_f32_scores_over_tol_row_max=float(
                             over_limit(out, f32_scores, tol).max()))
                del f32_scores
            if (b, s, h, g, d) in ATTN_LLAMA_SHAPES:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

                def library():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)

                lib_ratio = float(attn_over_limit(
                    library().transpose(1, 2), want, tol).max())
                if not lib_ratio <= 1:
                    raise AssertionError(f"SDPA yardstick {label}: error "
                                         f"{lib_ratio} x the limit")
                iters = 20 if s <= 2048 else 5
                bound_ms, bound_by = attn_bound(q, k)
                r.update(
                    ms=cuda_ms(lambda: flash_attention(q, k, v),
                               iters=iters, warmup=1),
                    plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                        q, k, v), iters=iters, warmup=1),
                    library_ms=cuda_ms(library, iters=iters, warmup=1),
                    library_max_err_over_limit=lib_ratio,
                    bound_ms=bound_ms, bound_by=bound_by)
            results.append(r)
            del q, k, v, out, want
            torch.cuda.empty_cache()
    emit({"phase": "kernels_attn", **K7, "path": "ops.attention",
          "launches": launches, "results": results})
    return {"launches": launches, "results": results}


# ---------------------------------------------------------------------------
# 17. pim_fp: the bit-serial multiply (K8) and the bit-plane procedures
# ---------------------------------------------------------------------------

K8 = {"name": "pim_fp32_mul", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_fp.cu",
      "replaces": "src/repro/kernels/pim_fp.py:104"}
PIM_FP_PAIRS = 1 << 20       # random float32 bit patterns, every exponent
PIM_FP_EDGE_PAIRS = 1 << 12  # each: subnormal products, around 2^-126
PIM_FP_ADD_LANES = 1 << 16   # fp32_add_pim against IEEE addition
PIM_FP_DOT = 64              # pim_dot against a sequential float32 sum
PIM_FP_TIME_N = 1 << 24      # K8 timed against torch.mul
# integer opcodes of the SASS (``sass_instructions``)
SASS_INT_OPS = ("IADD", "IMAD", "LOP", "SHF", "SHL", "SHR", "ISETP", "SEL",
                "LEA", "IMNMX", "BFE", "BFI", "PRMT", "FLO", "POPC", "IABS",
                "VIADD", "VIMNMX", "IMUL")


def pim_fp_inputs(seed: int):
    """float32 pairs (numpy): random bit patterns over every exponent
    (zeros, subnormals, inf and NaN included), the reference's edge table
    (``tests/test_kernels.py``), normal pairs whose exact product is
    subnormal, and normal pairs within three ulps of a product of 2^-126
    (either side of the flush)."""
    rng = np.random.default_rng(seed + 70)

    def bits(n):
        return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
            np.uint32).view(np.float32)

    def normals(n):
        return (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-100, -27, n)
                ).astype(np.float32)

    n = PIM_FP_EDGE_PAIRS
    sub_a = normals(n)
    sub_b = (2.0 ** rng.uniform(-150, -126, n) / sub_a).astype(np.float32)
    near_a = normals(n)
    near_b = ((2.0 ** -126 / near_a.astype(np.float64)).astype(np.float32)
              .view(np.uint32).astype(np.int64) + rng.integers(-3, 4, n)
              ).astype(np.uint32).view(np.float32)
    edge_a = np.array([1e30, 1e30, 1e-30, 1.0, -0.0, np.inf, 1.5, 3.0,
                       1 + 2 ** -23], np.float32)
    edge_b = np.array([1e30, -1e30, 1e-30, 0.0, 2.0, 2.0, 1.5, 1 + 2 ** -23,
                       1 + 2 ** -23], np.float32)
    a = np.concatenate([bits(PIM_FP_PAIRS), edge_a, sub_a, near_a])
    b = np.concatenate([bits(PIM_FP_PAIRS), edge_b, sub_b, near_b])
    return a, b


def bits_differ(got, want) -> int:
    """Lanes whose float32 bits differ, a NaN matching any NaN."""
    import torch
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        got.isnan() & want.isnan())
    return int((~same).sum())


def max_abs_diff(got, want) -> float:
    """max |got - want| over the lanes where neither is NaN (equal infs
    differ by 0, unequal ones by inf)."""
    import torch
    both = ~(got.isnan() | want.isnan())
    diff = torch.where(got[both] == want[both], 0.0,
                       (got[both] - want[both]).abs())
    return float(diff.max()) if diff.numel() else 0.0


def sass_instructions(kernel: str, source: str) -> dict:
    """All and integer instructions of ``kernel`` in the built ``source``
    library's SASS (``cuobjdump -sass``, beside nvcc)."""
    from repro_torch.kernels import build
    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build(source))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    ops, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):   # predicated
                words = words[1:]
            if words and words[0][0].isalpha():
                ops.append(words[0])
    if not ops:
        raise AssertionError(f"no SASS found for {kernel} in {source}")
    return {"instructions": len(ops),
            "int_instructions": sum(op.startswith(SASS_INT_OPS)
                                    for op in ops)}


def phase_pim_fp(seed: int) -> dict:
    """K8 and the paper's bit-level FP procedures on the card. The main
    path is one ``pim_fp32_mul`` call over ``pim_fp_inputs`` (the launch
    count set to 0 just before, read after); its result equals, bit for
    bit with NaN as NaN, the plain version ``pim_fp32_mul_ref`` and the
    port's bit-plane ``core.fp.fp32_mul_pim``, both run on the card, and
    ``torch.mul`` of the inputs with subnormals read as signed zeros
    wherever that product is normal (its exact value at least 2^-126 in
    magnitude). ``fp32_add_pim`` on normal-range
    pairs equals IEEE addition wherever the sum is normal or zero, and
    ``pim_dot`` a sequential float32 sum of products (as
    ``tests/test_fp_bitexact.py`` holds them). Then K8 is timed at
    ``PIM_FP_TIME_N`` elements against its plain version and
    ``torch.mul``, beside its byte bound and a static estimate of its
    integer instructions per element: the kernel's integer SASS
    instructions over the five sites where it inlines the per-element
    procedure (four in its float4 loop, one in its scalar tail), its loop,
    address and special-value code included."""
    import torch
    from repro_torch.core import fp
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_fp import pim_fp32_mul
    a_np, b_np = pim_fp_inputs(seed)
    a, b = (torch.from_numpy(x).to(DEVICE) for x in (a_np, b_np))
    pim_fp32_mul.launches = 0
    out = pim_fp32_mul(a, b)
    torch.cuda.synchronize()
    launches = pim_fp32_mul.launches
    if launches != 1:
        raise AssertionError(f"pim_fp: {launches} K8 launches, want 1")
    t0 = time.perf_counter()
    bitplane = fp.fp32_mul_pim(a, b)
    torch.cuda.synchronize()
    bitplane_s = time.perf_counter() - t0
    daz_a, daz_b = fp.flush_subnormal(a), fp.flush_subnormal(b)
    ieee = daz_a * daz_b
    # normal: the exact product (a float64 product of float32s is exact)
    # at least 2^-126. Just below it IEEE rounds at the subnormal ulp,
    # 2^-149, and may reach 2^-126, where the procedure rounds at 24 bits
    # and then flushes: the reference's contract, not IEEE's.
    exact = daz_a.double() * daz_b.double()
    normal = ieee.isfinite() & (exact.abs() >= 2.0 ** -126)
    plain = ref.pim_fp32_mul_ref(a, b)
    max_err = max_abs_diff(out, plain)
    checks = {
        "lanes": a.numel(),
        "differ_from_plain": bits_differ(out, plain),
        "differ_from_fp32_mul_pim": bits_differ(out, bitplane),
        "normal_products": int(normal.sum()),
        "differ_from_torch_mul_where_normal": bits_differ(out[normal],
                                                          ieee[normal]),
        "flushed_normal_input_pairs": int(
            ((a.abs() >= 2.0 ** -126) & (b.abs() >= 2.0 ** -126)
             & a.isfinite() & b.isfinite() & (out == 0)).sum()),
        "ieee_subnormal_products": int(
            ((exact.abs() < 2.0 ** -126) & (exact != 0)).sum()),
        "flushed_where_ieee_rounds_to_2^-126": int(
            ((exact.abs() < 2.0 ** -126) & (ieee.abs() == 2.0 ** -126)
             & (out == 0)).sum())}
    rng = np.random.default_rng(seed + 71)
    u = ((rng.integers(0, 2, (2, PIM_FP_ADD_LANES), dtype=np.uint32) << 31)
         | (rng.integers(40, 216, (2, PIM_FP_ADD_LANES), dtype=np.uint32)
            << 23)
         | rng.integers(0, 2 ** 23, (2, PIM_FP_ADD_LANES), dtype=np.uint32))
    x, y = torch.from_numpy(u.view(np.float32)).to(DEVICE)
    s_ieee = x + y
    keep = (s_ieee == 0) | (s_ieee.abs() >= 2.0 ** -126)
    checks["add_lanes"] = int(keep.sum())
    checks["add_differ_from_ieee"] = bits_differ(fp.fp32_add_pim(x, y)[keep],
                                                 s_ieee[keep])
    da = rng.standard_normal(PIM_FP_DOT).astype(np.float32)
    db = rng.standard_normal(PIM_FP_DOT).astype(np.float32)
    seq = np.float32(0)
    for p, r in zip(da, db):
        seq = np.float32(seq + np.float32(p * r))
    dot = float(fp.pim_dot(torch.from_numpy(da).to(DEVICE),
                           torch.from_numpy(db).to(DEVICE)))
    checks["dot_differs_from_sequential"] = int(dot != float(seq))
    bad = {k: v for k, v in checks.items() if "differ" in k and v}
    if bad or not checks["flushed_normal_input_pairs"]:
        raise AssertionError(f"pim_fp: {bad or 'no product was flushed'}")

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 72)
    ta, tb = (torch.randint(-2 ** 31, 2 ** 31, (PIM_FP_TIME_N,),
                            generator=gen, dtype=torch.int64, device=DEVICE)
              .to(torch.int32).view(torch.float32) for _ in range(2))
    if bits_differ(pim_fp32_mul(ta, tb), ref.pim_fp32_mul_ref(ta, tb)):
        raise AssertionError("pim_fp: K8 differs from its plain version at "
                             "the timed size")
    sass = sass_instructions("pim_fp32_mul_kernel", "pim_fp")
    timing = {"n": PIM_FP_TIME_N,
              "ms": cuda_ms(lambda: pim_fp32_mul(ta, tb)),
              "plain_ms": cuda_ms(lambda: ref.pim_fp32_mul_ref(ta, tb),
                                  iters=5, warmup=1),
              "library_ms": cuda_ms(lambda: torch.mul(ta, tb)),
              "bound_ms": 12 * PIM_FP_TIME_N / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "sass": sass,
              "int_instructions_per_element_static_estimate":
                  sass["int_instructions"] / 5}
    emit({"phase": "pim_fp", **K8, "path": "pim_fp32_mul",
          "launches": launches, "max_abs_err": max_err, "checks": checks,
          "bitplane_mul_s": bitplane_s, "timing": timing})
    del a, b, out, plain, bitplane, daz_a, daz_b, ieee, exact, ta, tb
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, **timing}


def sums(rows) -> dict:
    """Times and bounds of one run's launches: each distinct shape's
    numbers times its count, summed (each shape's bound the larger of its
    two times); the largest error."""
    def total(key):
        return sum(r[key] * r["count"] for r in rows)

    t_bytes, t_ops = total("bytes_ms"), total("ops_ms")
    return {"max_abs_err": max(r["max_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": total("library_ms")}


def pim_entry(ids, key, by_path, rows) -> dict:
    """A PIM kernel's kernels-line entry: its launches summed over the
    main paths (forward and backward; ``launches_by_path`` splits them),
    the times of one batch-256 serve forward (``pim_lenet``) and, under
    ``pim_train`` and ``backward``, those of one batch-64 train step (K2:
    one executor step) and of ``pim_grad``'s backward (K2: the executor's
    backward there)."""
    launches = {path: counts[key] for path, counts in by_path.items()
                if path != "pim_grad_backward"}
    backward = rows["pim_grad_backward"].get(key)
    return {**ids, "launches": sum(launches.values()),
            **sums(rows["pim_lenet"][key]),
            "launches_by_path": {**launches, "pim_grad_backward":
                                 by_path["pim_grad_backward"][key]},
            "pim_train": sums(rows["pim_train"][key]),
            "backward": sums(backward) if backward else None}


def with_counts(shapes: dict) -> dict:
    """Logged launch shapes as ``phase_kernels_pim`` rows: each distinct
    shape once, named by itself, with its count."""
    return {key: [("x".join(map(str, row[:-1])), *row)
                  for row in counted(rows)]
            for key, rows in shapes.items()}


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    k4 = phase_kernels(args.seed)
    k6 = phase_kernels_q(args.seed)
    attn = phase_kernels_attn(args.seed)
    pim_fp = phase_pim_fp(args.seed)
    lenet_run = phase_pim_lenet(args.seed, PIM_SERVE)
    rows = {"pim_lenet": phase_kernels_pim(
        args.seed, lenet_run["shapes"], "pim_lenet", PIM_SERVE[0][1],
        wave=True)}
    train = phase_pim_train(args.seed)
    rows["pim_train"] = phase_kernels_pim(
        args.seed, with_counts(train["shapes"]), "pim_train",
        TRAIN_BATCHES[0])
    grad = phase_pim_grad(args.seed)
    rows["pim_grad_backward"] = phase_kernels_pim_backward(args.seed, grad)
    lenet_q = phase_pim_lenet(args.seed, Q_SERVE)
    rows["pim_lenet_q"] = phase_kernels_pim_q(
        args.seed, lenet_q["shapes"]["k5"], "pim_lenet_q", Q_SERVE[0][1])
    train_q = phase_pim_train_q(args.seed, train)
    rows["pim_train_q"] = phase_kernels_pim_q(
        args.seed, with_counts(train_q["shapes"])["k5"], "pim_train_q",
        TRAIN_BATCHES[0])
    grad_q = phase_pim_grad(args.seed, Q_TRAIN_DTYPE)
    by_path = {"pim_lenet": lenet_run["launches"],
               "pim_train": {k: train["launches"][k]
                             + train["executor_launches"][k]
                             for k in PIM_KEYS},
               "pim_grad": {k: grad["forward"][k] + grad["backward"][k]
                            for k in PIM_KEYS},
               "pim_grad_executor": {
                   k: grad["executor"]["launches_forward"][k]
                   + grad["executor"]["launches_backward"][k]
                   for k in PIM_KEYS},
               "pim_lenet_q": lenet_q["launches"],
               "pim_train_q": train_q["launches"],
               "pim_grad_q": {k: grad_q["forward"][k] + grad_q["backward"][k]
                              for k in PIM_KEYS},
               "pim_grad_backward": {
                   k: grad["backward"][k]
                   + grad["executor"]["launches_backward"][k]
                   for k in PIM_KEYS}}
    phase_parity(args.seed)
    serve = phase_serve(args.seed)
    phase_profile(serve["engine"], args.seed)
    kvq = phase_serve_kvq(serve["engine"].model, args.seed)
    # 64-token prompts replayed: the last 15 ticks (7 of replay, 8 of
    # generation) run under the profiler
    phase_profile(kvq["engine"], args.seed, "profile_kvq", prompt_len=64,
                  warm_ticks=56)
    print(gpu_name_and_power_limit(), flush=True)

    def entry(ids, launches, r):
        return {**ids, "launches": launches, "max_abs_err": r["max_err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    long_bf16 = next(r for r in attn["results"] if r["dtype"] == "bfloat16"
                     and r["shape"]["S"] == ATTN_LLAMA_SHAPES[-1][1])
    k5_launches = {path: by_path[path]["k5"]
                   for path in ("pim_lenet_q", "pim_train_q", "pim_grad_q")}
    emit({"kernels": [
        entry(K4, serve["launches"], k4["bfloat16"]),
        entry(K6, kvq["launches"], k6[(SERVE_KV_DTYPE, "bfloat16")]),
        *(pim_entry(ids, key, by_path, rows)
          for ids, key in ((K1, "k1"), (K2, "k2"), (K3, "k3"))),
        {**K5, "launches": sum(k5_launches.values()),
         **sums(rows["pim_lenet_q"]), "launches_by_path": k5_launches,
         "pim_train": sums(rows["pim_train_q"])},
        {**K7, "launches": attn["launches"],
         "max_abs_err": long_bf16["max_err"],
         **{k: long_bf16[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
         "case": {"dtype": "bfloat16", **long_bf16["shape"]}},
        {**K8, **{k: pim_fp[k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms",
            "int_instructions_per_element_static_estimate")},
         "case": {"n": pim_fp["n"]}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
