#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. ``build``     — compile every CUDA kernel of the port with nvcc, one
   process per source, all started together (four sources).
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
   to K2 bit for bit, and timed beside its bound and a library call.

Then the card's name and power limit, one line with every kernel's
numbers, and as the last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero. Needs one CUDA device; imports nothing
of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# the batches pim_lenet serves; kernels_pim runs the first one's launches
PIM_BATCHES = (256, 4096)
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


def profile_pim(fn, calls: int = 5) -> dict:
    """Where one compiled LeNet call's time goes: ``calls`` calls under
    ``torch.profiler`` after a warm call, device time by kernel group —
    K1, K3, the copies, fills and concatenations of padding, im2col and
    layout, and the rest — against the host's wall time."""
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
    groups = {"k1": 0.0, "k3": 0.0, "copy_fill_cat": 0.0, "other": 0.0}
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        n_kernels += e.count
        key = ("k1" if "pim_matmul_kernel" in name else
               "k3" if "pim_mac_kernel" in name else
               "copy_fill_cat" if any(k in name for k in (
                   "copy", "fill", "cat", "memset", "memcpy")) else "other")
        groups[key] += e.self_device_time_total
    device_s = sum(groups.values()) / 1e6
    return {"calls": calls, "wall_ms_per_call": wall_s / calls * 1e3,
            "device_ms_per_call": device_s / calls * 1e3,
            "device_busy_share_under_profiler": device_s / wall_s,
            "kernels_per_call": n_kernels / calls,
            "device_ms_per_call_by_group": {
                k: v / calls / 1e3 for k, v in groups.items()}}


@contextlib.contextmanager
def recording_launches():
    """Log the argument shapes of every K1, K2 and K3 launch the mapper's
    lowering makes while open. The lowering's wrappers are wrapped, not
    replaced: they launch and count as always."""
    from repro_torch.mapper import lowering
    log = {"k1": [], "k2": [], "k3": []}
    orig = {name: getattr(lowering, name)
            for name in ("pim_matmul_grouped", "pim_matmul", "pim_mac")}

    def k1(a, b, **kw):
        log["k1"].append((b.shape[0], kw.get("col_groups", 1), a.shape[1],
                          a.shape[2], b.shape[2]))
        return orig["pim_matmul_grouped"](a, b, **kw)

    def k2(a, b, **kw):
        log["k2"].append((a.shape[0], a.shape[1], b.shape[1]))
        return orig["pim_matmul"](a, b, **kw)

    def k3(a, b, acc):
        log["k3"].append(a.numel())
        return orig["pim_mac"](a, b, acc)

    for name, fn in zip(orig, (k1, k2, k3)):
        setattr(lowering, name, fn)
    try:
        yield log
    finally:
        for name, fn in orig.items():
            setattr(lowering, name, fn)


def launch_shapes(prog, prog_log, ex_log) -> dict:
    """The logged launches of one compiled call (K1, K3) and one executor
    run (K2), each named by the node (and block) its plan step lowers: K1
    (G, col_groups, M, K, N) per placed node, K2 (M, K, N) per placed
    block, K3 the element count of each add."""
    placed = [st.node for st in prog.ctx.steps if st.kind == "placed"]
    nodes = [nd for nd in placed if nd.kind != "eltwise"]
    blocks = [f"{nd.name}@{blk.row0},{blk.col0}" for nd in nodes
              for blk in prog.schedule.placement.iter_blocks(nd.idx, 0)]
    adds = [nd.name for nd in placed if nd.kind == "eltwise"]
    want = (len(nodes), len(blocks), len(adds), prog_log["k3"])
    got = (len(prog_log["k1"]), len(ex_log["k2"]), len(prog_log["k3"]),
           ex_log["k3"])
    if got != want:
        raise AssertionError(f"pim_lenet: logged launches {got[:3]} do not "
                             f"follow the plan's {want[:3]} (or the "
                             f"executor's adds differ in size)")
    return {"k1": [(nd.name, *sh) for nd, sh in zip(nodes, prog_log["k1"])],
            "k2": [(b, *sh) for b, sh in zip(blocks, ex_log["k2"])],
            "k3": list(zip(adds, prog_log["k3"]))}


def phase_pim_lenet(seed: int) -> dict:
    """``compile_lenet("serve")`` and ``ScheduleExecutor`` on the card at
    each of ``PIM_BATCHES``, over digit images, with seeded random
    parameters (non-zero biases, so the adds lowered to K3 carry values).
    The first batch is the main path: every count set to 0 just before
    one program call and one executor run, read just after, with the
    shapes of their launches logged for ``kernels_pim``."""
    import torch
    from repro_torch import mapper
    from repro_torch.data import make_digits
    from repro_torch.kernels.pim_mac import (pim_mac, pim_matmul,
                                             pim_matmul_grouped)
    from repro_torch.mapper.executor import full_float32, max_deviation
    from repro_torch.models import lenet
    kernels = (pim_matmul_grouped, pim_matmul, pim_mac)
    params = lenet.init_lenet(seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 30)
    for leaves in params.values():
        leaves["b"] = torch.randn(leaves["b"].shape, generator=gen,
                                  device=DEVICE)
    launches = shapes = None
    for batch in PIM_BATCHES:
        imgs, _ = make_digits(batch, seed=seed + batch)
        x = torch.from_numpy(imgs).to(DEVICE)
        prog = mapper.compile_lenet("serve", batch=batch)
        ex = mapper.ScheduleExecutor(prog.schedule)
        for k in kernels:
            k.launches = 0
        with recording_launches() as prog_log:
            out = prog(params, x)
        prog_counts = tuple(k.launches for k in kernels)
        with recording_launches() as ex_log:
            oracle = ex.run(params, x)
        torch.cuda.synchronize()
        counts = tuple(k.launches for k in kernels)
        ex_counts = tuple(c - p for c, p in zip(counts, prog_counts))
        if launches is None:
            launches = dict(zip(("k1", "k2", "k3"), counts))
            shapes = launch_shapes(prog, prog_log, ex_log)
        if prog_counts != (5, 0, 5) or ex_counts != (0, 7, 5):
            raise AssertionError(f"pim_lenet {batch}: launches (K1, K2, K3)"
                                 f" {prog_counts} compiled, {ex_counts} "
                                 f"per-block; want (5, 0, 5), (0, 7, 5)")
        if (prog.matmul_launches, prog.kernel_launches,
                prog.placed_blocks) != (5, 10, 7):
            raise AssertionError(f"pim_lenet {batch}: program counters")
        if out.shape != (batch, 10) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"pim_lenet {batch}: logits "
                                 f"{tuple(out.shape)} not finite")
        if not torch.equal(out, oracle):
            raise AssertionError(f"pim_lenet {batch}: compiled program and "
                                 f"executor differ")
        with torch.no_grad(), full_float32():
            plain = lenet.lenet_apply(params, x)

            def plain_call():
                return lenet.lenet_apply(params, x)

            err = max_deviation(out, plain, **PIM_TOL)
            torch.cuda.reset_peak_memory_stats()
            prog(params, x)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            prog_ms = wall_ms(lambda: prog(params, x))
            ex_ms = wall_ms(lambda: ex.run(params, x), iters=5)
            plain_ms = wall_ms(plain_call)
            prof = profile_pim(lambda: prog(params, x))
        emit({"phase": "pim_lenet", "batch": batch,
              "config": "lenet5 (paper, 21655 params) serve, float32",
              "launches_per_call": {"compiled": dict(zip(
                  ("k1", "k2", "k3"), prog_counts)), "per_block": dict(zip(
                      ("k1", "k2", "k3"), ex_counts))},
              "placed_blocks": prog.placed_blocks,
              "compiled_equals_executor": True,
              "max_abs_err_vs_plain": err,
              "ms_per_call": prog_ms, "images_per_s": batch / prog_ms * 1e3,
              "executor_ms_per_call": ex_ms, "plain_ms_per_call": plain_ms,
              "max_memory_allocated_gb": peak / 1e9,
              "modeled_pim_latency_s": prog.schedule.report.latency_s,
              "profile": prof})
        del out, oracle, plain, x
        torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes}


# ---------------------------------------------------------------------------
# 8. kernels_pim: K1, K2, K3 at the shapes pim_lenet launched at batch 256
# ---------------------------------------------------------------------------

def pim_bound(nbytes: int, flops: int) -> tuple[float, float]:
    """(byte time, operation time) in ms: bytes over HBM rate, float32
    operations over the float32 peak."""
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / PEAK_FLOPS["float32"] * 1e3)


def row_ratio(out, want, tol) -> float:
    """Max over output rows of the error against ``tol`` x the row's
    max|want|."""
    err = (out - want).abs().amax(-1)
    return float((err / (tol * want.abs().amax(-1)).clamp_min(1e-30)).max())


def hold_matmul(label, kernel, plain, dropped) -> dict:
    """Hold ``kernel()`` against ``plain()`` per output row; the control
    ``dropped()`` (the plain product without its last K tile) must exceed
    the limit."""
    import torch
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite output")
    ratio = row_ratio(out, want, PIM_MM_TOL)
    if not ratio <= 1:
        raise AssertionError(f"{label}: error {ratio} x the limit "
                             f"{PIM_MM_TOL} x max|out| of a row")
    control = row_ratio(dropped(), want, PIM_MM_TOL)
    if not control > 1:
        raise AssertionError(f"{label}: dropping the last K tile gives only "
                             f"{control} x the limit")
    return {"max_err": float((out - want).abs().max()),
            "max_err_over_limit": ratio, "control_over_limit": control,
            "out": out}


def phase_kernels_pim(seed: int, shapes: dict) -> dict:
    """K1, K2 and K3 at the ``shapes`` of pim_lenet's main path at batch
    256 (``launch_shapes``), on seeded random data, against
    their plain versions on the card, and timed: kernel, plain version,
    bound (each operand read once and the output written once; 2 MK N
    float32 operations for a product, 2 per MAC element) and the library
    call — ``torch.bmm`` on the same padded stacks (shared-A slabs
    repeated beforehand, untimed) for K1, ``torch.mm`` for K2, both with
    TF32 off, and ``torch.addcmul`` for K3 (time only: it may round
    once)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import (pim_mac, pim_mac_grouped,
                                             pim_matmul, pim_matmul_grouped)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    def timing(kernel, plain, library, nbytes, flops) -> dict:
        t_bytes, t_ops = pim_bound(nbytes, flops)
        return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                "library_ms": cuda_ms(library),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes_ms": t_bytes, "ops_ms": t_ops}

    k1 = []
    for name, g, cg, m, k, n in shapes["k1"]:
        a, b = randn(g // cg, m, k), randn(g, k, n)
        r = hold_matmul(
            f"K1 {name}",
            lambda: pim_matmul_grouped(a, b, col_groups=cg),
            lambda: ref.pim_matmul_grouped_ref(a, b, col_groups=cg),
            lambda: ref.pim_matmul_grouped_ref(a[..., :k - 128],
                                               b[:, :k - 128],
                                               col_groups=cg))
        out = r.pop("out")
        for i in range(g):              # K1 == K2 on the same blocks
            if not torch.equal(out[i], pim_matmul(a[i // cg], b[i])):
                raise AssertionError(f"K1 {name}: group {i} differs from K2")
        a_rep = a.repeat_interleave(cg, 0)
        k1.append({"node": name, "G": g, "col_groups": cg, "M": m, "K": k,
                   "N": n, **r, "k1_equals_k2": True,
                   **timing(lambda: pim_matmul_grouped(a, b, col_groups=cg),
                            lambda: ref.pim_matmul_grouped_ref(
                                a, b, col_groups=cg),
                            lambda: torch.bmm(a_rep, b),
                            4 * (a.numel() + b.numel() + g * m * n),
                            2 * g * m * k * n)})
        del a, b, a_rep, out
    k2 = []
    for name, m, k, n in shapes["k2"]:
        a, b = randn(m, k), randn(k, n)
        r = hold_matmul(f"K2 {name}", lambda: pim_matmul(a, b),
                        lambda: ref.pim_matmul_ref(a, b),
                        lambda: ref.pim_matmul_ref(a[:, :k - 128],
                                                   b[:k - 128]))
        r.pop("out")
        k2.append({"block": name, "M": m, "K": k, "N": n, **r,
                   **timing(lambda: pim_matmul(a, b),
                            lambda: ref.pim_matmul_ref(a, b),
                            lambda: torch.mm(a, b),
                            4 * (a.numel() + b.numel() + m * n),
                            2 * m * k * n)})
        del a, b
    k3 = []
    waves = []
    for name, n in shapes["k3"] + [("wave", None)]:
        if n is None:                   # the five adds as one K3 launch
            flat = [torch.cat([t[i] for t in waves]) for i in range(3)]
            got = pim_mac_grouped(waves)
            if not all(torch.equal(x, pim_mac(*t))
                       for x, t in zip(got, waves)):
                raise AssertionError("K3 wave: differs from per-add K3")
            a, b, acc = flat
            n = a.numel()
        else:
            a, b, acc = randn(n), randn(n), randn(n)
            waves.append((a, b, acc))
        out, want = pim_mac(a, b, acc), ref.pim_mac_ref(a, b, acc)
        if not torch.equal(out, want):
            raise AssertionError(f"K3 {name}: not bit-equal to the plain "
                                 f"version")
        fused = int((torch.addcmul(acc, a, b) != out).sum())
        k3.append({"node": name, "n": n,
                   "max_err": float((out - want).abs().max()),
                   "bit_equal": True,
                   "addcmul_elements_differing": fused,
                   **timing(lambda: pim_mac(a, b, acc),
                            lambda: ref.pim_mac_ref(a, b, acc),
                            lambda: torch.addcmul(acc, a, b),
                            16 * n, 2 * n)})
    del waves
    torch.cuda.empty_cache()
    emit({"phase": "kernels_pim", "batch": PIM_BATCHES[0], "tol": PIM_MM_TOL,
          "results": [{**K1, "shapes": k1}, {**K2, "shapes": k2},
                      {**K3, "shapes": k3}]})
    return {"k1": k1, "k2": k2, "k3": [r for r in k3 if r["node"] != "wave"]}


def sum_entry(ids, launches, rows) -> dict:
    """One kernels-line entry over the shapes of one batch-256 forward:
    times and bounds summed (each shape's bound the larger of its two
    times), the largest error."""
    t_bytes = sum(r["bytes_ms"] for r in rows)
    t_ops = sum(r["ops_ms"] for r in rows)
    return {**ids, "launches": launches,
            "max_abs_err": max(r["max_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rows)}



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
    lenet_run = phase_pim_lenet(args.seed)
    pim = phase_kernels_pim(args.seed, lenet_run["shapes"])
    pim_launches = lenet_run["launches"]
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

    emit({"kernels": [
        entry(K4, serve["launches"], k4["bfloat16"]),
        entry(K6, kvq["launches"], k6[(SERVE_KV_DTYPE, "bfloat16")]),
        sum_entry(K1, pim_launches["k1"], pim["k1"]),
        sum_entry(K2, pim_launches["k2"], pim["k2"]),
        sum_entry(K3, pim_launches["k3"], pim["k3"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
