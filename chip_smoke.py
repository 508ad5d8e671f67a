#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. ``build``     — compile every CUDA kernel of the port with nvcc, one
   process per source, all started together.
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

Then the card's name and power limit, one line with every kernel's
numbers, and as the last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero. Needs one CUDA device; imports nothing
of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
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
        entry(K6, kvq["launches"], k6[(SERVE_KV_DTYPE, "bfloat16")])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
