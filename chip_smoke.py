#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. ``build``   — compile every CUDA kernel of the port with nvcc.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card at the shapes of the serve phase, and time kernel, plain version
   and one PyTorch library call computing the same function.
3. ``parity``  — llama3-8b at full width, 2 layers, float32: the serve
   engine with the kernel and with the gather path gives identical tokens
   and per-tick logits within 1e-4 x max|logit|.
4. ``serve``   — llama3-8b at its full published config in bfloat16 serves
   16 requests; the paged decode kernel must run once per layer per tick.
5. ``profile`` — a short second load on the same engine under
   ``torch.profiler``: device time by kernel group against wall time.

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
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values())})


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------

K4 = {"name": "paged_decode_attention_grouped", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
      "replaces": "src/repro/kernels/flash_attention.py:174"}
# serve-phase shapes: batch 8, llama3-8b heads, 16-token blocks, 1024 max_len
K4_SHAPES = dict(B=8, H=32, G=8, D=128, bs=16, W=64)
K4_POS = (0, 15, 16, 255, 511, 700, 1000, 1023)   # 0, block edges, W*bs-1
K4_TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # x max|out|
N_COPIES = 8        # rotated pool copies: the working set exceeds the L2


def k4_inputs(dtype, rng, device):
    """Inputs at the serve phase's shapes: every slot's valid blocks are
    distinct random blocks of the pool, its table tail is the scratch
    block 0, and block 0 holds large finite values that must never be
    read."""
    import torch
    s = K4_SHAPES
    b, h, g, d, bs, w = s["B"], s["H"], s["G"], s["D"], s["bs"], s["W"]
    n = 1 + b * w
    pos = np.asarray(K4_POS, np.int32)
    table = np.zeros((b, w), np.int32)
    for i, p in enumerate(pos):
        nv = p // bs + 1
        table[i, :nv] = rng.choice(n - 1, nv, replace=False) + 1
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


def phase_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, pools, table, pos = k4_inputs(dtype, rng, DEVICE)
        k0, v0 = pools[0][0], pools[0][1]
        out = paged_decode_attention_grouped(q, k0, v0, table, pos)
        want = ref.paged_decode_attention_ref(q, k0, v0, table, pos)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"K4 {name}: non-finite output")
        err = float((out.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if not err <= K4_TOL[name] * scale:
            raise AssertionError(f"K4 {name}: max abs err {err} > "
                                 f"{K4_TOL[name]} x {scale}")
        it = iter(range(1 << 30))

        def rotate(fn):
            return lambda: fn(pools[next(it) % N_COPIES])

        kernel_ms = cuda_ms(rotate(lambda p: paged_decode_attention_grouped(
            q, p[0], p[1], table, pos)))
        plain_ms = cuda_ms(rotate(lambda p: ref.paged_decode_attention_ref(
            q, p[0], p[1], table, pos)))
        # library yardstick: SDPA over KV pre-gathered through the table
        # and repeated to every query head (the gather is not timed). The
        # mask is additive (-inf past pos): in bf16 the default backend
        # (cuDNN) lets masked keys through under a boolean mask.
        s = K4_SHAPES
        rep = s["H"] // s["G"]
        length = s["W"] * s["bs"]
        keep = (torch.arange(length, device=DEVICE)[None]
                <= pos[:, None]).view(s["B"], 1, 1, length)
        bias = torch.zeros(keep.shape, dtype=dtype, device=DEVICE
                           ).masked_fill(~keep, float("-inf"))
        gathered = [
            tuple(p[j][table.long()].reshape(s["B"], length, s["G"], s["D"])
                  .repeat_interleave(rep, dim=2).transpose(1, 2)
                  .contiguous() for j in (0, 1)) for p in pools]
        q4 = q[:, :, None, :]
        lib = F.scaled_dot_product_attention(q4, *gathered[0],
                                             attn_mask=bias)[:, :, 0]
        lib_err = float((lib.float() - want.float()).abs().max())
        if not lib_err <= K4_TOL[name] * scale:
            raise AssertionError(f"SDPA yardstick {name}: max abs err "
                                 f"{lib_err} > {K4_TOL[name]} x {scale}")
        it2 = iter(range(1 << 30))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, *gathered[next(it2) % N_COPIES], attn_mask=bias))
        del gathered
        bound_ms, bound_by = k4_bound(q, pos, name)
        results[name] = {"dtype": name, "max_err": err,
                         "max_abs_out": scale, "tol": K4_TOL[name],
                         "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms,
                         "library_max_abs_err": lib_err}
        del pools
        torch.cuda.empty_cache()
    emit({"phase": "kernels", **K4, "shapes": K4_SHAPES,
          "positions": list(K4_POS),
          "launches": paged_decode_attention_grouped.launches,
          "results": list(results.values())})
    return results


# ---------------------------------------------------------------------------
# 3. parity: kernel vs gather path at full width, 2 layers, float32
# ---------------------------------------------------------------------------


def make_prompts(rng, n, lo, hi, vocab):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)),
                         dtype=np.int32) for _ in range(n)]


def phase_parity(seed: int) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.serve import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              dtype="float32")
    model = DecoderLM(cfg, device=DEVICE).init(seed)
    prompts = make_prompts(np.random.default_rng(seed), 4, 17, 40,
                           cfg.vocab_size)

    def drive(attn_kernel):
        ticks = []

        def sample(logits):
            ticks.append(logits.clone())
            return torch.argmax(logits, -1)

        eng = ServeEngine(cfg, model, batch=4, max_len=64, paged=True,
                          kv_block_size=16, prefill="batch",
                          attn_kernel=attn_kernel, sample=sample,
                          device=DEVICE)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_tokens=8))
        return {r.rid: r.out for r in eng.run()}, ticks

    got, lk = drive(True)
    want, lg = drive(False)
    if got != want:
        raise AssertionError(f"parity: tokens differ: kernel {got} vs "
                             f"gather {want}")
    if len(lk) != len(lg):
        raise AssertionError("parity: tick counts differ")
    worst = 0.0
    for a, b in zip(lk, lg):
        err = float((a - b).abs().max())
        lim = 1e-4 * float(b.abs().max())
        worst = max(worst, err / lim)
        if not err <= lim:
            raise AssertionError(f"parity: logits differ by {err} > {lim}")
    emit({"phase": "parity", "config": "llama3-8b n_layers=2 float32",
          "requests": len(prompts), "ticks": len(lk),
          "tokens_identical": True, "max_err_over_limit": worst})


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


def phase_profile(eng, seed: int) -> None:
    """Where a decode tick's time goes: a second load (8 requests,
    256-token prompts, 8 tokens each) on the serve phase's engine. The
    first tick (admission and prefill of all 8) runs untraced; the
    remaining decode ticks run under ``torch.profiler``: device time of
    every kernel, grouped into K4, matrix products and the rest, against
    the host's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request
    prompts = make_prompts(np.random.default_rng(seed + 2), 8, 256, 256,
                           eng.cfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=100 + i, prompt=p, max_tokens=8))
    eng.tick_once()
    torch.cuda.synchronize()
    ticks0 = eng._tick
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups = {"k4": 0.0, "matmul": 0.0, "other": 0.0}
    n_kernels = 0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        us = e.self_device_time_total
        name = e.key.lower()
        n_kernels += e.count
        if "paged_decode_kernel" in name:
            groups["k4"] += us
        elif any(k in name for k in ("gemm", "gemv", "xmma", "cutlass",
                                     "nvjet")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    device_s = sum(groups.values()) / 1e6
    emit({"phase": "profile", "requests": len(prompts),
          "ticks": eng._tick - ticks0, "wall_s": wall_s,
          "device_kernel_s": device_s,
          "device_kernel_s_per_tick": device_s / (eng._tick - ticks0),
          "device_busy_share_under_profiler": device_s / wall_s,
          "kernels_launched": n_kernels,
          "device_s_by_group": {k: v / 1e6 for k, v in groups.items()},
          "top_kernels": [{"name": e.key[:80], "count": e.count,
                           "device_s": e.self_device_time_total / 1e6}
                          for e in top]})


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
    phase_parity(args.seed)
    serve = phase_serve(args.seed)
    phase_profile(serve["engine"], args.seed)
    print(gpu_name_and_power_limit(), flush=True)
    bf = k4["bfloat16"]
    emit({"kernels": [{**K4, "launches": serve["launches"],
                       "max_abs_err": bf["max_err"],
                       "ms": bf["kernel_ms"], "plain_ms": bf["plain_ms"],
                       "bound_ms": bf["bound_ms"],
                       "bound_by": bf["bound_by"],
                       "library_ms": bf["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
