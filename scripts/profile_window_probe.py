"""How often a short ``torch.profiler`` window misses the kernel it holds.

Runs K7 (``repro_torch.kernels.ops.attention``) once per profiler session
at one of ``chip_smoke.py``'s K7 test shapes, in float32 and bfloat16,
in sessions padded as ``chip_smoke.device_profile`` pads them and in
unpadded ones, interleaved. Prints the card's name and power limit, then
one JSON line: per dtype and padding, the sessions run, those that saw no
K7 body and those that saw no device event at all. Needs a CUDA card:

    PYTHONPATH=src python3 scripts/profile_window_probe.py [--sessions 500]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SHAPE = (2, 128, 8, 8, 32)      # B, S, H, G, D


def main() -> int:
    import torch
    import chip_smoke
    from repro_torch.kernels import build, ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=500,
                    help="sessions per dtype and padding")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    build.build("flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, g, d = SHAPE
    counts = {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d)))
        for i in range(2 * args.sessions):
            pad = chip_smoke.PROFILE_PAD_S if i % 2 else 0.0
            with chip_smoke.device_profile(pad=pad) as prof:
                ops.attention(q, k, v, q_chunk=64, kv_chunk=64)
                torch.cuda.synchronize()
            keys = [e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            c = counts.setdefault(f"{name} pad={pad}", {
                "sessions": 0, "no_k7_body": 0, "no_device_event": 0})
            c["sessions"] += 1
            c["no_k7_body"] += not any("flash" in key for key in keys)
            c["no_device_event"] += not keys
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"shape": dict(zip("BSHGD", SHAPE)), "counts": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
