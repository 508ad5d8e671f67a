"""Qwen3-32B [hf:Qwen/Qwen3-*] — dense, GQA, per-head q/k RMS norm."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    fsdp=True,
    grad_accum=2,   # activation memory (§Perf)
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, head_dim=16, vocab_size=256,
        dtype="float32", remat=False, fsdp=False)
