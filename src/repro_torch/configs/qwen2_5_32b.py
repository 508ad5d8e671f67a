"""Qwen2.5-32B [hf:Qwen/Qwen2.5-*] — dense, GQA kv=8, QKV bias."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    fsdp=True,
    grad_accum=2,   # activation memory (§Perf)
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2.5-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
        remat=False, fsdp=False)
