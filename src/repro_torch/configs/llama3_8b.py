"""Llama-3 8B [arXiv:2407.21783] — dense, GQA kv=8, 128k vocab."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    fsdp=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="llama3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32", remat=False)
