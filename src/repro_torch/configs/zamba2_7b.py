"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + weight-tied shared
attention block applied every 6 layers; ssm_state=64.

81 Mamba2 layers (13 groups of 6 + 3 tail), one shared attention+MLP block
(a single weight set, 13 invocation sites each with its own KV cache).
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_pattern="mamba_shared_attn",
    ssm_state=64,
    shared_attn_every=6,
    mamba_headdim=64,
    rope_style="none",   # zamba2 attention uses no RoPE on the shared block
    fsdp=True,
    grad_accum=2,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, ssm_state=16, shared_attn_every=2,
        mamba_headdim=16, vocab_size=256, dtype="float32", remat=False)
