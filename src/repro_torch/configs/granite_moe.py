"""Granite-3.0 1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d_model=1024, 16 q heads / 8 kv, MoE on every layer:
32 experts, top-8, expert d_ff=512.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    moe_interleave=1,
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=64, moe_d_ff=64, n_experts=4, top_k=2,
        vocab_size=256, dtype="float32", remat=False)
