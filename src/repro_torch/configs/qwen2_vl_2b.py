"""Qwen2-VL-2B [arXiv:2409.12191] — M-RoPE, dynamic resolution.

Backbone only: the ViT patch frontend is a stub — ``input_specs()`` provides
precomputed patch/text embeddings plus the 3d (temporal/height/width)
M-RoPE position grid. head_dim 128 split (16, 24, 24) across t/h/w
frequencies (Qwen2-VL's published mrope_section x2).
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    rope_style="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    input_embed_stub=True,
    needs_position_grid=True,
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, mrope_sections=(2, 3, 3),
        dtype="float32", remat=False)
