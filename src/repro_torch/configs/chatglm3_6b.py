"""ChatGLM3-6B [arXiv:2406.12793] — dense, GQA kv=2, 2d RoPE (rotary on
half the head dims, the GLM convention)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_style="half",
    fsdp=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="chatglm3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32", remat=False)
