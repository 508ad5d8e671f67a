"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

Backbone only per the assignment: the EnCodec frontend is a stub —
``input_specs()`` provides precomputed frame embeddings [B, S, d_model];
decode emits codebook tokens (vocab 2048). kv=24 = full MHA.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    input_embed_stub=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=64, dtype="float32", remat=False)
