"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-*] — MoE, early fusion.

48 layers, d_model=5120, 40 q heads / 8 kv, interleaved MoE (every other
layer, Maverick's published pattern): 128 routed experts top-1 at d_ff=8192
plus one always-on shared expert; dense layers use d_ff=8192. Early-fusion
multimodality enters as precomputed embeddings (frontend stub).
Totals ~400B params / ~17B active per token.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    moe_d_ff=8192,
    moe_interleave=2,
    shared_expert=True,
    rope_theta=500000.0,
    fsdp=True,
    grad_accum=4,                 # activation memory
    opt_state_dtype="bfloat16",   # 400B on one 256-chip pod needs sub-fp32
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="llama4-maverick-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, moe_d_ff=128, n_experts=4,
        vocab_size=256, dtype="float32", remat=False, fsdp=False,
        grad_accum=1)
