"""xLSTM-350M [arXiv:2405.04517] — sLSTM + mLSTM blocks, no attention.

24 blocks at d_model=1024, 4 heads; blocks alternate mLSTM/sLSTM 1:1 (the
xLSTM paper evaluates [1:1] and [7:1] ratios; the reference takes 1:1).
d_ff=0: the xLSTM block carries its own 2x up/down projection instead of
a separate FFN.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern="xlstm",
    rope_style="none",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-350m-smoke", n_layers=4, d_model=64, n_heads=2,
        n_kv_heads=2, vocab_size=256, dtype="float32", remat=False)
