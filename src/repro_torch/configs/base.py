"""Architecture config schema (a copy of the reference's ``ArchConfig``,
so the port reads the same configs and counts the same parameters), the
input shape of a step (``ShapeSpec``, the reference's) and the
production shapes every arch is laid out for (``LM_SHAPES``, with
``shape_applicable``: the long-context decode only for the recurrent
archs)."""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads

    # attention flavour
    qk_norm: bool = False         # qwen3
    qkv_bias: bool = False        # qwen2.5
    rope_style: str = "full"      # full | half (chatglm 2d) | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl (t, h, w) freq split

    # norms / head
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_interleave: int = 1       # every k-th layer is MoE
    shared_expert: bool = False   # llama4: one always-on shared expert
    capacity_factor: float = 1.25

    # block pattern
    block_pattern: str = "attn"   # attn | xlstm | mamba_shared_attn
    ssm_state: int = 0
    shared_attn_every: int = 6    # zamba2: shared block period
    mamba_conv_width: int = 4
    mamba_headdim: int = 64

    # modality frontend
    input_embed_stub: bool = False  # audio/vlm: inputs are embeddings
    needs_position_grid: bool = False  # vlm M-RoPE 3d positions

    # training / distribution defaults
    grad_accum: int = 1           # microbatches per step (activation memory)
    moe_groups: int = 32          # MoE dispatch groups (DP-shard aligned)
    dtype: str = "bfloat16"
    remat: bool = True
    fsdp: bool = False            # shard params over data axis too (ZeRO-3)
    opt_state_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else d * self.vocab_size
        per_attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            per_attn += (nq + 2 * nkv) * hd
        blocks = 0
        if self.block_pattern == "attn":
            dense_mlp = 3 * d * self.d_ff
            moe_mlp = (self.n_experts * 3 * d * self.moe_d_ff
                       + d * self.n_experts
                       + (3 * d * self.d_ff if self.shared_expert else 0))
            for i in range(self.n_layers):
                is_moe = (self.n_experts > 0
                          and (i % self.moe_interleave
                               == self.moe_interleave - 1))
                blocks += per_attn + (moe_mlp if is_moe else dense_mlp)
                blocks += 2 * d  # norms
        elif self.block_pattern == "xlstm":
            # mLSTM block: q,k,v,o + gates (i,f,o) + up/gate/down proj
            per_m = 4 * d * d + 3 * d * self.n_heads + 3 * d * (2 * d)
            per_s = 4 * d * d + 3 * d * self.n_heads + 3 * d * (2 * d)
            blocks = (self.n_layers // 2) * (per_m + per_s) + self.n_layers * d
        elif self.block_pattern == "mamba_shared_attn":
            d_in = 2 * d
            nh = d_in // self.mamba_headdim
            per_mamba = (d * (2 * d_in)            # in proj (x, z)
                         + d_in * self.ssm_state * 2   # B, C proj
                         + d * nh                  # dt proj
                         + self.mamba_conv_width * d_in
                         + d_in * d)               # out proj
            shared = per_attn + 3 * d * self.d_ff + 2 * d
            blocks = self.n_layers * (per_mamba + d) + shared
        return emb + head + blocks


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # train | prefill | decode


LM_SHAPES: Sequence[ShapeSpec] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

# archs for which long_500k applies (SSM / hybrid: sub-quadratic decode
# state; the full-attention archs skip it)
LONG_CONTEXT_ARCHS = ("xlstm-350m", "zamba2-7b")


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS
    return True
