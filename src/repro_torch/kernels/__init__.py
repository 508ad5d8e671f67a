"""The port's hand-written CUDA kernels, their wrappers and plain versions."""

from repro_torch.kernels.flash_attention import paged_decode_attention_grouped
from repro_torch.kernels.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention_grouped", "paged_decode_attention_ref"]
