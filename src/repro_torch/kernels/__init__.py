"""The port's hand-written CUDA kernels, their wrappers and plain versions."""

from repro_torch.kernels.flash_attention import (
    paged_decode_attention_grouped, paged_decode_attention_grouped_q)
from repro_torch.kernels.pim_mac import (pim_mac, pim_mac_grouped, pim_matmul,
                                         pim_matmul_grouped)
from repro_torch.kernels.ref import (paged_decode_attention_q_ref,
                                     paged_decode_attention_ref, pim_mac_ref,
                                     pim_matmul_grouped_ref, pim_matmul_ref)

__all__ = ["paged_decode_attention_grouped",
           "paged_decode_attention_grouped_q",
           "paged_decode_attention_q_ref", "paged_decode_attention_ref",
           "pim_mac", "pim_mac_grouped", "pim_mac_ref", "pim_matmul",
           "pim_matmul_grouped", "pim_matmul_grouped_ref", "pim_matmul_ref"]
