"""The port's hand-written CUDA kernels, their wrappers and plain versions."""

from repro_torch.kernels.flash_attention import (
    flash_attention, paged_decode_attention_grouped,
    paged_decode_attention_grouped_q)
from repro_torch.kernels.pim_fp import pim_fp32_mul
from repro_torch.kernels.pim_mac import (pim_mac, pim_mac_grouped, pim_matmul,
                                         pim_matmul_grouped,
                                         pim_matmul_grouped_q)
from repro_torch.kernels.ref import (flash_attention_ref,
                                     paged_decode_attention_q_ref,
                                     paged_decode_attention_ref,
                                     pim_fp32_mul_ref, pim_mac_ref,
                                     pim_matmul_grouped_q_ref,
                                     pim_matmul_grouped_ref, pim_matmul_ref)

__all__ = ["flash_attention", "flash_attention_ref",
           "paged_decode_attention_grouped",
           "paged_decode_attention_grouped_q",
           "paged_decode_attention_q_ref", "paged_decode_attention_ref",
           "pim_fp32_mul", "pim_fp32_mul_ref",
           "pim_mac", "pim_mac_grouped", "pim_mac_ref", "pim_matmul",
           "pim_matmul_grouped", "pim_matmul_grouped_q",
           "pim_matmul_grouped_q_ref", "pim_matmul_grouped_ref",
           "pim_matmul_ref"]
