"""Public entries for the port's kernels: the port of
``repro/kernels/ops.py``'s ``mac``, ``matmul`` and ``attention``, and
``matmul_grouped_q`` (K5, which the reference exports from
``repro.kernels`` only).

The reference's entries pick interpret mode off the TPU; the port's
wrappers pick by device themselves (CUDA tensors go to the kernels, CPU
tensors to their plain versions), so the entries are the wrappers.
"""

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.pim_mac import (pim_mac, pim_matmul,
                                         pim_matmul_grouped_q)

mac = pim_mac           # elementwise PIM MAC: acc + a*b (paper Fig. 5 unit)
matmul = pim_matmul     # blocked float32 matmul over (bm, bn, bk) tiles
# grouped matmul over quantized stored weights, dequantized on load
matmul_grouped_q = pim_matmul_grouped_q
# causal GQA flash attention (K7), forward only; q_chunk / kv_chunk as the
# reference's
attention = flash_attention

__all__ = ["attention", "mac", "matmul", "matmul_grouped_q"]
