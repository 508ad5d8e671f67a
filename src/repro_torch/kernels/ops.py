"""Public entries for the PIM kernels: the port of
``repro/kernels/ops.py``'s ``mac`` and ``matmul``.

The reference's entries pick interpret mode off the TPU; the port's
wrappers pick by device themselves (CUDA tensors go to the kernels, CPU
tensors to their plain versions), so the entries are the wrappers. The
reference's ``attention`` entry (K7) is not ported yet (ROADMAP.md, queue
item 4).
"""

from repro_torch.kernels.pim_mac import pim_mac, pim_matmul

mac = pim_mac           # elementwise PIM MAC: acc + a*b (paper Fig. 5 unit)
matmul = pim_matmul     # blocked float32 matmul over (bm, bn, bk) tiles

__all__ = ["mac", "matmul"]
