"""Numerics and cost model of the port: the paper's bit-exact PIM floating
point (``fp``, with the MTJ write logic ``logic``, the 4-step FA
``fulladder``, the subarray simulator ``subarray`` and the step-accurate
FP add ``fp_procedure``), the KV storage grids (``quant``), the paper's
cell, MAC-cost and accelerator model (``cell``, ``cost``,
``accelerator``, copies of the reference's) and the op counter on aten
graphs (``estimator``).

Exported here, as the reference's ``repro.core`` exports them: the
bit-exact PIM floating point (``fp32_add_pim``, ``fp32_mul_pim``,
``fp32_mac_pim``, ``pim_add``, ``pim_dot``), the 4-step FA and the
subarray state machine (``proposed_fa``, ``Subarray``, ...).
"""

from repro_torch.core.fp import (
    fp32_add_pim,
    fp32_mac_pim,
    fp32_mul_pim,
    pim_add,
    pim_dot,
)
from repro_torch.core.fulladder import (
    FLOATPIM_FA_CELLS,
    FLOATPIM_FA_STEPS,
    PROPOSED_FA_CELLS,
    PROPOSED_FA_STEPS,
    floatpim_fa,
    multibit_add,
    proposed_fa,
)
from repro_torch.core.subarray import Subarray

__all__ = ["FLOATPIM_FA_CELLS", "FLOATPIM_FA_STEPS", "PROPOSED_FA_CELLS",
           "PROPOSED_FA_STEPS", "Subarray", "floatpim_fa", "fp32_add_pim",
           "fp32_mac_pim", "fp32_mul_pim", "multibit_add", "pim_add",
           "pim_dot", "proposed_fa"]
