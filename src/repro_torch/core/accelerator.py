"""Whole-DNN training cost simulator — reproduces Fig. 6.

A copy of the reference's ``repro/core/accelerator.py`` (pure Python).

Maps a DNN training workload (forward + backward + weight update) onto
1024x1024 PIM subarrays for both the proposed SOT-MRAM design and the
FloatPIM baseline, and reports total energy, latency, and area.

Mapping model (same policy for both designs, mirroring FloatPIM's layout so
the comparison is apples-to-apples — paper §4.1 "we adopt the same memory
subarray size ... and hardware architecture as the FloatPIM baseline"):

  * each layer is assigned one PIM *compute unit* per output activation
    ("unit" = one column in our column-parallel design, one row in
    FloatPIM's row-parallel design); a subarray hosts up to 1024 units;
  * per-unit cell footprint:
      proposed: weight bits of that unit + WORKSPACE_PROPOSED
                (FA caches 4+1 and the two ping-pong accumulator columns;
                operands are broadcast on shared row lines — the §4.3
                'design flexibility' advantage);
      floatpim: weight bits + a per-row *copy of the input operand bits*
                (row-local operands are required when operands,
                intermediates and results must share one row) + 12 FA cells
                + 455 intermediate-result cells (paper §2);
  * latency of one training step: layers execute their output units in
    parallel, MACs within a unit are sequential;
    fwd MACs x1, bwd x2 (grad wrt inputs + grad wrt weights), update = one
    MAC per parameter (lr*grad multiply + subtract add);
  * energy: MAC energy plus inter-layer activation write-out
    (activations + gradients written back to arrays between layers).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import cell as cell_mod
from repro_torch.core import cost as cost_mod

SUBARRAY_ROWS = 1024
SUBARRAY_COLS = 1024

# per-unit workspace cells (see DESIGN.md §2 and module docstring):
# proposed: 3 operand caches x32b are shared, per-unit: FA caches (4 + carry)
# + two 49-bit ping-pong accumulator columns.
WORKSPACE_PROPOSED = 4 + 1 + 2 * 49           # = 103
# floatpim: 12 FA cells + 455 intermediate cells per §2.
WORKSPACE_FLOATPIM = 12 + 455                 # = 467


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Cost-relevant description of one DNN layer."""

    name: str
    macs_fwd: int              # MACs for one forward pass of one sample
    weight_bits: int           # total parameter storage
    out_units: int             # output activations (parallel PIM units)
    in_bits_per_unit: int      # operand bits one unit consumes (fan-in * 32)
    out_act_bits: int          # activation bits written out per sample


@dataclasses.dataclass(frozen=True)
class TrainReport:
    energy_j: float
    latency_s: float
    area_m2: float
    n_subarrays: int
    detail: dict


def lenet_layers(n_bits: int = 32) -> list[LayerSpec]:
    """LeNet-type model of the paper's experiments (§4.1): 21,655 params
    (paper: 21,690 — exact layer split not published; see DESIGN.md §7).

    conv1 1->6 5x5, pool2, conv2 6->16 5x5, pool2, fc 256->64 -> 35 -> 10.
    Input 28x28x1 (MNIST).
    """
    specs = []

    def conv(name, cin, cout, k, out_hw):
        fan_in = cin * k * k
        units = cout * out_hw * out_hw
        specs.append(LayerSpec(
            name=name,
            macs_fwd=units * fan_in,
            weight_bits=(fan_in * cout + cout) * n_bits,
            out_units=units,
            in_bits_per_unit=fan_in * n_bits,
            out_act_bits=units * n_bits,
        ))

    def fc(name, fin, fout):
        specs.append(LayerSpec(
            name=name,
            macs_fwd=fin * fout,
            weight_bits=(fin * fout + fout) * n_bits,
            out_units=fout,
            in_bits_per_unit=fin * n_bits,
            out_act_bits=fout * n_bits,
        ))

    conv("conv1", 1, 6, 5, 24)
    conv("conv2", 6, 16, 5, 8)
    fc("fc1", 256, 64)
    fc("fc2", 64, 35)
    fc("fc3", 35, 10)
    return specs


def n_params(layers: list[LayerSpec], n_bits: int = 32) -> int:
    return sum(l.weight_bits for l in layers) // n_bits


class PIMAccelerator:
    """Cost simulator for one PIM accelerator design."""

    def __init__(self, tech: str = "proposed"):
        if tech == "proposed":
            self.mac = cost_mod.proposed_mac_cost()
            ops = cell_mod.derive_sot_mram_costs()
            self.e_write_bit = ops.e_write_j
            self.t_write_bit = ops.t_write_s
            self.workspace = WORKSPACE_PROPOSED
            self.per_unit_operand_copy = False
            self.cell_area = cell_mod.MRAMCellParams().cell_area_m2
            self.periph_factor = 0.35
        elif tech == "ultrafast":
            self.mac = cost_mod.ultrafast_mac_cost()
            ops = cell_mod.derive_ultrafast_costs()
            self.e_write_bit = ops.e_write_j
            self.t_write_bit = ops.t_write_s
            self.workspace = WORKSPACE_PROPOSED
            self.per_unit_operand_copy = False
            self.cell_area = cell_mod.MRAMCellParams().cell_area_m2
            self.periph_factor = 0.35
        elif tech == "floatpim":
            p = cost_mod.FloatPIMParams()
            self.mac = cost_mod.floatpim_mac_cost(p)
            self.e_write_bit = p.e_data_write_j
            self.t_write_bit = p.t_nor_s
            self.workspace = WORKSPACE_FLOATPIM
            self.per_unit_operand_copy = True
            self.cell_area = cell_mod.ReRAMCellParams().cell_area_m2
            # MAGIC arrays need full write/sense circuit stacks on both rows and
            # columns plus inter-block switch matrices (FloatPIM's own area
            # breakdown shows peripherals dominating) — calibrated, see
            # cost.py module docstring.
            self.periph_factor = 2.7
        else:
            raise ValueError(tech)
        self.tech = tech

    # -- area ---------------------------------------------------------------

    def total_cells(self, layers: list[LayerSpec]) -> int:
        cells = 0
        for l in layers:
            # every unit's weights must be resident at that unit (a column's
            # rows for us, a row's cells for FloatPIM) — true of both designs;
            # convs replicate the filter across spatial units in both.
            per_unit = l.in_bits_per_unit + self.workspace
            if self.per_unit_operand_copy:
                # FloatPIM additionally copies the *input operands* into each
                # row: operands/intermediates/results must share the row (§4.3
                # claim (2) — our column design broadcasts inputs on shared
                # row lines instead).
                per_unit += l.in_bits_per_unit
            cells += l.out_units * per_unit
            # activation buffers (double-buffered: value + gradient)
            cells += 2 * l.out_act_bits
        return cells

    def n_subarrays(self, layers: list[LayerSpec]) -> int:
        return max(1, math.ceil(self.total_cells(layers)
                                / (SUBARRAY_ROWS * SUBARRAY_COLS)))

    def area(self, layers: list[LayerSpec]) -> float:
        return self.total_cells(layers) * self.cell_area * (
            1.0 + self.periph_factor)

    # -- per-step latency / energy ------------------------------------------

    def step_macs(self, layers: list[LayerSpec], batch: int) -> int:
        fwd = sum(l.macs_fwd for l in layers)
        upd = n_params(layers)
        return 3 * fwd * batch + upd

    def step_latency(self, layers: list[LayerSpec], batch: int) -> float:
        t = 0.0
        for l in layers:
            seq_macs = 3 * batch * math.ceil(l.macs_fwd / max(l.out_units, 1))
            t += seq_macs * self.mac.t_mac_s
        upd_seq = math.ceil(
            n_params(layers) / sum(l.out_units for l in layers))
        t += upd_seq * self.mac.t_mac_s
        return t

    def step_energy(self, layers: list[LayerSpec], batch: int) -> float:
        e = self.step_macs(layers, batch) * self.mac.e_mac_j
        act_bits = sum(l.out_act_bits for l in layers)
        # fwd activations + bwd gradients written between layers
        e += 2 * batch * act_bits * self.e_write_bit
        # weight write-back after update
        e += sum(l.weight_bits for l in layers) * self.e_write_bit
        return e

    def train(self, layers: list[LayerSpec], batch: int,
              steps: int) -> TrainReport:
        el = self.step_energy(layers, batch) * steps
        tl = self.step_latency(layers, batch) * steps
        return TrainReport(
            energy_j=el,
            latency_s=tl,
            area_m2=self.area(layers),
            n_subarrays=self.n_subarrays(layers),
            detail={
                "tech": self.tech,
                "step_macs": self.step_macs(layers, batch),
                "t_mac_s": self.mac.t_mac_s,
                "e_mac_j": self.mac.e_mac_j,
                "total_cells": self.total_cells(layers),
            },
        )


def training_comparison(batch: int = 1, steps: int = 1) -> dict[str, float]:
    """Fig. 6: proposed vs FloatPIM on LeNet training (area/latency/energy)."""
    layers = lenet_layers()
    ours = PIMAccelerator("proposed").train(layers, batch, steps)
    theirs = PIMAccelerator("floatpim").train(layers, batch, steps)
    return {
        "area_ratio": theirs.area_m2 / ours.area_m2,          # paper: 2.5x
        "latency_ratio": theirs.latency_s / ours.latency_s,   # paper: 1.8x
        "energy_ratio": theirs.energy_j / ours.energy_j,      # paper: 3.3x
        "proposed": dataclasses.asdict(ours),
        "floatpim": dataclasses.asdict(theirs),
    }
