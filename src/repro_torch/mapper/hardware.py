"""Explicit PIM hardware hierarchy: chip -> tile -> 1024x1024 subarray.

A copy of the reference's ``repro/mapper/hardware.py`` (pure Python, over
the port's ``core`` copies), so every placement and schedule prices on
the same machine to the bit. The shared-link routing of the pipeline
contention model (``route_links``, ``link_time``) is not ported yet
(ROADMAP.md, queue item 3.3).

The paper prices a single MAC (§3.3) and the Fig. 6 training comparison
aggregates op counts; neither says *where* a layer's weights live. This
module gives the mapper a concrete machine to place onto:

  * ``SubarraySpec``  — one 1024x1024 SOT-MRAM (or ReRAM) macro. Cell-level
    cost terms roll up from ``repro_torch.core.cell`` / ``repro_torch.core.cost`` (the
    §3.3 closed forms), so a subarray knows its per-MAC latency/energy, its
    per-bit write cost, and its weight capacity after reserving the paper's
    per-unit workspace cells (FA caches + ping-pong accumulator columns for
    the proposed design; the 455 intermediate cells for FloatPIM).
  * ``TileSpec``      — a cluster of subarrays on a shared activation bus.
  * ``ChipSpec``      — a mesh NoC of tiles; hop latency/energy per bit are
    NVSim-style knobs (the paper's own peripherals come from NVSim runs).
  * ``PIMHierarchy``  — the tree, plus the address arithmetic (flat subarray
    index -> (chip, tile, local)) and the inter-level transfer cost model
    the scheduler charges for activations crossing tile/chip boundaries.

Weight layout convention: one f32 value occupies ``n_bits`` cells along a
row, so a subarray stores ``weight_rows x weight_cols`` values and exposes
``cols`` column-parallel MAC lanes (operands broadcast on shared row lines —
the §4.3 flexibility claim, and the same lane provisioning rule
``repro_torch.core.estimator.pim_estimate`` uses).

Topology model: a tile's mesh coordinates are ``(x, y) = (t % d, t // d)``
with ``d = mesh_dim``. Transfers are routed XY (x first, then y); each
directed mesh edge, each tile's activation bus and each chip-pair SerDes
link is a *shared resource* with a bandwidth, so the scheduler can charge
per-link contention when several pipeline partitions stream microbatches
concurrently. Cross-chip moves pay real NoC legs — source tile to its
chip's IO corner (tile 0), the off-package link, IO corner to the
destination tile — not a flat per-hop constant.

``tile_curve`` enumerates a chip's tiles along a locality-preserving curve
(Hilbert for power-of-two meshes, serpentine otherwise); the
topology-aware placer allocates subarrays along such a curve so blocks
adjacent in allocation order are adjacent on the mesh.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import accelerator as acc_mod
from repro_torch.core import cell as cell_mod
from repro_torch.core import cost as cost_mod
from repro_torch.core import quant as quant_mod


@dataclasses.dataclass(frozen=True)
class SubarraySpec:
    """One PIM subarray macro with rolled-up §3.3 cost terms."""

    rows: int = acc_mod.SUBARRAY_ROWS
    cols: int = acc_mod.SUBARRAY_COLS
    n_bits: int = 32                     # cells per stored weight value
    weight_dtype: str = "fp32"           # storage grid (core.quant registry)
    workspace_rows: int = acc_mod.WORKSPACE_PROPOSED
    # rolled-up op costs (filled in by make_subarray)
    t_mac_s: float = 0.0
    e_mac_j: float = 0.0
    t_add_s: float = 0.0
    e_add_j: float = 0.0
    t_mul_s: float = 0.0
    e_mul_j: float = 0.0
    t_write_bit_s: float = 0.0
    e_write_bit_j: float = 0.0
    cell_area_m2: float = 0.0
    periph_factor: float = 0.35

    def __post_init__(self):
        if self.n_bits <= 0 or self.cols % self.n_bits:
            raise ValueError(
                f"subarray cols ({self.cols}) must divide evenly into "
                f"{self.n_bits}-bit weight slots — a silent floor would "
                f"mis-price capacity")

    @property
    def weight_rows(self) -> int:
        """Rows available for weights after the per-unit workspace reserve."""
        return self.rows - self.workspace_rows

    @property
    def weight_cols(self) -> int:
        """Values per row (a value spans ``n_bits`` cells)."""
        return self.cols // self.n_bits

    @property
    def capacity_values(self) -> int:
        return self.weight_rows * self.weight_cols

    @property
    def mac_lanes(self) -> int:
        """Column-parallel MAC units (same rule as ``pim_estimate``)."""
        return self.cols

    @property
    def area_m2(self) -> float:
        return (self.rows * self.cols * self.cell_area_m2
                * (1.0 + self.periph_factor))


def _mac_cost_at(tech: str, nm: int, ne: int) -> cost_mod.MacCost:
    """§3.3 closed-form MAC cost at an (nm, ne) bit-serial width."""
    if tech == "proposed":
        return cost_mod.proposed_mac_cost(cell_mod.derive_sot_mram_costs(),
                                          nm, ne)
    if tech == "ultrafast":
        return cost_mod.ultrafast_mac_cost(nm, ne)
    if tech == "floatpim":
        return cost_mod.floatpim_mac_cost(cost_mod.FloatPIMParams(), nm, ne)
    raise ValueError(tech)


def make_subarray(tech: str = "proposed", weight_dtype: str = "fp32", *,
                  n_bits: int | None = None,
                  workspace_rows: int | None = None) -> SubarraySpec:
    """Roll §3.3 cell costs up into one subarray's cost terms.

    ``weight_dtype`` selects the stored-weight grid from the
    ``core.quant`` registry: it sets ``n_bits`` (cells per value, hence
    ``weight_cols``) and re-derives the weight-side MAC latency/energy at
    the dtype's (nm, ne) bit-serial width — shorter mantissas mean fewer
    ripple cycles (the §3.3 closed forms are width-parameterized).
    Activations and eltwise peripherals stay fp32, so ``t_add_s`` /
    ``t_mul_s`` keep their fp32 values. ``n_bits`` / ``workspace_rows``
    override the dtype's storage footprint / the per-tech workspace
    reserve when given.
    """
    accel = acc_mod.PIMAccelerator(tech)
    qs = quant_mod.spec(weight_dtype)
    bits = qs.n_bits if n_bits is None else n_bits
    if qs.name == "fp32":
        mac = accel.mac                  # bit-identical to the legacy path
    else:
        # int grids (ne=0) run the mantissa datapath only; the closed
        # forms accept ne=0 directly.
        mac = _mac_cost_at(tech, qs.n_mant, qs.n_exp)
    workspace = (acc_mod.WORKSPACE_FLOATPIM if tech == "floatpim"
                 else acc_mod.WORKSPACE_PROPOSED)
    if workspace_rows is not None:
        workspace = workspace_rows
    return SubarraySpec(
        n_bits=bits,
        weight_dtype=qs.name,
        workspace_rows=workspace,
        t_mac_s=mac.t_mac_s, e_mac_j=mac.e_mac_j,
        t_add_s=accel.mac.t_add_s, e_add_j=accel.mac.e_add_j,
        t_mul_s=accel.mac.t_mul_s, e_mul_j=accel.mac.e_mul_j,
        t_write_bit_s=accel.t_write_bit, e_write_bit_j=accel.e_write_bit,
        cell_area_m2=accel.cell_area,
        periph_factor=accel.periph_factor,
    )


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Subarrays sharing one activation bus (single-hop, full bandwidth)."""

    subarrays: int = 16
    bus_bits_per_s: float = 1.024e12     # 128 GB/s shared activation bus
    e_bus_bit_j: float = 0.05e-12        # DAC/line energy per moved bit


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Tiles on a 2D-mesh NoC."""

    tiles: int = 64
    noc_bits_per_s: float = 5.12e11      # 64 GB/s per NoC link
    t_hop_s: float = 2.0e-9              # router+link latency per hop
    e_hop_bit_j: float = 0.1e-12         # per bit per hop

    @property
    def mesh_dim(self) -> int:
        return max(1, int(math.isqrt(self.tiles)))

    def tile_xy(self, tile: int) -> tuple[int, int]:
        d = self.mesh_dim
        return tile % d, tile // d


def _hilbert_xy(order: int, idx: int) -> tuple[int, int]:
    """Position of step ``idx`` on the Hilbert curve over a 2^order mesh."""
    x = y = 0
    t = idx
    s = 1
    n = 1 << order
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        if ry == 0:
            if rx == 1:
                x, y = s - 1 - x, s - 1 - y
            x, y = y, x
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


def tile_curve(chip: ChipSpec, kind: str) -> tuple[int, ...]:
    """Physical tile indices of one chip in curve visit order.

    ``kind``: ``"rowmajor"`` (identity — the flat packer's order),
    ``"snake"`` (serpentine rows: consecutive visits are always mesh
    neighbours), or ``"hilbert"`` (power-of-two square meshes only —
    raises otherwise; callers filter candidates via ``curve_candidates``).
    """
    d = chip.mesh_dim
    n = chip.tiles
    if kind == "rowmajor":
        return tuple(range(n))
    if kind == "snake":
        order = []
        for y in range((n + d - 1) // d):
            row = [t for t in range(y * d, min((y + 1) * d, n))]
            order.extend(row if y % 2 == 0 else row[::-1])
        return tuple(order)
    if kind == "hilbert":
        if d * d != n or d & (d - 1):
            raise ValueError(f"hilbert needs a power-of-two square mesh, "
                             f"got {n} tiles / dim {d}")
        order = int(math.log2(d))
        out = []
        for i in range(n):
            x, y = _hilbert_xy(order, i)
            out.append(y * d + x)
        return tuple(out)
    raise ValueError(f"unknown curve kind {kind!r}")


def curve_candidates(chip: ChipSpec) -> dict[str, tuple[int, ...]]:
    """The curve orders a topology-aware placer may choose between."""
    kinds = ["rowmajor", "snake"]
    d = chip.mesh_dim
    if d * d == chip.tiles and not (d & (d - 1)):
        kinds.append("hilbert")
    return {k: tile_curve(chip, k) for k in kinds}


@dataclasses.dataclass(frozen=True)
class PIMHierarchy:
    """chip -> tile -> subarray tree + transfer cost model."""

    tech: str
    subarray: SubarraySpec
    tile: TileSpec = TileSpec()
    chip: ChipSpec = ChipSpec()
    # inter-chip transfers (off-package SerDes) — only hit by huge models
    interchip_bits_per_s: float = 2.56e11
    e_interchip_bit_j: float = 1.0e-12

    @property
    def subarrays_per_chip(self) -> int:
        return self.tile.subarrays * self.chip.tiles

    @property
    def chip_capacity_values(self) -> int:
        return self.subarrays_per_chip * self.subarray.capacity_values

    def locate(self, sub_idx: int) -> tuple[int, int, int]:
        """Flat subarray index -> (chip, tile-in-chip, subarray-in-tile)."""
        chip, rem = divmod(sub_idx, self.subarrays_per_chip)
        tile, local = divmod(rem, self.tile.subarrays)
        return chip, tile, local

    def n_chips_for(self, n_subarrays: int) -> int:
        return max(1, math.ceil(n_subarrays / self.subarrays_per_chip))

    def n_tiles_for(self, n_subarrays: int) -> int:
        return max(1, math.ceil(n_subarrays / self.tile.subarrays))

    def _tile_hops(self, tile_a: int, tile_b: int) -> int:
        """Manhattan distance on the chip's tile mesh."""
        ax, ay = self.chip.tile_xy(tile_a)
        bx, by = self.chip.tile_xy(tile_b)
        return abs(ax - bx) + abs(ay - by)

    # tile 0 hosts the chip's off-package IO port: cross-chip transfers
    # route source tile -> IO corner -> SerDes -> IO corner -> dest tile
    IO_TILE = 0

    def hop_count(self, src_sub: int, dst_sub: int) -> int:
        """NoC mesh hops on the path between two subarrays' tiles (the
        same-tile bus is not a mesh hop; a chip crossing adds both chips'
        legs to/from their IO corners plus one SerDes hop)."""
        if src_sub == dst_sub:
            return 0
        c_a, t_a, _ = self.locate(src_sub)
        c_b, t_b, _ = self.locate(dst_sub)
        if c_a == c_b:
            return 0 if t_a == t_b else self._tile_hops(t_a, t_b)
        return (self._tile_hops(t_a, self.IO_TILE)
                + self._tile_hops(self.IO_TILE, t_b) + 1)

    def transfer_cost(self, bits: int, src_sub: int,
                      dst_sub: int) -> tuple[float, float]:
        """(latency_s, energy_j) to move ``bits`` from one subarray's tile
        to another's. Same subarray (co-located producer/consumer) -> free;
        same tile -> one bus transaction; same chip -> NoC hops; different
        chips -> NoC legs to/from each chip's IO corner plus the
        off-package link (the mesh position of both endpoints matters)."""
        if bits <= 0 or src_sub == dst_sub:
            return 0.0, 0.0
        c_a, t_a, _ = self.locate(src_sub)
        c_b, t_b, _ = self.locate(dst_sub)
        if c_a != c_b:
            legs = (self._tile_hops(t_a, self.IO_TILE)
                    + self._tile_hops(self.IO_TILE, t_b))
            t = (bits / self.interchip_bits_per_s
                 + (legs + 1) * self.chip.t_hop_s)
            e = bits * (self.e_interchip_bit_j
                        + legs * self.chip.e_hop_bit_j)
            return t, e
        if t_a == t_b:
            t = bits / self.tile.bus_bits_per_s
            e = bits * self.tile.e_bus_bit_j
            return t, e
        hops = self._tile_hops(t_a, t_b)
        t = bits / self.chip.noc_bits_per_s + hops * self.chip.t_hop_s
        e = bits * hops * self.chip.e_hop_bit_j
        return t, e

    def fingerprint(self) -> tuple:
        """Hashable identity of every geometry/cost knob — two hierarchies
        with equal fingerprints price and route transfers identically, so
        this belongs in every placement signature / program-cache key."""
        return (self.tech, dataclasses.astuple(self.subarray),
                dataclasses.astuple(self.tile),
                dataclasses.astuple(self.chip),
                self.interchip_bits_per_s, self.e_interchip_bit_j)

    def area_m2(self, n_subarrays: int) -> float:
        return n_subarrays * self.subarray.area_m2


def default_hierarchy(tech: str = "proposed", weight_dtype: str = "fp32",
                      **overrides) -> PIMHierarchy:
    """The hierarchy used throughout unless a caller overrides knobs.

    ``weight_dtype`` selects the stored-weight precision (see
    ``make_subarray``); ``overrides`` may replace ``tile`` / ``chip``
    specs or scalar knobs of ``PIMHierarchy``
    (e.g. ``tile=TileSpec(subarrays=32)``).
    """
    return PIMHierarchy(tech=tech,
                        subarray=make_subarray(tech, weight_dtype),
                        **overrides)
