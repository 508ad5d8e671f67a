"""Topology-aware placement of an OpGraph onto a PIMHierarchy: the port of
``repro.mapper.placement``.

Each matmul/conv node's stationary (k x n) weight matrix is tiled into
subarray-sized blocks — ``weight_rows`` values tall (1024 rows minus the
paper's workspace reserve) by ``weight_cols`` values wide (1024 cells /
32 bits per value) — and the blocks are packed onto subarrays in node
order. Refinements over naive one-block-per-subarray:

  * **small-node sharing** — a single-block node whose k rows fit in the
    open partially-filled subarray's free row-bands is co-located there
    (shelf packing by whole rows, so co-located grids never overlap), and
    a LeNet does not burn five subarrays on 21.7k parameters;
  * **replication** — small *hot* nodes (high MACs per provisioned lane)
    are replicated ``r`` times; replicas serve interleaved activation rows,
    multiplying throughput at the cost of ``r`` x area;
  * **topology-aware packing** — packing hands out *allocation* indices;
    a locality-preserving curve over each chip's tile mesh
    (``repro_torch.mapper.hardware.tile_curve``) maps them to physical
    subarrays. The packer evaluates the candidate curves against the
    graph's actual edges and keeps the cheapest (never worse than the
    flat row-major order, which ``PlacementPolicy(topology="flat")``
    forces).

Placements are stored aggregately (``NodePlacement`` holds the block grid,
not per-block objects); ``Placement.iter_blocks`` materializes
``PlacedBlock``s with explicit (chip, tile, subarray) coordinates on
demand. Eltwise nodes run in the shared peripheral FP units and take no
placement.

Not ported yet: pipeline partitions (``partition``, ``GraphPartition``,
the policy's ``align_partitions``), paged-KV placement (``place_kv``) and
sub-32-bit weight grids with their extra replicas (``spend_saved_area``);
see ROADMAP.md, queue item 3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

from repro_torch.mapper.graph import OpGraph, OpNode
from repro_torch.mapper.hardware import PIMHierarchy, curve_candidates


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """Knobs for the greedy weight-stationary packer."""

    replicate_small_hot: bool = True
    small_node_subarrays: int = 2     # replication candidates span <= this
    hot_macs_per_lane: float = 65536  # replicate until macs/lane <= this
    max_replicas: int = 8
    share_subarrays: bool = True      # co-locate whole small nodes
    topology: str = "affinity"        # "affinity" (curve search) | "flat"


@dataclasses.dataclass(frozen=True)
class PlacedBlock:
    """One weight block resident on one subarray (value coordinates).

    ``subarray`` is an *allocation* index when yielded by
    ``NodePlacement.iter_blocks`` (the lowering rules only need the block
    grid) and a *physical* index — with ``(chip, tile, local)`` coordinates
    filled in — when yielded by ``Placement.iter_blocks``.
    """

    node: int
    replica: int
    row0: int
    col0: int
    n_rows: int
    n_cols: int
    subarray: int
    chip: int = -1
    tile: int = -1
    local: int = -1


@dataclasses.dataclass
class NodePlacement:
    """Aggregate placement of one node's weight block grid."""

    node: int
    weight_rows: int                  # k (values)
    weight_cols: int                  # n (values)
    row_blocks: int
    col_blocks: int
    replicas: int
    first_subarray: int               # allocation index (see Placement)
    shared: bool = False              # True -> rides the open subarray

    @property
    def blocks_per_replica(self) -> int:
        return self.row_blocks * self.col_blocks

    @property
    def n_subarrays(self) -> int:
        """Distinct subarrays this node occupies (shared nodes count the
        host subarray once; it may also host other nodes)."""
        return 1 if self.shared else self.blocks_per_replica * self.replicas

    def lanes(self, hierarchy: PIMHierarchy) -> int:
        return self.n_subarrays * hierarchy.subarray.mac_lanes

    def iter_blocks(self, hierarchy: PIMHierarchy,
                    replica: int | None = None) -> Iterator[PlacedBlock]:
        sub = hierarchy.subarray
        br, bc = sub.weight_rows, sub.weight_cols
        replicas = [replica] if replica is not None else range(self.replicas)
        for rep in replicas:
            for i in range(self.row_blocks):
                for j in range(self.col_blocks):
                    flat = (rep * self.blocks_per_replica
                            + i * self.col_blocks + j)
                    yield PlacedBlock(
                        node=self.node, replica=rep,
                        row0=i * br, col0=j * bc,
                        n_rows=min(br, self.weight_rows - i * br),
                        n_cols=min(bc, self.weight_cols - j * bc),
                        subarray=(self.first_subarray
                                  if self.shared
                                  else self.first_subarray + flat))


@dataclasses.dataclass
class Placement:
    hierarchy: PIMHierarchy
    policy: PlacementPolicy
    node_placements: dict[int, NodePlacement]
    n_subarrays: int
    curve: str = "rowmajor"                  # chosen tile enumeration
    tile_order: tuple[int, ...] | None = None  # None == identity

    @property
    def n_tiles(self) -> int:
        return self.hierarchy.n_tiles_for(self.n_subarrays)

    @property
    def n_chips(self) -> int:
        return self.hierarchy.n_chips_for(self.n_subarrays)

    @property
    def area_m2(self) -> float:
        return self.hierarchy.area_m2(self.n_subarrays)

    def physical_subarray(self, alloc: int) -> int:
        """Allocation index -> physical subarray index: the chosen curve
        permutes tile visit order within each chip; chip and within-tile
        order are preserved."""
        if self.tile_order is None:
            return alloc
        h = self.hierarchy
        chip, rem = divmod(alloc, h.subarrays_per_chip)
        tile_enum, local = divmod(rem, h.tile.subarrays)
        return (chip * h.subarrays_per_chip
                + self.tile_order[tile_enum] * h.tile.subarrays + local)

    def coords(self, alloc: int) -> tuple[int, int, int]:
        """Allocation index -> explicit (chip, tile, subarray-in-tile)."""
        return self.hierarchy.locate(self.physical_subarray(alloc))

    def home_subarray(self, node_idx: int) -> int | None:
        """Physical subarray holding the node's first block (its 'home' —
        where input activations are gathered)."""
        np_ = self.node_placements.get(node_idx)
        return (self.physical_subarray(np_.first_subarray)
                if np_ is not None else None)

    def home_coords(self, node_idx: int) -> tuple[int, int, int] | None:
        np_ = self.node_placements.get(node_idx)
        return self.coords(np_.first_subarray) if np_ is not None else None

    def iter_blocks(self, node_idx: int,
                    replica: int | None = None) -> Iterator[PlacedBlock]:
        """The node's blocks with physical subarray indices and explicit
        (chip, tile, subarray) coordinates."""
        np_ = self.node_placements[node_idx]
        for blk in np_.iter_blocks(self.hierarchy, replica):
            phys = self.physical_subarray(blk.subarray)
            chip, tile, local = self.hierarchy.locate(phys)
            yield dataclasses.replace(blk, subarray=phys, chip=chip,
                                      tile=tile, local=local)

    def signature(self) -> tuple:
        """Hashable identity of where every block lands *and* of the
        machine it lands on — two placements with equal signatures lower
        to identical compiled programs with identical costs, so this is
        the placement component of the program-cache key."""
        return (self.hierarchy.fingerprint(), self.curve,
                tuple(sorted(
                    (idx, np_.weight_rows, np_.weight_cols, np_.row_blocks,
                     np_.col_blocks, np_.replicas, np_.first_subarray,
                     np_.shared)
                    for idx, np_ in self.node_placements.items())))


def node_homes(graph: OpGraph, placement: Placement) -> dict[int, int]:
    """Physical home subarray per node: placed nodes live where their
    weights start; eltwise nodes compute at their first producer's
    peripherals (or subarray 0 when they have no placed ancestor)."""
    homes: dict[int, int] = {}
    for node in graph.nodes:
        home = placement.home_subarray(node.idx)
        if home is None:
            home = next((homes[d] for d in node.deps if d in homes), 0)
        homes[node.idx] = home
    return homes


def _edge_hops(graph: OpGraph, placement: Placement) -> int:
    homes = node_homes(graph, placement)
    h = placement.hierarchy
    return sum(h.hop_count(homes[d], homes[node.idx])
               for node in graph.nodes for d in node.deps)


def total_transfer_hops(graph: OpGraph, placement: Placement) -> int:
    """Total NoC mesh hops on every producer->consumer activation path —
    the locality objective the topology-aware packer minimizes."""
    return _edge_hops(graph, placement)


def _replicas_for(node: OpNode, blocks: int, lanes_per_sub: int,
                  policy: PlacementPolicy) -> int:
    if not policy.replicate_small_hot or blocks > policy.small_node_subarrays:
        return 1
    lanes = blocks * lanes_per_sub
    want = math.ceil(node.macs / (lanes * policy.hot_macs_per_lane))
    return max(1, min(policy.max_replicas, want))


def place(graph: OpGraph, hierarchy: PIMHierarchy,
          policy: PlacementPolicy | None = None) -> Placement:
    """Greedy weight-stationary packing in topological node order.

    With ``policy.topology == "affinity"`` the packer evaluates the
    hierarchy's candidate tile curves against the graph's
    producer->consumer edges and keeps the one with the fewest total mesh
    hops (ties go to flat row-major). Sub-32-bit weight grids are not
    ported yet and raise.
    """
    policy = policy or PlacementPolicy()
    if policy.topology not in ("affinity", "flat"):
        raise ValueError(f"topology must be 'affinity' or 'flat', "
                         f"got {policy.topology!r}")
    sub = hierarchy.subarray
    if sub.n_bits < 32:
        raise NotImplementedError(
            f"{sub.weight_dtype!r} weight grids are not ported yet "
            f"(ROADMAP.md, queue item 3.4, with K5)")

    placements: dict[int, NodePlacement] = {}
    next_free = 0                     # next unallocated subarray (alloc idx)
    open_sub = -1                     # partially-filled shared subarray
    open_free_rows = 0                # whole row-bands left on the shelf

    for node in graph.matmul_like():
        k, n = node.weight_shape
        row_blocks = max(1, math.ceil(k / sub.weight_rows))
        col_blocks = max(1, math.ceil(n / sub.weight_cols))
        blocks = row_blocks * col_blocks
        replicas = _replicas_for(node, blocks, sub.mac_lanes, policy)
        # the shelf hands out whole row-bands (a co-located node gets all
        # weight_cols columns of its k rows), so co-located grids can
        # never physically overlap.
        if (policy.share_subarrays and blocks == 1 and replicas == 1
                and k <= open_free_rows):
            placements[node.idx] = NodePlacement(
                node=node.idx, weight_rows=k, weight_cols=n,
                row_blocks=1, col_blocks=1, replicas=1,
                first_subarray=open_sub, shared=True)
            open_free_rows -= k
            continue
        placements[node.idx] = NodePlacement(
            node=node.idx, weight_rows=k, weight_cols=n,
            row_blocks=row_blocks, col_blocks=col_blocks,
            replicas=replicas, first_subarray=next_free)
        if blocks == 1 and replicas == 1 and k < sub.weight_rows:
            # this node's lone block opens (or refreshes) the shared shelf
            open_sub = next_free
            open_free_rows = sub.weight_rows - k
        next_free += blocks * replicas

    placement = Placement(hierarchy=hierarchy, policy=policy,
                          node_placements=placements,
                          n_subarrays=max(1, next_free))
    if policy.topology == "affinity" and placement.n_tiles > 1:
        best_name, best_order, best_hops = "rowmajor", None, None
        for name, order in curve_candidates(hierarchy.chip).items():
            placement.curve = name
            placement.tile_order = None if name == "rowmajor" else order
            hops = _edge_hops(graph, placement)
            if best_hops is None or hops < best_hops or (
                    hops == best_hops and name == "rowmajor"):
                best_name, best_order, best_hops = (
                    name, placement.tile_order, hops)
        placement.curve = best_name
        placement.tile_order = best_order
    return placement
