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
  * **quantized replicas** — with a sub-32-bit weight grid a value takes
    fewer cells, so the same weights need fewer subarrays; the subarrays
    freed against the fp32 placement of the same graph are spent on extra
    replicas of the hottest nodes (``PlacementPolicy.spend_saved_area``),
    so density becomes throughput at equal area;
  * **topology-aware packing** — packing hands out *allocation* indices;
    a locality-preserving curve over each chip's tile mesh
    (``repro_torch.mapper.hardware.tile_curve``) maps them to physical
    subarrays. The packer evaluates the candidate curves against the
    graph's actual edges and keeps the cheapest (never worse than the
    flat row-major order, which ``PlacementPolicy(topology="flat")``
    forces);
  * **pipeline partitions** — ``partition()`` cuts the op graph into K
    balanced partitions on top-level unit boundaries
    (``repro_torch.mapper.graph.Unit``, the reference's top-level
    equations: the only places an executable program split can land),
    preferring boundaries where few activation bits cross. Passing the
    partitions to ``place`` aligns each partition's first block to a tile
    boundary so consecutive pipeline stages occupy disjoint, mesh-adjacent
    tile runs.

Placements are stored aggregately (``NodePlacement`` holds the block grid,
not per-block objects); ``Placement.iter_blocks`` materializes
``PlacedBlock``s with explicit (chip, tile, subarray) coordinates on
demand. Eltwise nodes run in the shared peripheral FP units and take no
placement.

Nodes inside a folded layer stack (``repeat > 1``) are placed once and
time-multiplexed: successive iterations stream their weight slice into
the same block grid. Partition cuts never land inside a folded stack — it
is one unit — unless the graph was first expanded with
``repro_torch.mapper.graph.expand_graph`` (``build_schedule(...,
expand_scans=True)``), which leaves resident per-layer copies at top
level where subarray capacity allows.

A paged KV pool is resident state, not weights: ``place_kv`` packs its
blocks onto the subarrays after the weight region, next to the attention
stack that reads them (``KVBlockSpec``, ``KVPlacement``).
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
    align_partitions: bool = True     # partition starts on tile boundaries
    # quantized datapath: grant extra replicas of the hottest nodes from
    # the subarrays a sub-32-bit weight grid frees at fp32-equivalent area
    # (a switch kept for parity with the reference's policy)
    spend_saved_area: bool = True


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


# ---------------------------------------------------------------------------
# pipeline partitions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """One contiguous pipeline partition: top-level units [unit_start,
    unit_end) and every graph node they own. ``in_bits``/``out_bits`` are
    the activation bits crossing the upstream/downstream boundary per
    activation set (the microbatch transfer the pipeline streams)."""

    idx: int
    unit_start: int
    unit_end: int
    nodes: tuple[int, ...]
    macs: int
    adds: int
    muls: int
    in_bits: int
    out_bits: int

    @property
    def work(self) -> int:
        return self.macs + self.adds + self.muls


def _boundary_cut_bits(graph: OpGraph, n_bits: int) -> list[int]:
    """cut[b] = activation bits that must cross a pipeline boundary placed
    before unit ``b`` — every value produced by an earlier unit and still
    read at or after ``b`` (or returned). Function inputs are not
    counted: weights are resident per partition and batch inputs enter at
    the stage that first reads them (``OpGraph.values``)."""
    n_units = len(graph.units)
    diff = [0] * (n_units + 2)
    for p, last, elems in graph.values:
        live_to = min(last, n_units)
        if live_to > p:
            bits = elems * n_bits
            diff[p + 1] += bits
            diff[live_to + 1] -= bits
    cut = [0] * (n_units + 1)
    acc = 0
    for b in range(n_units + 1):
        acc += diff[b]
        cut[b] = acc
    cut[0] = 0
    if n_units:
        cut[n_units] = 0
    return cut


def partition(graph: OpGraph, k: int, *, n_bits: int = 32,
              balance_slack: float = 0.25) -> list[GraphPartition]:
    """Cut ``graph`` into ``k`` balanced pipeline partitions.

    Boundaries land on top-level unit boundaries (the only executable
    split points — a folded layer stack is one uncuttable unit unless
    ``expand_graph`` left its layers at top level first). A first DP
    finds the best achievable bottleneck (minimal max partition work); a
    second DP then picks, among all boundary sets whose bottleneck stays
    within ``1 + balance_slack`` of that optimum, the one moving the
    fewest activation bits across boundaries. ``k`` is clamped to the
    number of units. The reference's two programs, over units.
    """
    if k < 1:
        raise ValueError(f"need k >= 1 partitions, got {k}")
    n_units = len(graph.units)
    if n_units == 0:
        return [GraphPartition(idx=0, unit_start=0, unit_end=0, nodes=(),
                               macs=0, adds=0, muls=0, in_bits=0,
                               out_bits=0)]
    k = min(k, n_units)

    work = [0] * n_units
    for nd in graph.nodes:
        work[nd.top_unit] += nd.macs + nd.adds + nd.muls
    prefix = [0]
    for w in work:
        prefix.append(prefix[-1] + w)

    def span(a: int, b: int) -> int:
        return prefix[b] - prefix[a]

    cut = _boundary_cut_bits(graph, n_bits)

    # DP 1: minimal achievable bottleneck over contiguous k-partitions
    inf = float("inf")
    best = [[inf] * (n_units + 1) for _ in range(k + 1)]
    best[0][0] = 0.0
    for parts in range(1, k + 1):
        for end in range(parts, n_units - (k - parts) + 1):
            b = inf
            for start in range(parts - 1, end):
                if math.isinf(best[parts - 1][start]):
                    continue
                b = min(b, max(best[parts - 1][start], span(start, end)))
            best[parts][end] = b
    cap = best[k][n_units] * (1.0 + balance_slack)

    # DP 2: among <=cap partitionings, minimize total boundary cut bits
    cost = [[inf] * (n_units + 1) for _ in range(k + 1)]
    back: list[list[int]] = [[-1] * (n_units + 1) for _ in range(k + 1)]
    cost[0][0] = 0.0
    for parts in range(1, k + 1):
        for end in range(parts, n_units - (k - parts) + 1):
            for start in range(parts - 1, end):
                if (math.isinf(cost[parts - 1][start])
                        or span(start, end) > cap):
                    continue
                c = cost[parts - 1][start] + (cut[start] if start else 0)
                if c < cost[parts][end]:
                    cost[parts][end] = c
                    back[parts][end] = start
    bounds = [n_units]
    for parts in range(k, 0, -1):
        bounds.append(back[parts][bounds[-1]])
    bounds = bounds[::-1]
    assert bounds[0] == 0 and bounds[-1] == n_units, bounds

    parts_out: list[GraphPartition] = []
    for i in range(k):
        s, e = bounds[i], bounds[i + 1]
        nodes = tuple(nd.idx for nd in graph.nodes if s <= nd.top_unit < e)
        parts_out.append(GraphPartition(
            idx=i, unit_start=s, unit_end=e, nodes=nodes,
            macs=sum(graph.nodes[j].macs for j in nodes),
            adds=sum(graph.nodes[j].adds for j in nodes),
            muls=sum(graph.nodes[j].muls for j in nodes),
            in_bits=cut[s] if i else 0,
            out_bits=cut[e] if i < k - 1 else 0))
    return parts_out


# ---------------------------------------------------------------------------
# the placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Placement:
    hierarchy: PIMHierarchy
    policy: PlacementPolicy
    node_placements: dict[int, NodePlacement]
    n_subarrays: int
    curve: str = "rowmajor"                  # chosen tile enumeration
    tile_order: tuple[int, ...] | None = None  # None == identity
    partitions: list[GraphPartition] | None = None

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


# ---------------------------------------------------------------------------
# KV page placement (paged serving state, not weights)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVBlockSpec:
    """Geometry of a paged KV pool the mapper places as resident state.

    ``sites`` counts the attention sites that read/write the pool (layer
    scan units x attention blocks per unit); each site owns its own
    ``num_blocks`` x ``block_size``-token pool slice. ``token_bits`` is
    the K+V bits one token occupies at one site."""

    sites: int
    num_blocks: int
    block_size: int
    token_bits: int

    @property
    def block_bits(self) -> int:
        return self.block_size * self.token_bits

    @property
    def total_bits(self) -> int:
        return self.sites * self.num_blocks * self.block_bits


@dataclasses.dataclass
class KVPlacement:
    """Where each site's KV blocks live, and which subarray consumes them.

    KV pages get allocation indices *after* the weight region and map
    through the placement's locality curve, so pages adjacent in
    allocation order are mesh-adjacent and the pool as a whole sits on
    the tiles immediately following the weights — near the scanned
    attention stack that is always packed last. ``site_consumer`` holds
    each site's attention consumer home (where gathered blocks are
    streamed to), cycled over the consumer nodes' physical homes."""

    spec: KVBlockSpec
    placement: Placement
    site_first: tuple[int, ...]       # allocation index of site's first page
    blocks_per_subarray: int
    site_consumer: tuple[int, ...]    # physical consumer subarray per site
    n_subarrays: int                  # pool subarrays, all sites

    def block_home(self, site: int, block: int) -> int:
        """Physical subarray holding one (site, block) KV page."""
        alloc = self.site_first[site] + block // self.blocks_per_subarray
        return self.placement.physical_subarray(alloc)

    def consumer_home(self, site: int) -> int:
        return self.site_consumer[site]

    def block_coords(self, site: int, block: int) -> tuple[int, int, int]:
        return self.placement.hierarchy.locate(self.block_home(site, block))


def place_kv(graph: OpGraph, placement: Placement,
             spec: KVBlockSpec) -> KVPlacement:
    """Assign a paged KV pool to (chip, tile, subarray) coordinates near
    its attention consumers.

    Blocks pack into subarrays by capacity (a subarray stores
    ``capacity_values * n_bits`` bits) and take allocation indices
    directly after the weight region — the placement's locality curve
    then lands them on mesh-adjacent tiles next to the last-placed
    weights. Consumer anchors come from the placed matmul nodes with the
    highest ``repeat`` (the scanned layer stack the attention sites live
    in), falling back to all placed nodes; sites cycle over those homes
    so per-site traffic spreads across the consumer tiles. Raises
    ``ValueError`` when one block exceeds a subarray's capacity."""
    if spec.sites < 1 or spec.num_blocks < 1:
        raise ValueError(f"need >= 1 site and >= 1 block, got "
                         f"{spec.sites} sites / {spec.num_blocks} blocks")
    sub = placement.hierarchy.subarray
    cap_bits = sub.capacity_values * sub.n_bits
    if spec.block_bits > cap_bits:
        raise ValueError(
            f"one KV block ({spec.block_bits} bits) exceeds a subarray's "
            f"capacity ({cap_bits} bits); shrink block_size")
    blocks_per_sub = max(1, cap_bits // spec.block_bits)
    subs_per_site = math.ceil(spec.num_blocks / blocks_per_sub)

    placed = [nd for nd in graph.matmul_like()
              if nd.idx in placement.node_placements]
    if placed:
        max_rep = max(nd.repeat for nd in placed)
        anchors = [nd for nd in placed if nd.repeat == max_rep] or placed
        homes = [placement.home_subarray(nd.idx) for nd in anchors]
    else:
        homes = [0]
    base = placement.n_subarrays
    return KVPlacement(
        spec=spec, placement=placement,
        site_first=tuple(base + i * subs_per_site
                         for i in range(spec.sites)),
        blocks_per_subarray=blocks_per_sub,
        site_consumer=tuple(homes[i % len(homes)]
                            for i in range(spec.sites)),
        n_subarrays=spec.sites * subs_per_site)


def _replicas_for(node: OpNode, blocks: int, lanes_per_sub: int,
                  policy: PlacementPolicy) -> int:
    if not policy.replicate_small_hot or blocks > policy.small_node_subarrays:
        return 1
    lanes = blocks * lanes_per_sub
    want = math.ceil(node.macs / (lanes * policy.hot_macs_per_lane))
    return max(1, min(policy.max_replicas, want))


def _fp32_area_budget(graph: OpGraph, hierarchy: PIMHierarchy,
                      policy: PlacementPolicy,
                      partitions: list[GraphPartition] | None) -> int:
    """Subarrays the same graph would occupy under fp32 weight storage —
    the *equal-area* envelope a quantized placement may spend."""
    ref_sub = dataclasses.replace(hierarchy.subarray, n_bits=32,
                                  weight_dtype="fp32")
    ref_h = dataclasses.replace(hierarchy, subarray=ref_sub)
    # flat topology: the curve search doesn't change n_subarrays
    ref_policy = dataclasses.replace(policy, topology="flat")
    return place(graph, ref_h, ref_policy,
                 partitions=partitions).n_subarrays


def _grant_extra_replicas(graph: OpGraph, hierarchy: PIMHierarchy,
                          policy: PlacementPolicy,
                          partitions: list[GraphPartition] | None,
                          grids: dict[int, list]) -> None:
    """Spend the subarrays a sub-32-bit grid frees (vs the fp32 placement
    of the same graph) on extra replicas of the hottest placed nodes.

    Heat = MACs per provisioned lane; each grant buys one full block-grid
    copy, greedily for the currently hottest node that still fits the
    remaining budget, until the fp32-equivalent area is spent or every
    node hits ``policy.max_replicas``. Mutates ``grids`` in place."""
    sub = hierarchy.subarray
    budget = _fp32_area_budget(graph, hierarchy, policy, partitions)
    nodes = {nd.idx: nd for nd in graph.matmul_like()}
    used = sum(rb * cb * rep for rb, cb, rep in grids.values())
    while True:
        extra = budget - used
        if extra <= 0:
            break
        best, best_heat = None, 0.0
        for idx, (rb, cb, rep) in grids.items():
            blocks = rb * cb
            if blocks > extra or rep >= policy.max_replicas:
                continue
            heat = nodes[idx].macs / (rep * blocks * sub.mac_lanes)
            if heat > best_heat:
                best, best_heat = idx, heat
        if best is None or best_heat <= 0.0:
            break
        grids[best][2] += 1
        used += grids[best][0] * grids[best][1]


def place(graph: OpGraph, hierarchy: PIMHierarchy,
          policy: PlacementPolicy | None = None,
          partitions: list[GraphPartition] | None = None) -> Placement:
    """Greedy weight-stationary packing in topological node order.

    With ``partitions``, each partition's first block is aligned to a tile
    boundary (and the sharing shelf reset), so pipeline stages occupy
    disjoint tile runs. With ``policy.topology == "affinity"`` the packer
    evaluates the hierarchy's candidate tile curves against the graph's
    producer->consumer edges and keeps the one with the fewest total mesh
    hops (ties go to flat row-major).

    With a sub-32-bit weight grid (``subarray.n_bits < 32``) and
    ``policy.spend_saved_area``, a pre-pass compares against the fp32
    placement of the same graph and grants the freed subarrays as extra
    replicas of the hottest nodes (by MACs per provisioned lane), so
    density converts to throughput at equal area.
    """
    policy = policy or PlacementPolicy()
    if policy.topology not in ("affinity", "flat"):
        raise ValueError(f"topology must be 'affinity' or 'flat', "
                         f"got {policy.topology!r}")
    sub = hierarchy.subarray

    # pass 1: block grids + base replica counts for every placed node
    grids: dict[int, list] = {}       # idx -> [row_blocks, col_blocks, reps]
    for node in graph.matmul_like():
        k, n = node.weight_shape
        row_blocks = max(1, math.ceil(k / sub.weight_rows))
        col_blocks = max(1, math.ceil(n / sub.weight_cols))
        grids[node.idx] = [row_blocks, col_blocks,
                           _replicas_for(node, row_blocks * col_blocks,
                                         sub.mac_lanes, policy)]
    # pass 2 (quantized grids only): replication from the area dividend
    if policy.spend_saved_area and sub.n_bits < 32 and grids:
        _grant_extra_replicas(graph, hierarchy, policy, partitions, grids)

    placements: dict[int, NodePlacement] = {}
    next_free = 0                     # next unallocated subarray (alloc idx)
    open_sub = -1                     # partially-filled shared subarray
    open_free_rows = 0                # whole row-bands left on the shelf

    node_part: dict[int, int] = {}    # node idx -> partition idx
    if partitions:
        node_part = {n: p.idx for p in partitions for n in p.nodes}
    cur_part = -1                     # partition of the last placed node

    for node in graph.matmul_like():
        part = node_part.get(node.idx, cur_part)
        if (policy.align_partitions and part != cur_part
                and cur_part >= 0 and next_free > 0):
            # new pipeline stage: start on a fresh tile, close the shelf
            # (keyed on the partition transition between *placed* nodes —
            # a partition whose first graph node is eltwise still aligns
            # at its first matmul/conv)
            per_tile = hierarchy.tile.subarrays
            next_free = math.ceil(next_free / per_tile) * per_tile
            open_sub, open_free_rows = -1, 0
        cur_part = part
        k, n = node.weight_shape
        row_blocks, col_blocks, replicas = grids[node.idx]
        blocks = row_blocks * col_blocks
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
                          n_subarrays=max(1, next_free),
                          partitions=list(partitions) if partitions else None)
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
