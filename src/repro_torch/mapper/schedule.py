"""Static schedules over a placed operator graph: the port of
``repro.mapper.schedule``.

One stage per graph node, emitted in topological order. Stage latency is
``ceil(work / lanes) * unit_time`` with the node's placed MAC lanes, capped
at the chip's total lane provisioning ``P`` (the same
one-subarray-group-per-2^20-weight-bits rule ``pim_estimate`` uses). That
cap is what makes the schedule *reconcile* with the aggregate estimator:

    sum_i ceil(w_i / L_i) >= sum_i w_i / P  =>  schedule >= ideal,

so the estimator's number is provably the zero-stall limit of any schedule
we emit, and the difference is attributable structure: per-stage ceil
rounding, lanes idled by placement, and activation transfers.

Activations are double-buffered: a stage's input transfer (priced by
``PIMHierarchy.transfer_cost`` over the tile/NoC/off-chip path between the
producer's and consumer's home subarrays) overlaps the previous activation
set's compute, so stage latency is ``max(compute, transfer)`` and the
uncovered remainder is reported as stall time. Eltwise stages run in the
shared peripheral FP units at the estimator's ``max(T_add, T_mul)`` cycle.

A schedule built with ``weight_dtype`` other than fp32 runs on a
subarray whose MACs take the grid's shorter bit-serial schedule and whose
placement spends the freed area on replicas; ``act_dtype`` prices every
inter-subarray transfer at the grid's width (``Schedule.act_bits``).
``ideal_provision`` picks the weight footprint the ideal bound
provisions lanes from (``_provision_bits``).

``ScheduleReport.latency_s`` remains the end-to-end time of ONE activation
set — the quantity ``reconcile()`` bounds against ``pim_estimate``. The
steady-state story the architecture exists for (weights resident,
activations streaming) lives in :meth:`Schedule.pipeline`: a microbatch
timeline over K pipeline partitions with explicit fill/drain, a
steady-state interval bounded below by both the slowest partition and the
busiest shared link (per-link contention over the bus/NoC/SerDes edges
each boundary transfer crosses), and the pipelined-vs-sequential speedup.
``build_schedule(..., partitions=K, expand_scans=True)`` cuts the graph
(``placement.partition``), first expanding its folded layer stacks where
the subarray budget allows (``graph.expand_graph``).

A paged serving step prices its KV pool's traffic with
:meth:`Schedule.attach_kv` (``KVTraffic``): every attention site gathers
its slots' resident blocks from where ``placement.place_kv`` put them
and writes one token back, folded into the report and into the
pipeline's link contention.

The arithmetic is the reference's, in the same order, so reports and
timelines are its numbers to the bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch import obs
from repro_torch.core import accelerator as acc_mod
from repro_torch.core import estimator
from repro_torch.core import quant
from repro_torch.mapper import graph as graph_mod
from repro_torch.mapper import placement as placement_mod
from repro_torch.mapper.hardware import PIMHierarchy, default_hierarchy


@dataclasses.dataclass(frozen=True)
class StageCost:
    node: int
    name: str
    kind: str
    macs: int
    adds: int
    muls: int
    lanes: int
    t_compute_s: float
    t_transfer_s: float
    t_stage_s: float          # max(compute, transfer) — double buffered
    e_compute_j: float
    e_transfer_j: float
    hops: int                 # NoC mesh hops on this stage's input paths
    partition: int = 0        # pipeline partition this stage belongs to


@dataclasses.dataclass(frozen=True)
class ScheduleReport:
    """Cost-rolled summary of one static schedule."""

    tech: str
    macs: int
    adds: int
    muls: int
    energy_j: float
    latency_s: float              # end-to-end, one activation set
    ideal_latency_s: float        # pim_estimate on the same counts/lanes
    pipeline_interval_s: float    # max stage latency (steady-state rate)
    stall_s: float                # transfer time not hidden by compute
    transfer_energy_j: float
    total_hops: int               # sum of NoC hops over all stage inputs
    n_stages: int
    n_subarrays: int
    n_tiles: int
    n_chips: int
    area_m2: float
    parallel_lanes: int

    def summary(self) -> str:
        return (f"[{self.tech}] {self.n_stages} stages on "
                f"{self.n_subarrays} subarrays / {self.n_tiles} tiles / "
                f"{self.n_chips} chip(s): MACs={self.macs:.3e} "
                f"T={self.latency_s:.3e} s (ideal {self.ideal_latency_s:.3e}, "
                f"stall {self.stall_s:.3e}) interval="
                f"{self.pipeline_interval_s:.3e} s E={self.energy_j:.3e} J "
                f"hops={self.total_hops} "
                f"area={self.area_m2 * 1e6:.2f} mm^2")


@dataclasses.dataclass(frozen=True)
class PartitionCost:
    """Rolled-up cost of one pipeline partition (contiguous stage run)."""

    idx: int
    n_stages: int
    macs: int
    adds: int
    muls: int
    t_compute_s: float            # sum of member stage latencies
    t_boundary_s: float           # handoff to the next partition
                                  # (diagnostic: already overlapped inside
                                  # the consumer stages' t_stage_s)
    out_bits: int

    @property
    def work(self) -> int:
        return self.macs + self.adds + self.muls


@dataclasses.dataclass(frozen=True)
class PipelineTimeline:
    """Microbatch fill/steady/drain timeline over pipeline partitions.

    ``interval_s`` is the steady-state initiation interval: a new
    microbatch completes every interval once the pipe is full, bounded
    below by the slowest partition's occupancy AND by the busiest shared
    link's per-microbatch busy time (several boundary streams crossing the
    same bus/NoC edge/SerDes link serialize there). ``makespan_s`` is the
    full M-microbatch time including fill and drain; ``sequential_s`` is
    the same M activation sets run unpipelined back to back.
    """

    microbatches: int
    partitions: tuple[PartitionCost, ...]
    interval_s: float
    fill_s: float                 # first microbatch end-to-end
    makespan_s: float
    sequential_s: float
    link_busy_s: float            # busiest shared link, per microbatch
    bottleneck: str               # "partition:<idx>" or "link:<repr>"

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    @property
    def speedup(self) -> float:
        return (self.sequential_s / self.makespan_s
                if self.makespan_s else 1.0)

    @property
    def steady_sets_per_s(self) -> float:
        """Activation sets (microbatches) retired per second, steady state."""
        return 1.0 / self.interval_s if self.interval_s else math.inf

    def summary(self) -> str:
        return (f"{self.n_partitions} partitions x "
                f"{self.microbatches} microbatches: interval="
                f"{self.interval_s:.3e} s (bottleneck {self.bottleneck}) "
                f"fill={self.fill_s:.3e} s makespan={self.makespan_s:.3e} s "
                f"speedup={self.speedup:.2f}x vs sequential")


@dataclasses.dataclass(frozen=True)
class KVTraffic:
    """Per-decode-step cost of streaming paged KV blocks (``attach_kv``).

    ``t_s``/``e_j`` are the serialized block-gather + token-writeback
    time/energy folded into the schedule's report; ``link_busy`` holds
    the per-shared-link occupancy joined into the pipeline contention
    model (a KV stream and a boundary activation stream crossing the
    same NoC edge serialize there)."""

    resident_tokens: int
    batch: int
    read_bits: int                # all sites, one decode step
    write_bits: int
    t_s: float
    e_j: float
    hops: int
    link_busy: dict = dataclasses.field(repr=False, hash=False,
                                        compare=False, default_factory=dict)


@dataclasses.dataclass
class Schedule:
    graph: graph_mod.OpGraph
    placement: placement_mod.Placement
    hierarchy: PIMHierarchy
    stages: list[StageCost]
    report: ScheduleReport
    kv_placement: "placement_mod.KVPlacement | None" = None
    kv: KVTraffic | None = None
    ideal_provision: str = "fp32"   # lane-provisioning basis of the ideal
    act_bits: int = 32              # activation transfer width (ACT_BITS
                                    # resolved per schedule via act_dtype)

    @property
    def partitions(self) -> list[placement_mod.GraphPartition] | None:
        return self.placement.partitions

    def reconcile(self) -> dict:
        """Check the ScheduleReport against ``pim_estimate`` on the same fn:
        op totals must match exactly; latency must dominate the ideal.

        Counts are re-derived from the traced aten graph by the
        estimator's own counter — independent of the graph lowering — so a
        node dropped or double-counted by ``build_graph_from_capture``
        fails this check."""
        counts = estimator.count_ops_graph(self.graph.gm)
        ideal = _ideal_report(counts, self.hierarchy.tech,
                              _provision_bits(self.graph, self.hierarchy,
                                              self.ideal_provision),
                              self.hierarchy.subarray)
        rep = self.report
        return {
            "counts_match": (rep.macs == ideal.macs == counts.macs
                             and rep.adds == ideal.adds == counts.adds
                             and rep.muls == ideal.muls == counts.muls),
            "latency_ge_ideal": rep.latency_s >= ideal.latency_s,
            "schedule_latency_s": rep.latency_s,
            "ideal_latency_s": ideal.latency_s,
            "structural_overhead": (rep.latency_s / ideal.latency_s
                                    if ideal.latency_s else math.inf),
        }

    def attach_kv(self, kvp: placement_mod.KVPlacement, *,
                  resident_tokens: int, batch: int = 1) -> KVTraffic:
        """Price paged-KV traffic into this schedule: per decode step,
        every attention site gathers its slots' resident blocks
        (``ceil(resident_tokens / block_size)`` blocks x ``batch``
        streams) from the placed KV pages into its consumer's tile and
        writes one token per slot back into the tail block.

        The transfer time/energy/hops fold into ``report`` (latency only
        grows, so ``reconcile()``'s ``latency >= ideal`` invariant is
        preserved and op counts are untouched), and the per-link busy
        times join :meth:`pipeline`'s contention model. Raises
        ``ValueError`` when traffic is already attached."""
        if resident_tokens < 1 or batch < 1:
            raise ValueError("resident_tokens and batch must be >= 1")
        if self.kv is not None:
            raise ValueError(
                "KV traffic is already attached to this schedule (the "
                "report would double-price it); build a fresh schedule "
                "to re-price a different KV spec")
        spec = kvp.spec
        nb = min(spec.num_blocks,
                 math.ceil(resident_tokens / spec.block_size))
        t = e = 0.0
        hops = 0
        read_bits = write_bits = 0
        link_busy: dict[tuple, float] = {}

        def charge(bits: int, src: int, dst: int) -> None:
            nonlocal t, e, hops
            dt_, de = self.hierarchy.transfer_cost(bits, src, dst)
            t += dt_
            e += de
            hops += self.hierarchy.hop_count(src, dst) if bits else 0
            for link in self.hierarchy.route_links(src, dst):
                link_busy[link] = (link_busy.get(link, 0.0)
                                   + self.hierarchy.link_time(link, bits))

        for site in range(spec.sites):
            dst = kvp.consumer_home(site)
            for b in range(nb):
                bits = batch * spec.block_bits
                charge(bits, kvp.block_home(site, b), dst)
                read_bits += bits
            wbits = batch * spec.token_bits
            charge(wbits, dst, kvp.block_home(site, nb - 1))
            write_bits += wbits

        self.kv_placement = kvp
        self.kv = KVTraffic(resident_tokens=resident_tokens, batch=batch,
                            read_bits=read_bits, write_bits=write_bits,
                            t_s=t, e_j=e, hops=hops, link_busy=link_busy)
        self.report = dataclasses.replace(
            self.report,
            latency_s=self.report.latency_s + t,
            energy_j=self.report.energy_j + e,
            transfer_energy_j=self.report.transfer_energy_j + e,
            total_hops=self.report.total_hops + hops)
        return self.kv

    def pipeline(self, microbatches: int = 8,
                 partitions: int | None = None) -> PipelineTimeline:
        """Microbatch pipeline timeline over this schedule's partitions.

        Uses the partitions the schedule was built with; pass
        ``partitions=K`` to (re)cut on the fly. With one partition the
        timeline degenerates to sequential execution (speedup 1.0)."""
        parts = self.partitions
        if partitions is not None:
            parts = placement_mod.partition(self.graph, partitions)
        if not parts:
            parts = placement_mod.partition(self.graph, 1)
        if microbatches < 1:
            raise ValueError(f"need >= 1 microbatches, got {microbatches}")
        node_part = {n: p.idx for p in parts for n in p.nodes}
        # roll stages up per partition (stages of unassigned nodes — when
        # the schedule was cut differently — fall into partition 0)
        agg = {p.idx: dict(n=0, macs=0, adds=0, muls=0, t=0.0)
               for p in parts}
        for s in self.stages:
            a = agg[node_part.get(s.node, 0)]
            a["n"] += 1
            a["macs"] += s.macs
            a["adds"] += s.adds
            a["muls"] += s.muls
            a["t"] += s.t_stage_s

        homes = placement_mod.node_homes(self.graph, self.placement)
        link_busy: dict[tuple, float] = {}

        # per-microbatch link occupancy: every stage's input transfers.
        # These ARE the activation streams (boundary-crossing edges
        # included), and each consumer stage's t_stage_s already absorbs
        # its own transfer double-buffered — so the explicit boundary
        # stream below is diagnostic only, never charged a second time.
        for s in self.stages:
            node = self.graph.nodes[s.node]
            for d in node.deps:
                dep = self.graph.nodes[d]
                bits = dep.out_elems * dep.repeat * self.act_bits
                if bits:
                    for link in self.hierarchy.route_links(homes[d],
                                                           homes[s.node]):
                        link_busy[link] = (
                            link_busy.get(link, 0.0)
                            + self.hierarchy.link_time(link, bits))
        # attached paged-KV streams contend on the same shared links
        # (one decode step == one microbatch through the decode pipeline)
        if self.kv is not None:
            for link, t_kv in self.kv.link_busy.items():
                link_busy[link] = link_busy.get(link, 0.0) + t_kv
        pcosts: list[PartitionCost] = []
        for i, p in enumerate(parts):
            t_boundary = 0.0
            if i < len(parts) - 1 and p.out_bits:
                nxt = parts[i + 1]
                src = homes[p.nodes[-1]] if p.nodes else 0
                dst = homes[nxt.nodes[0]] if nxt.nodes else 0
                t_boundary, _ = self.hierarchy.transfer_cost(
                    p.out_bits, src, dst)
            a = agg[p.idx]
            pcosts.append(PartitionCost(
                idx=p.idx, n_stages=a["n"], macs=a["macs"], adds=a["adds"],
                muls=a["muls"], t_compute_s=a["t"],
                t_boundary_s=t_boundary, out_bits=p.out_bits))

        busiest_link = max(link_busy.items(), key=lambda kv: kv[1],
                           default=(None, 0.0))
        slowest = max(pcosts, key=lambda p: p.t_compute_s)
        interval = max(slowest.t_compute_s, busiest_link[1])
        bottleneck = (f"partition:{slowest.idx}"
                      if slowest.t_compute_s >= busiest_link[1]
                      else f"link:{busiest_link[0]}")
        # first microbatch end-to-end == the one-activation-set latency
        # (partition handoffs are the stages' own double-buffered input
        # transfers, already inside t_stage_s)
        fill = self.report.latency_s
        makespan = fill + (microbatches - 1) * interval
        sequential = microbatches * self.report.latency_s
        return PipelineTimeline(
            microbatches=microbatches, partitions=tuple(pcosts),
            interval_s=interval, fill_s=fill, makespan_s=makespan,
            sequential_s=sequential, link_busy_s=busiest_link[1],
            bottleneck=bottleneck)


# Default activation stream width between subarrays. A schedule built
# with ``act_dtype`` other than fp32 resolves its own ``Schedule.act_bits``
# from the quant grid and prices every inter-subarray transfer at that
# width; this constant stays the fp32 default and the fp32-equivalent
# *area* basis used by ``_provision_bits``.
ACT_BITS = 32


def _provision_bits(graph: graph_mod.OpGraph, hierarchy: PIMHierarchy,
                    ideal_provision: str) -> int:
    """Weight-bit footprint the ideal report provisions lanes from.

    ``"fp32"`` (default): the fp32-equivalent footprint
    (``graph.weight_bits(32)``) — lane provisioning models *area*, and
    the quantized datapath's claim is more throughput at equal area, not
    a shrunken chip. ``"quantized"``: the stored-dtype footprint
    (``graph.weight_bits(subarray.n_bits)``) — fewer subarrays for the
    same weights, so the ideal bound tightens toward the denser
    placement."""
    if ideal_provision not in ("fp32", "quantized"):
        raise ValueError(f"ideal_provision must be 'fp32' or 'quantized', "
                         f"got {ideal_provision!r}")
    bits = (hierarchy.subarray.n_bits if ideal_provision == "quantized"
            else ACT_BITS)
    return graph.weight_bits(bits)


def _ideal_report(counts, tech: str, weight_bits: int, subarray=None):
    """pim_estimate with its own default lane provisioning (one 1024-lane
    subarray group per 2^20 weight bits) — the single source of that rule.
    ``weight_bits`` is the provisioning footprint chosen by
    ``_provision_bits``; ``subarray`` (when given) supplies the
    reduced-width per-MAC cost."""
    mac_kw = {}
    if subarray is not None:
        mac_kw = dict(t_mac_s=subarray.t_mac_s, e_mac_j=subarray.e_mac_j)
    return estimator.pim_estimate(counts, tech=tech,
                                  weight_bits=max(1, weight_bits), **mac_kw)


def _chip_lanes(ideal) -> int:
    """The lane count the ideal report was priced with; stage lanes are
    capped here so schedule latency provably dominates the ideal."""
    return ideal.n_subarrays * acc_mod.SUBARRAY_COLS


# Default subarray budget for scan expansion, in chips: expanding a
# folded stack into resident per-layer copies may only grow the weight
# footprint up to this many chips' worth of subarrays before the planner
# buckets (ceil(R/g) copies) or refuses (see
# ``graph.plan_scan_expansion``). Override per call via ``expand_budget``.
EXPAND_BUDGET_CHIPS = 64


def build_schedule_from_graph(
        graph: graph_mod.OpGraph,
        hierarchy: PIMHierarchy | None = None,
        policy: placement_mod.PlacementPolicy | None = None,
        tech: str = "proposed",
        partitions: int | None = None,
        expand_scans: bool = False,
        expand_budget: int | None = None,
        ideal_provision: str = "fp32",
        act_dtype: str = "fp32") -> Schedule:
    hierarchy = hierarchy or default_hierarchy(tech)
    act_bits = quant.spec(act_dtype).n_bits
    if expand_scans:
        sub_ = hierarchy.subarray
        budget = (expand_budget if expand_budget is not None
                  else EXPAND_BUDGET_CHIPS * hierarchy.subarrays_per_chip)
        graph = graph_mod.expand_graph(graph, weight_rows=sub_.weight_rows,
                                       weight_cols=sub_.weight_cols,
                                       budget=budget)
    parts = (placement_mod.partition(graph, partitions)
             if partitions else None)
    place = placement_mod.place(graph, hierarchy, policy, partitions=parts)
    sub = hierarchy.subarray
    counts = graph.totals()
    ideal = _ideal_report(counts, hierarchy.tech,
                          _provision_bits(graph, hierarchy, ideal_provision),
                          sub)
    chip_lanes = _chip_lanes(ideal)
    t_elem = max(sub.t_add_s, sub.t_mul_s)

    node_part = ({n: p.idx for p in parts for n in p.nodes}
                 if parts else {})
    homes = placement_mod.node_homes(graph, place)
    stages: list[StageCost] = []
    for node in graph.nodes:
        home = homes[node.idx]
        if node.kind == "eltwise":
            lanes = min(chip_lanes, sub.mac_lanes)
            work = node.adds + node.muls
            t_compute = math.ceil(work / lanes) * t_elem
            e_compute = node.adds * sub.e_add_j + node.muls * sub.e_mul_j
        else:
            np_ = place.node_placements[node.idx]
            lanes = min(chip_lanes, np_.lanes(hierarchy))
            t_compute = math.ceil(node.macs / lanes) * sub.t_mac_s
            e_compute = node.macs * sub.e_mac_j

        t_xfer, e_xfer, hops = 0.0, 0.0, 0
        for d in node.deps:
            dep = graph.nodes[d]
            bits = dep.out_elems * dep.repeat * act_bits
            t, e = hierarchy.transfer_cost(bits, homes[d], home)
            t_xfer += t
            e_xfer += e
            hops += hierarchy.hop_count(homes[d], home) if bits else 0
        stages.append(StageCost(
            node=node.idx, name=node.name, kind=node.kind,
            macs=node.macs, adds=node.adds, muls=node.muls, lanes=lanes,
            t_compute_s=t_compute, t_transfer_s=t_xfer,
            t_stage_s=max(t_compute, t_xfer),
            e_compute_j=e_compute, e_transfer_j=e_xfer, hops=hops,
            partition=node_part.get(node.idx, 0)))

    latency = sum(s.t_stage_s for s in stages)
    stall = sum(max(0.0, s.t_transfer_s - s.t_compute_s) for s in stages)
    e_xfer_total = sum(s.e_transfer_j for s in stages)
    report = ScheduleReport(
        tech=hierarchy.tech,
        macs=counts.macs, adds=counts.adds, muls=counts.muls,
        energy_j=sum(s.e_compute_j for s in stages) + e_xfer_total,
        latency_s=latency,
        ideal_latency_s=ideal.latency_s,
        pipeline_interval_s=max((s.t_stage_s for s in stages), default=0.0),
        stall_s=stall,
        transfer_energy_j=e_xfer_total,
        total_hops=sum(s.hops for s in stages),
        n_stages=len(stages),
        n_subarrays=place.n_subarrays,
        n_tiles=place.n_tiles,
        n_chips=place.n_chips,
        area_m2=place.area_m2,
        parallel_lanes=chip_lanes,
    )
    return Schedule(graph=graph, placement=place, hierarchy=hierarchy,
                    stages=stages, report=report,
                    ideal_provision=ideal_provision, act_bits=act_bits)


def build_schedule(fn: Callable, *args,
                   hierarchy: PIMHierarchy | None = None,
                   policy: placement_mod.PlacementPolicy | None = None,
                   tech: str = "proposed",
                   weight_dtype: str = "fp32",
                   act_dtype: str = "fp32",
                   partitions: int | None = None,
                   expand_scans: bool = False,
                   expand_budget: int | None = None,
                   ideal_provision: str = "fp32", **kwargs) -> Schedule:
    """Compile ``fn(*args, **kwargs)`` into a placed, cost-rolled static
    schedule (args may be meta tensors; nothing is allocated).

    ``weight_dtype`` selects the stored-weight precision (``"fp32"`` /
    ``"fp16"`` / ``"int8"`` / ``"fp8_e4m3"`` / ``"fp8_e5m2"``): weights
    occupy fewer cells per row, MACs run a shorter bit-serial schedule,
    and the placer spends the freed area on extra replicas of the
    hottest nodes (lane provisioning stays at the fp32-equivalent area).
    ``act_dtype`` prices inter-subarray *activation* transfers at the
    grid's width (``Schedule.act_bits``; numerics untouched).
    ``ideal_provision`` picks the footprint the *ideal* bound provisions
    lanes from: ``"fp32"`` (default) or ``"quantized"`` (the stored
    dtype's denser footprint); ``latency >= ideal`` holds at either.
    ``partitions=K`` additionally cuts the graph into K pipeline
    partitions, aligns their placements to tile boundaries, and enables
    :meth:`Schedule.pipeline` / ``compile_partitioned``.
    ``expand_scans=True`` first expands folded layer stacks into resident
    per-layer copies where subarray capacity allows (budget
    ``expand_budget`` subarrays, default ``EXPAND_BUDGET_CHIPS`` chips'
    worth), so partition cuts can land *inside* the stacks."""
    if hierarchy is None:
        hierarchy = default_hierarchy(tech, weight_dtype)
    elif (weight_dtype != "fp32"
          and hierarchy.subarray.weight_dtype != weight_dtype):
        raise ValueError(
            f"weight_dtype={weight_dtype!r} conflicts with the supplied "
            f"hierarchy's subarray ({hierarchy.subarray.weight_dtype!r}); "
            f"build the hierarchy with default_hierarchy(tech, "
            f"weight_dtype) instead")
    with obs.span("build:schedule", lane="compile"):
        g = graph_mod.build_graph(fn, *args, **kwargs)
        sched = build_schedule_from_graph(g, hierarchy=hierarchy,
                                          policy=policy, tech=tech,
                                          partitions=partitions,
                                          expand_scans=expand_scans,
                                          expand_budget=expand_budget,
                                          ideal_provision=ideal_provision,
                                          act_dtype=act_dtype)
    m = obs.metrics()
    m.counter("mapper.schedules_built").inc()
    m.gauge("mapper.last_modeled_latency_s").set(sched.report.latency_s)
    m.gauge("pim.weight_bits").set(float(hierarchy.subarray.n_bits))
    m.gauge("pim.act_bits").set(float(sched.act_bits))
    return sched
