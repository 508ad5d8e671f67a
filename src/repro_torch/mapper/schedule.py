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

The arithmetic is the reference's, in the same order, so reports are its
numbers to the bit. Not ported yet: the microbatch pipeline timeline
(``Schedule.pipeline``, ``PartitionCost``, ``PipelineTimeline``) and paged
KV traffic (``attach_kv``, ``KVTraffic``); see ROADMAP.md, queue item 3.
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


@dataclasses.dataclass
class Schedule:
    graph: graph_mod.OpGraph
    placement: placement_mod.Placement
    hierarchy: PIMHierarchy
    stages: list[StageCost]
    report: ScheduleReport
    ideal_provision: str = "fp32"   # lane-provisioning basis of the ideal
    act_bits: int = 32              # activation transfer width (ACT_BITS
                                    # resolved per schedule via act_dtype)

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


def _not_ported(partitions, expand_scans: bool) -> None:
    if partitions:
        raise NotImplementedError(
            "pipeline partitions are not ported yet (ROADMAP.md, queue "
            "item 3.3)")
    if expand_scans:
        raise NotImplementedError(
            "scan expansion is not ported yet (ROADMAP.md, queue item "
            "3.3, with the pipeline partitions it lets cut the stack)")


def build_schedule_from_graph(
        graph: graph_mod.OpGraph,
        hierarchy: PIMHierarchy | None = None,
        policy: placement_mod.PlacementPolicy | None = None,
        tech: str = "proposed",
        ideal_provision: str = "fp32",
        act_dtype: str = "fp32") -> Schedule:
    hierarchy = hierarchy or default_hierarchy(tech)
    act_bits = quant.spec(act_dtype).n_bits
    place = placement_mod.place(graph, hierarchy, policy)
    sub = hierarchy.subarray
    counts = graph.totals()
    ideal = _ideal_report(counts, hierarchy.tech,
                          _provision_bits(graph, hierarchy, ideal_provision),
                          sub)
    chip_lanes = _chip_lanes(ideal)
    t_elem = max(sub.t_add_s, sub.t_mul_s)

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
            e_compute_j=e_compute, e_transfer_j=e_xfer, hops=hops))

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

    Not ported yet, and raising ``NotImplementedError``: ``partitions``
    and ``expand_scans=True``."""
    _not_ported(partitions, expand_scans)
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
                                          ideal_provision=ideal_provision,
                                          act_dtype=act_dtype)
    m = obs.metrics()
    m.counter("mapper.schedules_built").inc()
    m.gauge("mapper.last_modeled_latency_s").set(sched.report.latency_s)
    m.gauge("pim.weight_bits").set(float(hierarchy.subarray.n_bits))
    m.gauge("pim.act_bits").set(float(sched.act_bits))
    return sched
