"""Modeled-vs-measured drift: join traced spans against schedule costs.
The port of ``repro.obs.drift``.

The mapper's :class:`~repro_torch.mapper.schedule.ScheduleReport`
*asserts* a per-stage cost model (lane-limited compute, double-buffered
transfers, priced KV traffic). This module closes the loop: run the
schedule with tracing enabled, join every per-node launch span against
the same node's modeled stage latency, and report the per-node **drift
ratio** ``measured_s / modeled_s``.

What the ratios mean here: the modeled times are those of the paper's
PIM hierarchy, and the measured ones those of the machine that ran the
program — an H100 or the CPU — so a ratio says how far that machine is
from the modeled one, node by node, and makes a node out of family
visible. No ratio is a target.

Which clock: every span is read on the host's clock (``time.perf_counter``
through ``repro_torch.obs.trace``). On a CUDA device a host span would time
only the enqueue of its kernels, so the program's launch spans and run
span synchronize the device before they close (``mapper.lowering``,
``mapper.compile``, ``mapper.executor``; the pipeline drivers' cell
spans likewise): they time the device work, and the sync itself. Each
span carries ``sync=True`` where it did; :attr:`DriftReport.clock` says
which of the two clocks a report read.

Join keys: launch spans recorded by ``repro_torch.mapper.lowering``
carry ``node=<graph node idx>``; modeled costs come from
``schedule.stages`` (one stage per node, ``t_stage_s`` the charged
latency). Under cross-node fusion a fused peer's time lands on its
group leader's span — its own measured time reads 0, flagged via
``NodeDrift.launches == 0``. Attached KV traffic contributes a modeled
floor with no per-launch measurement (the gather rides inside the decode
program), reported separately on the :class:`DriftReport`.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

from repro_torch.obs.trace import Tracer

EXEC_LANE = "execute"

# DriftReport.clock: what the measured spans timed
CLOCK_SYNCED = "host, synced to the device"
CLOCK_HOST = "host"


@dataclasses.dataclass(frozen=True)
class NodeDrift:
    """Modeled vs measured execution time of one placed graph node."""

    node: int
    name: str
    kind: str
    modeled_s: float              # schedule stage t_stage_s (charged)
    measured_s: float             # sum of this node's launch span durations
    launches: int                 # spans recorded (0 = fused into a peer)
    ratio: float                  # measured / modeled (inf if modeled == 0)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    tech: str
    nodes: tuple[NodeDrift, ...]
    modeled_total_s: float        # schedule.report.latency_s (KV included)
    measured_total_s: float       # outermost run span (fallback: node sum)
    ratio: float                  # measured_total / modeled_total
    kv_modeled_s: float = 0.0     # attached KVTraffic.t_s (0 if none)
    kv_dequant_error: dict | None = None  # serve.kv_dequant_rel_error
    #                               histogram snapshot (None if the engine
    #                               never recorded a dequant-error pass)
    clock: str = CLOCK_HOST       # what the measured spans timed

    @property
    def n_measured(self) -> int:
        return sum(1 for n in self.nodes if n.launches)

    def by_ratio(self) -> list[NodeDrift]:
        """Measured nodes, most-divergent first."""
        return sorted((n for n in self.nodes if n.launches),
                      key=lambda n: n.ratio, reverse=True)

    def summary(self, top: int = 5) -> str:
        lines = [
            f"[{self.tech}] drift: measured {self.measured_total_s:.3e} s "
            f"vs modeled {self.modeled_total_s:.3e} s "
            f"(x{self.ratio:.1f}); {self.n_measured}/{len(self.nodes)} "
            f"nodes measured ({self.clock} clock)"
            + (f", kv modeled {self.kv_modeled_s:.3e} s"
               if self.kv_modeled_s else "")]
        for n in self.by_ratio()[:top]:
            lines.append(
                f"  {n.name:<24} {n.kind:<8} modeled {n.modeled_s:.3e} s "
                f"measured {n.measured_s:.3e} s  x{n.ratio:.1f} "
                f"({n.launches} launch{'es' if n.launches != 1 else ''})")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "tech": self.tech,
            "clock": self.clock,
            "modeled_total_s": self.modeled_total_s,
            "measured_total_s": self.measured_total_s,
            "ratio": self.ratio,
            "kv_modeled_s": self.kv_modeled_s,
            "kv_dequant_error": self.kv_dequant_error,
            "nodes": [dataclasses.asdict(n) for n in self.nodes],
        }

    def export_json(self, path) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return str(path)


def _ratio(measured: float, modeled: float) -> float:
    if modeled > 0:
        return measured / modeled
    return math.inf if measured > 0 else 1.0


def _clock(spans) -> str:
    """The clock a set of spans read: synced to the device when every one
    of them waited for it."""
    return (CLOCK_SYNCED if spans and all(s.args.get("sync")
                                          for s in spans)
            else CLOCK_HOST)


def drift_report(schedule: Any, tracer: Tracer | None = None) -> DriftReport:
    """Join ``tracer``'s execute-lane spans against ``schedule``'s modeled
    stage costs (defaults to the globally enabled tracer).

    The tracer should hold exactly one run of the schedule (e.g. via
    :func:`measure_drift` or one ``ScheduleExecutor.run`` under
    ``repro_torch.obs.enable()``); with N runs recorded, measured times
    are N x the modeled single-run costs and every ratio inflates
    accordingly.
    """
    from repro_torch import obs
    if tracer is None:
        tracer = obs.tracer()
    spans = tracer.spans(lane=EXEC_LANE)
    if not spans:
        raise ValueError(
            "no execute-lane spans recorded — run the schedule with "
            "observability enabled (repro_torch.obs.enable()) or use "
            "measure_drift()")
    measured: dict[int, float] = {}
    launches: dict[int, int] = {}
    for s in spans:
        node = s.args.get("node")
        if node is None:
            continue
        measured[node] = measured.get(node, 0.0) + s.dur_s
        launches[node] = launches.get(node, 0) + 1

    nodes = []
    for stage in schedule.stages:
        m = measured.get(stage.node, 0.0)
        nodes.append(NodeDrift(
            node=stage.node, name=stage.name, kind=stage.kind,
            modeled_s=stage.t_stage_s, measured_s=m,
            launches=launches.get(stage.node, 0),
            ratio=_ratio(m, stage.t_stage_s)))

    # outermost whole-run span when present (the executor/program wraps
    # its run at depth 0); else the sum of the node launches
    runs = [s for s in spans if s.depth == 0 and s.args.get("node") is None]
    measured_total = (sum(s.dur_s for s in runs) if runs
                      else sum(measured.values()))
    modeled_total = schedule.report.latency_s
    # snapshot (never create) the serving engine's KV dequant-error
    # histogram so quantized-KV runs carry their numerics in the report
    kv_err = obs.metrics().snapshot()["histograms"].get(
        "serve.kv_dequant_rel_error")
    return DriftReport(
        tech=schedule.report.tech, nodes=tuple(nodes),
        modeled_total_s=modeled_total, measured_total_s=measured_total,
        ratio=_ratio(measured_total, modeled_total),
        kv_modeled_s=schedule.kv.t_s if schedule.kv is not None else 0.0,
        kv_dequant_error=kv_err, clock=_clock(runs or spans))


@dataclasses.dataclass(frozen=True)
class StageOccupancy:
    """Modeled vs measured busy time of one pipeline stage (partition)."""

    stage: int
    modeled_s: float              # PartitionCost.t_compute_s x cells run
    measured_s: float             # sum of this stage's pipeline span durs
    cells: int                    # (tick, microbatch) cells measured
    ratio: float                  # measured / modeled (inf if modeled == 0)


@dataclasses.dataclass(frozen=True)
class PipelineDrift:
    """Modeled :class:`~repro_torch.mapper.schedule.PipelineTimeline` vs
    the measured GPipe drivers' pipeline-lane spans."""

    microbatches: int
    stages: tuple[StageOccupancy, ...]
    modeled_interval_s: float     # steady-state initiation interval
    measured_interval_s: float    # measured bottleneck occupancy / M
    ratio: float
    transfers: int                # cut-point hand-off instants recorded
    clock: str = CLOCK_HOST       # what the measured spans timed

    def summary(self, top: int = 4) -> str:
        lines = [
            f"pipeline drift: measured interval "
            f"{self.measured_interval_s:.3e} s vs modeled "
            f"{self.modeled_interval_s:.3e} s (x{self.ratio:.1f}); "
            f"{len(self.stages)} stages, {self.transfers} transfers "
            f"({self.clock} clock)"]
        for s in sorted(self.stages, key=lambda s: s.ratio,
                        reverse=True)[:top]:
            lines.append(
                f"  stage {s.stage}: modeled {s.modeled_s:.3e} s "
                f"measured {s.measured_s:.3e} s  x{s.ratio:.1f} "
                f"({s.cells} cells)")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "microbatches": self.microbatches,
            "clock": self.clock,
            "modeled_interval_s": self.modeled_interval_s,
            "measured_interval_s": self.measured_interval_s,
            "ratio": self.ratio,
            "transfers": self.transfers,
            "stages": [dataclasses.asdict(s) for s in self.stages],
        }


def pipeline_drift(timeline: Any, tracer: Tracer | None = None,
                   ) -> PipelineDrift:
    """Join the GPipe drivers' measured pipeline spans against a modeled
    :class:`~repro_torch.mapper.schedule.PipelineTimeline`.

    The drivers in ``repro_torch.parallel.pipeline`` record one span per
    (tick, stage, microbatch) cell on the ``pipeline`` lane (sequential
    driver) or per-stage ``pipeline:stage{s}`` lanes (the drivers on a
    ring of streams), each tagged ``stage=``; cut-point hand-offs onto a
    stage's stream appear as ``transfer`` instants. Per stage, measured
    occupancy is the span-duration sum and the modeled equivalent is the
    partition's ``t_compute_s`` times the cells it actually ran
    (forward-only runs measure M cells; the value-and-grad driver
    measures forward and backward cells, so expect ratios near the
    fwd+bwd multiple). The interval comparison divides the bottleneck
    stage's occupancy by the microbatch count — the measured steady-state
    initiation interval against the modeled one.
    """
    if tracer is None:
        from repro_torch import obs
        tracer = obs.tracer()
    events = getattr(tracer, "events", [])   # NullTracer records nothing
    spans = [s for s in events               # .spans() drops instants
             if s.lane == "pipeline" or s.lane.startswith("pipeline:")]
    cells = [s for s in spans if s.kind == "span"
             and s.args.get("stage") is not None]
    if not cells:
        raise ValueError(
            "no pipeline-lane stage spans recorded — run a "
            "repro_torch.parallel.pipeline driver with observability "
            "enabled (repro_torch.obs.enable())")
    measured: dict[int, float] = {}
    counts: dict[int, int] = {}
    for s in cells:
        st = s.args["stage"]
        measured[st] = measured.get(st, 0.0) + s.dur_s
        counts[st] = counts.get(st, 0) + 1
    transfers = sum(1 for s in spans
                    if s.kind == "instant" and s.name == "transfer")

    m = timeline.microbatches
    stages = []
    for p in timeline.partitions:
        meas = measured.get(p.idx, 0.0)
        n = counts.get(p.idx, 0)
        modeled = p.t_compute_s * n
        stages.append(StageOccupancy(
            stage=p.idx, modeled_s=modeled, measured_s=meas, cells=n,
            ratio=_ratio(meas, modeled)))
    measured_interval = (max(measured.values()) / m) if m else 0.0
    return PipelineDrift(
        microbatches=m, stages=tuple(stages),
        modeled_interval_s=timeline.interval_s,
        measured_interval_s=measured_interval,
        ratio=_ratio(measured_interval, timeline.interval_s),
        transfers=transfers, clock=_clock(cells))


def measure_drift(schedule: Any, *args, device=None,
                  **kwargs) -> DriftReport:
    """Run ``schedule`` once through the per-block executor (one K2 launch
    per placed block, ``mapper.ScheduleExecutor``) on ``device`` (CUDA by
    default) under a scoped tracer and return the joined
    :class:`DriftReport`. The reference's ``group``/``fuse``/
    ``interpret``/``block`` switches select its executor's modes; the
    port's executor has the per-block mode alone, and a compiled program
    (``mapper.compile_schedule``) called under ``repro_torch.obs.scoped()``
    gives the grouped launches' report through :func:`drift_report`."""
    from repro_torch import obs
    from repro_torch.mapper.executor import ScheduleExecutor

    with obs.scoped() as tr:
        ScheduleExecutor(schedule, device=device).run(*args, **kwargs)
    return drift_report(schedule, tr)
