"""Observability for the PyTorch port: span tracing and a metrics registry.

A copy of the reference's ``repro.obs`` tracing and metrics layers (pure
Python, no framework import), so the port's serve engine and KV allocator
record the same spans, counters, gauges and histograms under the same
names, and its drift layer (``repro_torch.obs.drift``): the measured
launch and pipeline spans joined against the schedule's modeled costs.

Tracing is **opt-in** (:func:`enable`); the metrics registry is always on
and touched only at program boundaries (per tick / request).

Usage::

    from repro_torch import obs

    tr = obs.enable()                 # fresh Tracer installed globally
    engine.run()                      # spans recorded
    tr.export_chrome("serve.trace.json")
    obs.metrics().snapshot()          # counters/gauges/histograms
    engine.drift_report(tr)           # modeled-vs-measured per node
    obs.disable()
"""

from __future__ import annotations

import contextlib

from repro_torch.obs.drift import (DriftReport, NodeDrift, PipelineDrift,
                                   StageOccupancy, drift_report,
                                   measure_drift, pipeline_drift)
from repro_torch.obs.metrics import (DEFAULT_EDGES, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, SpanEvent,
                                   Tracer, validate_chrome_trace)

_TRACER: Tracer | NullTracer = NULL_TRACER
_METRICS = MetricsRegistry()


def tracer() -> Tracer | NullTracer:
    """The installed tracer (the shared no-op when disabled)."""
    return _TRACER


def metrics() -> MetricsRegistry:
    """The process-local metrics registry (always available)."""
    return _METRICS


def is_enabled() -> bool:
    return _TRACER.enabled


def enable(tracer: Tracer | None = None) -> Tracer:
    """Install (and return) a tracer globally — a fresh one by default."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def disable() -> None:
    """Swap the no-op tracer back in."""
    global _TRACER
    _TRACER = NULL_TRACER


@contextlib.contextmanager
def scoped(tracer: Tracer | None = None):
    """Enable a (fresh) tracer for the block, restoring the previous
    tracer — enabled or not — on exit. Yields the scoped tracer."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    try:
        yield _TRACER
    finally:
        _TRACER = prev


def span(name: str, lane: str = "main", **args):
    """A span on the installed tracer (no-op context when disabled)."""
    return _TRACER.span(name, lane=lane, **args)


def instant(name: str, lane: str = "main", **args) -> None:
    _TRACER.instant(name, lane=lane, **args)


__all__ = [
    "Counter", "DEFAULT_EDGES", "DriftReport", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_TRACER", "NodeDrift", "NullTracer",
    "PipelineDrift", "SpanEvent", "StageOccupancy", "Tracer", "disable",
    "drift_report", "enable", "instant", "is_enabled", "measure_drift",
    "metrics", "pipeline_drift", "scoped", "span", "tracer",
    "validate_chrome_trace",
]
