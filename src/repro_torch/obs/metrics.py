"""Process-local metrics registry: counters, gauges, histograms.

One :class:`MetricsRegistry` per process (``repro_torch.obs.metrics()``)
absorbs the stack's ad-hoc counters into named instruments:

  * :class:`Counter` — monotonically increasing (kernel launches,
    admitted requests, straggler events, cache hits);
  * :class:`Gauge` — last-written value (KV pool occupancy, router queue
    depths, first-step compile time);
  * :class:`Histogram` — fixed log-spaced bucket edges plus a bounded
    raw-value reservoir for exact percentiles (per-request TTFT/TPOT,
    per-step wall time).

Instruments are created on first use and live for the process. Recording
is plain Python dict/list work — cheap enough to stay always-on at
program boundaries (per step / per tick / per request), which is the
granularity the stack instruments; per-launch costs are only ever traced,
and tracing is opt-in (``repro_torch.obs.enable``).

``snapshot()`` returns a JSON-ready dict (the metrics dump CI uploads);
``reset()`` zeroes everything, which benchmarks use to scope
measurements per variant.
"""

from __future__ import annotations

import dataclasses
import json
import math


def _log_edges(lo: float = 1e-6, hi: float = 100.0) -> tuple[float, ...]:
    """1-2-5 log-spaced bucket edges covering [lo, hi] (seconds)."""
    edges: list[float] = []
    decade = lo
    while decade <= hi * 1.0001:
        for m in (1.0, 2.0, 5.0):
            e = decade * m
            if lo * 0.9999 <= e <= hi * 1.0001:
                edges.append(e)
        decade *= 10.0
    return tuple(edges)


DEFAULT_EDGES = _log_edges()      # 1 us .. 100 s, 1-2-5 per decade
TICK_EDGES = _log_edges(1.0, 1e6)  # virtual-clock (decode-tick) domain
RESERVOIR_MAX = 65536             # raw values kept for exact percentiles


@dataclasses.dataclass
class Counter:
    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n


@dataclasses.dataclass
class Gauge:
    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with a bounded raw-value reservoir.

    ``edges`` are the upper bounds of the finite buckets (ascending); one
    implicit +inf bucket catches the overflow. Percentiles come from the
    raw reservoir while it holds every observation (exact), falling back
    to linear interpolation over the buckets once it saturates.
    """

    def __init__(self, name: str, edges: tuple[float, ...] = DEFAULT_EDGES):
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"histogram {name}: edges must be ascending "
                             f"and non-empty, got {edges}")
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        self.bucket_counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._values: list[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        lo, hi = 0, len(self.edges)
        while lo < hi:                      # first edge >= v
            mid = (lo + hi) // 2
            if self.edges[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.bucket_counts[lo] += 1
        if len(self._values) < RESERVOIR_MAX:
            self._values.append(v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """q in [0, 100]. Exact while the reservoir holds everything."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        if not self.count:
            return math.nan
        if len(self._values) == self.count:
            vals = sorted(self._values)
            # linear interpolation between closest ranks (numpy default)
            pos = (len(vals) - 1) * q / 100.0
            i, frac = int(pos), pos - int(pos)
            if i + 1 < len(vals):
                return vals[i] * (1 - frac) + vals[i + 1] * frac
            return vals[i]
        # bucket interpolation: assume uniform density inside a bucket
        target = self.count * q / 100.0
        seen = 0
        prev_edge = self.min
        for i, c in enumerate(self.bucket_counts):
            edge = (self.edges[i] if i < len(self.edges) else self.max)
            if seen + c >= target and c:
                frac = (target - seen) / c
                return prev_edge + frac * (edge - prev_edge)
            seen += c
            if c:
                prev_edge = edge
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count, "sum": self.sum, "mean": self.mean,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": self.percentile(50) if self.count else None,
            "p95": self.percentile(95) if self.count else None,
            "p99": self.percentile(99) if self.count else None,
            "buckets": {("+inf" if i == len(self.edges)
                         else repr(self.edges[i])): c
                        for i, c in enumerate(self.bucket_counts) if c},
        }


class MetricsRegistry:
    """Named instruments, created on first use, type-checked on reuse."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  edges: tuple[float, ...] = DEFAULT_EDGES) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, edges)
        elif h.edges != tuple(float(e) for e in edges):
            raise ValueError(f"histogram {name} already registered with "
                             f"different edges")
        return h

    def names(self) -> list[str]:
        return sorted([*self._counters, *self._gauges, *self._histograms])

    def snapshot(self) -> dict:
        """JSON-ready dump of every instrument."""
        return {
            "counters": {n: c.value
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(self._histograms.items())},
        }

    def export_json(self, path) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        return str(path)

    def reset(self) -> None:
        """Drop every instrument (benchmarks scope variants with this)."""
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()
