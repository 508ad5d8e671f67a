"""Structured tracing: span events + Chrome-trace/Perfetto JSON export.

A :class:`Tracer` records *spans* (named, timed intervals with arbitrary
key/value args) and *instants* (zero-duration markers) into per-``lane``
timelines. Lanes map onto Chrome-trace thread tracks, so one training
step or serve run exported with :meth:`Tracer.export_chrome` opens
directly in ``chrome://tracing`` / https://ui.perfetto.dev as a nested
timeline — compile/trace on one lane, per-node kernel launches on
another, serve admit/prefill/decode ticks on a third.

Spans nest: entering a span while another is open on the same lane
records a child interval strictly inside the parent (enforced by the
``with`` discipline and checked again by :func:`validate_chrome_trace`,
which the observability tests run on every exported file).

The :class:`NullTracer` is the disabled mode: ``enabled`` is False and
``span()`` hands back one shared no-op context manager, so instrumented
call sites cost an attribute check when observability is off. Call sites
on hot paths additionally guard with ``if tracer.enabled`` so even the
span-argument dicts are never built.

Durations are wall-clock (``time.perf_counter``). CUDA launches return
before the device finishes, so a span that should time device work must
end with ``torch.cuda.synchronize()`` *inside* it — otherwise it measures
the enqueue, not the execution. The serve engine's decode-tick span reads
the sampled token ids back to the host inside the span, which waits for
the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Callable, Iterable


@dataclasses.dataclass
class SpanEvent:
    """One recorded interval (``dur_s > 0``) or instant (``dur_s == 0``,
    ``kind == "instant"``). ``t0_s`` is relative to the tracer's epoch."""

    name: str
    lane: str
    t0_s: float
    dur_s: float
    depth: int                    # nesting depth within the lane at entry
    args: dict = dataclasses.field(default_factory=dict)
    kind: str = "span"            # "span" | "instant"

    @property
    def t1_s(self) -> float:
        return self.t0_s + self.dur_s


class Tracer:
    """Collects span/instant events; export with :meth:`export_chrome`.

    Not thread-safe by design — the PIM stack is single-threaded at the
    Python dispatch level (async checkpointing is not instrumented).
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self.events: list[SpanEvent] = []
        self._depth: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.events)

    @contextlib.contextmanager
    def span(self, name: str, lane: str = "main", **args):
        """Context manager recording one timed interval on ``lane``."""
        depth = self._depth.get(lane, 0)
        self._depth[lane] = depth + 1
        t0 = self._clock()
        try:
            yield self
        finally:
            dur = self._clock() - t0
            self._depth[lane] = depth
            self.events.append(SpanEvent(
                name=name, lane=lane, t0_s=t0 - self._epoch, dur_s=dur,
                depth=depth, args=args))

    def instant(self, name: str, lane: str = "main", **args) -> None:
        """Record a zero-duration marker event."""
        self.events.append(SpanEvent(
            name=name, lane=lane, t0_s=self._clock() - self._epoch,
            dur_s=0.0, depth=self._depth.get(lane, 0), args=args,
            kind="instant"))

    def spans(self, lane: str | None = None,
              name: str | None = None) -> list[SpanEvent]:
        """Recorded span events, optionally filtered by lane and/or an
        exact name match (instants excluded)."""
        return [e for e in self.events
                if e.kind == "span"
                and (lane is None or e.lane == lane)
                and (name is None or e.name == name)]

    def lanes(self) -> list[str]:
        seen: dict[str, None] = {}
        for e in self.events:
            seen.setdefault(e.lane, None)
        return list(seen)

    # -- export ---------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The trace as a Chrome-trace ``traceEvents`` dict (``ts``/``dur``
        in microseconds; one tid per lane, named via metadata events)."""
        tids = {lane: i for i, lane in enumerate(self.lanes())}
        out: list[dict] = [
            {"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
             "args": {"name": lane}}
            for lane, tid in tids.items()]
        # chrome's flame view stacks by timestamps; emit parents before
        # children at equal precision so nesting survives int truncation
        for e in sorted(self.events, key=lambda e: (e.t0_s, -e.dur_s)):
            rec: dict[str, Any] = {
                "name": e.name, "cat": e.lane, "pid": 0,
                "tid": tids[e.lane], "ts": round(e.t0_s * 1e6, 3),
                "args": dict(e.args),
            }
            if e.kind == "instant":
                rec.update(ph="i", s="t")
            else:
                rec.update(ph="X", dur=round(e.dur_s * 1e6, 3))
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome(self, path) -> str:
        """Write the Chrome-trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return str(path)


class NullTracer:
    """Disabled tracer: every operation is a no-op; ``enabled`` is False
    so hot paths can skip building span arguments entirely."""

    enabled = False
    events: tuple = ()

    _NULL_CM = contextlib.nullcontext()

    def __len__(self) -> int:
        return 0

    def span(self, name: str = "", lane: str = "main", **args):
        return self._NULL_CM

    def instant(self, name: str = "", lane: str = "main", **args) -> None:
        return None

    def spans(self, lane: str | None = None,
              name: str | None = None) -> list:
        return []

    def lanes(self) -> list:
        return []


NULL_TRACER = NullTracer()

_EPS_US = 0.5     # nesting slack: exporter rounds timestamps to 1e-3 us


def validate_chrome_trace(trace) -> dict[str, int]:
    """Validate a Chrome-trace dict / JSON file: well-formed events,
    named thread lanes, and properly nested spans per lane.

    ``trace`` may be a dict (``to_chrome`` output), a path, or a
    file-like. Returns ``{lane_name: n_complete_events}``. Raises
    ``ValueError`` on malformed events, unnamed lanes, or two spans on
    one lane that overlap without one containing the other.
    """
    if hasattr(trace, "read"):
        trace = json.load(trace)
    elif not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("trace has no traceEvents list")
    lane_names: dict[Any, str] = {}
    complete: dict[Any, list[tuple[float, float]]] = {}
    for e in events:
        ph = e.get("ph")
        if ph == "M":
            if e.get("name") == "thread_name":
                lane_names[e.get("tid")] = e["args"]["name"]
            continue
        if ph not in ("X", "i"):
            raise ValueError(f"unsupported event phase {ph!r}: {e}")
        if "ts" not in e or "name" not in e or "tid" not in e:
            raise ValueError(f"event missing ts/name/tid: {e}")
        if ph == "X":
            if "dur" not in e or e["dur"] < 0:
                raise ValueError(f"complete event without valid dur: {e}")
            complete.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for tid, spans in complete.items():
        if tid not in lane_names:
            raise ValueError(f"events on tid {tid} but no thread_name "
                             f"metadata for it")
        stack: list[tuple[float, float]] = []
        for t0, t1 in sorted(spans):
            while stack and stack[-1][1] <= t0 + _EPS_US:
                stack.pop()
            if stack and t1 > stack[-1][1] + _EPS_US:
                raise ValueError(
                    f"lane {lane_names[tid]!r}: span [{t0}, {t1}] overlaps "
                    f"[{stack[-1][0]}, {stack[-1][1]}] without nesting")
            stack.append((t0, t1))
    return {lane_names[tid]: len(spans) for tid, spans in complete.items()}
