"""Multi-engine serving router, the port of ``repro.serve.router``:
KV-pressure-aware dispatch with prefix affinity and cross-engine prefix
migration over N ``ServeEngine``s.

One ``ServeEngine`` is one PIM placement (replicated engines share one
``DecoderLM``'s tensors and hold their own KV pools and programs;
partition-sharded engines run ``partitions=K`` pipeline plans — both are
just engine kwargs). The router is the serving-side
counterpart of the pipeline partitions: it scales *request* throughput
across placements the way ``Schedule.pipeline`` scales *microbatch*
throughput within one.

Dispatch policy, per request:

  1. **prefix affinity** — ask every engine's paged KV cache how many
     prompt tokens it already holds (``ServeEngine.prefix_lookup``);
     when any engine has a cached prefix, the engine holding the longest
     one is the affinity candidate (ties broken by lighter load, then by
     lowest index — fully deterministic). Routing there skips replaying
     those tokens entirely.
  2. **KV-aware depth** — otherwise (or when the affinity holder is
     overloaded, see 3) route by load score: pending work (remaining
     prompt + generation tokens, maintained O(1) per engine) **plus a
     KV-pressure penalty** — the blocks this request needs beyond the
     engine's free+evictable pool, in token units (``block_size`` per
     missing block). An engine with room in its queue but no KV headroom
     would stall the request at admission; the penalty makes the router
     see that stall. Ties break toward more free KV blocks, then lowest
     engine index.
  3. **prefix migration** (``prefix_transfer=True``) — when the
     affinity holder's load exceeds the best depth-routed engine's by
     more than the replay cost the cached prefix saves, the router
     copies the cached prefix blocks to the lighter engine
     (``PagedKVCache.export_prefix`` / ``import_prefix``) and routes
     there: the prefix cached on engine A becomes servable from B
     instead of pinning all its traffic to A. The copy goes through host
     memory, one block at a time, and lands on the device B's pool
     lives on.

``run`` drives all engines tick-by-tick in an interleaved loop
(``tick_once``), so no engine's queue waits for another's to drain; the
budget scales with total remaining work, same as the engine-level
scheduler.
"""

from __future__ import annotations

import time
from typing import Iterable

from repro_torch import obs
from repro_torch.serve.engine import Request, ServeEngine


class Router:
    def __init__(self, engines: Iterable[ServeEngine], *,
                 prefix_transfer: bool = False):
        self.engines = list(engines)
        if not self.engines:
            raise ValueError("Router needs at least one engine")
        if prefix_transfer and not all(e.paged for e in self.engines):
            raise ValueError("prefix_transfer=True requires every engine "
                             "to be paged (contiguous lanes hold no "
                             "migratable prefix blocks)")
        self.prefix_transfer = prefix_transfer
        self.stats = {
            "prefix_routed": 0,       # dispatched by prefix affinity
            "depth_routed": 0,        # dispatched by load score
            "prefix_transferred": 0,  # dispatches that migrated a prefix
            "transferred_blocks": 0,  # prefix blocks copied across engines
            "per_engine": [0] * len(self.engines),
        }
        self.starved: list[int] = []

    @classmethod
    def replicated(cls, cfg, params, n_engines: int = 2,
                   prefix_transfer: bool = False,
                   **engine_kwargs) -> "Router":
        """N engines over replicated placements of the same params.
        ``params`` is the ``DecoderLM``: every engine shares its tensors
        (no weight is copied). ``engine_kwargs`` pass through to every
        ``ServeEngine`` (e.g. ``paged=True``, ``backend="pim"``,
        ``partitions=K`` for partition-sharded placements,
        ``device="cpu"``)."""
        if n_engines < 1:
            raise ValueError(f"need >= 1 engine, got {n_engines}")
        return cls([ServeEngine(cfg, params, **engine_kwargs)
                    for _ in range(n_engines)],
                   prefix_transfer=prefix_transfer)

    def _load_score(self, i: int, req: Request) -> float:
        """Token-denominated load estimate for dispatching ``req`` to
        engine ``i``: queued+active work plus the admission stall the
        engine's KV pool would impose (missing blocks x block tokens)."""
        e = self.engines[i]
        score = float(e.pending_work())
        if e.paged:
            deficit = max(0, e.kv_blocks_needed(req) - e.kv_headroom())
            score += deficit * e.block_size
        return score

    def _depth_choice(self, req: Request) -> int:
        """Lowest load score; ties prefer more free KV blocks, then the
        lowest engine index (deterministic)."""
        return min(range(len(self.engines)),
                   key=lambda i: (self._load_score(i, req),
                                  -self.engines[i].kv_headroom(), i))

    def _migrate_prefix(self, src: int, dst: int, prompt) -> int:
        """Copy the cached prefix chain covering ``prompt`` from engine
        ``src``'s pool into ``dst``'s. Returns blocks copied."""
        a, b = self.engines[src], self.engines[dst]
        _, pages = a.kv.export_prefix(a.cache, prompt)
        if pages:
            b.cache = b.kv.import_prefix(b.cache, prompt, pages)
        return len(pages)

    def submit(self, req: Request) -> int:
        """Dispatch one request; returns the chosen engine index."""
        if req.t_submit is None:      # TTFT clock starts at router entry
            req.t_submit = time.monotonic()
        m = obs.metrics()
        hits = [e.prefix_lookup(req.prompt) for e in self.engines]
        best = max(hits)
        if best > 0:
            cands = [i for i, h in enumerate(hits) if h == best]
            idx = min(cands, key=lambda i: (self.engines[i].pending_work(),
                                            i))
            alt = self._depth_choice(req)
            if (self.prefix_transfer and alt != idx
                    and self._load_score(idx, req)
                    > self._load_score(alt, req) + best):
                # the affinity holder's queue costs more than the prefix
                # saves: move the prefix to the lighter engine instead
                moved = self._migrate_prefix(idx, alt, req.prompt)
                if moved:
                    self.stats["prefix_transferred"] += 1
                    self.stats["transferred_blocks"] += moved
                    m.counter("router.prefix_transferred").inc()
                    idx = alt
            self.stats["prefix_routed"] += 1
            m.counter("router.prefix_routed").inc()
        else:
            idx = self._depth_choice(req)
            self.stats["depth_routed"] += 1
            m.counter("router.depth_routed").inc()
        self.stats["per_engine"][idx] += 1
        self.engines[idx].submit(req)
        for i, e in enumerate(self.engines):
            m.gauge(f"router.queue_depth.engine{i}").set(len(e.queue))
            if e.paged:
                m.gauge(f"router.kv_free_blocks.engine{i}").set(
                    e.kv_headroom())
        return idx

    def pending_work(self) -> int:
        return sum(e.pending_work() for e in self.engines)

    def pending_rids(self) -> list[int]:
        return [rid for e in self.engines for rid in e.pending_rids()]

    @property
    def completed(self) -> list[Request]:
        return [r for e in self.engines for r in e.completed]

    @property
    def preemptions(self) -> int:
        return sum(e.preemptions for e in self.engines)

    @property
    def prefix_skipped_tokens(self) -> int:
        return sum(e.prefix_skipped_tokens for e in self.engines)

    @property
    def kv_bytes_read(self) -> int:
        return sum(e.kv_bytes_read for e in self.engines)

    @property
    def kv_bytes_written(self) -> int:
        return sum(e.kv_bytes_written for e in self.engines)

    def tick_once(self) -> bool:
        """Advance every engine one decode tick (continuous batching
        inside each — freed slots refill the same tick). Returns True
        while any engine made progress."""
        progressed = [e.tick_once() for e in self.engines]
        return any(progressed)

    def run(self, max_ticks: int | None = None, *,
            on_starvation: str = "raise") -> list[Request]:
        """Interleave all engines until every queue drains: each router
        tick advances every engine with admissible work by one decode
        tick. Budget and starvation semantics match ``ServeEngine.run``
        (budget scales with total remaining work; an engine that can no
        longer progress — e.g. contiguous lanes exhausted — leaves its
        pending requests in ``self.starved``)."""
        if on_starvation not in ("raise", "return"):
            raise ValueError(f"on_starvation must be 'raise' or 'return', "
                             f"got {on_starvation!r}")
        budget = max_ticks if max_ticks is not None \
            else max(1, self.pending_work())
        ticks = 0
        while ticks < budget and self.tick_once():
            ticks += 1
        self.starved = self.pending_rids()
        if self.starved and on_starvation == "raise":
            raise RuntimeError(
                f"router stopped after {ticks} ticks (budget {budget}) "
                f"with requests still pending (rids {self.starved}); "
                f"raise max_ticks or pass on_starvation='return'")
        return self.completed
