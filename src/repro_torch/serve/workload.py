"""Seeded serving workload generator + arrival-driven replay.

Production traffic is nothing like the fixed request lists the serving
tests drive: arrivals are bursty (Poisson base rate with on/off bursts),
prompts share a small set of hot prefixes with Zipf popularity (the
chat-system-prompt shape), and prompt/output lengths are heavy-tailed.
This module, the port of ``repro.serve.workload``, generates such
traffic deterministically from a seed and replays it against a
``ServeEngine`` or ``Router`` on a **virtual clock**: one clock tick per
batched decode tick, requests submitted when their arrival time comes
due — so TTFT is measured from *arrival* (queue wait included), not from
admission, and every tick-domain metric is bit-reproducible across
machines.

The wall clock is recorded alongside (tokens/s, goodput tokens/s), but
the benchmark gates ride the tick domain: two scheduling policies
replayed over the same seeded workload differ only by their scheduling
decisions, never by host noise.

Goodput follows the continuous-batching literature: only tokens of
requests whose TTFT met the SLO count — a scheduler that starves tail
requests to fatten aggregate throughput gets no credit for them.

It stays numpy and draws from ``np.random.default_rng(seed)`` in the
reference's order (prefixes, arrivals, then per request the prefix
choice, the tail length, the tail tokens and ``max_tokens``), so one
``(spec, seed)`` gives the same trace bit for bit in both packages.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch import obs
from repro_torch.obs.metrics import TICK_EDGES
from repro_torch.serve.engine import Request


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Knobs for one synthetic traffic trace (all sampling is seeded).

    Arrivals: ``arrival="poisson"`` draws i.i.d. exponential
    inter-arrival gaps with mean ``mean_interarrival`` (virtual ticks);
    ``"bursty"`` runs a two-state modulated Poisson process — ON phases
    arrive ``burst_factor``x faster than the configured mean, OFF phases
    correspondingly slower so the long-run rate is preserved, with
    exponential phase lengths (``burst_mean_len`` ticks ON, scaled by the
    ON/OFF duty ``burst_fraction``).

    Prompts: ``n_prefixes`` hot prefixes of ``prefix_len`` tokens,
    picked per request with Zipf(``zipf_a``) popularity, plus a unique
    lognormal-length tail (``tail_len_mean``/``tail_len_sigma``,
    clipped to ``max_tail``). Outputs: lognormal ``max_tokens``
    (``out_mean``/``out_sigma``, clipped to ``max_out``).
    """

    n_requests: int = 64
    vocab: int = 256
    # arrivals (virtual ticks)
    arrival: str = "bursty"             # "poisson" | "bursty"
    mean_interarrival: float = 2.0
    burst_factor: float = 6.0
    burst_fraction: float = 0.25
    burst_mean_len: float = 12.0
    # prompts
    n_prefixes: int = 8
    zipf_a: float = 1.2
    prefix_len: int = 16
    tail_len_mean: float = 4.0
    tail_len_sigma: float = 0.8
    max_tail: int = 32
    # outputs
    out_mean: float = 8.0
    out_sigma: float = 0.8
    max_out: int = 48
    eos: int | None = None

    def __post_init__(self):
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(f"arrival must be 'poisson' or 'bursty', "
                             f"got {self.arrival!r}")
        if self.n_requests < 1 or self.n_prefixes < 1:
            raise ValueError("n_requests and n_prefixes must be >= 1")
        if self.mean_interarrival <= 0 or self.burst_factor < 1:
            raise ValueError("mean_interarrival must be > 0 and "
                             "burst_factor >= 1")
        if not 0 < self.burst_fraction < 1:
            raise ValueError(f"burst_fraction must be in (0, 1), got "
                             f"{self.burst_fraction}")


def _lognormal_len(rng, mean: float, sigma: float, cap: int) -> int:
    """Heavy-tailed positive integer length with the given *linear*
    mean: lognormal body, clipped to [1, cap]."""
    mu = math.log(mean) - 0.5 * sigma * sigma
    return int(np.clip(round(rng.lognormal(mu, sigma)), 1, cap))


def _arrival_times(spec: WorkloadSpec, rng) -> list[float]:
    times = []
    t = 0.0
    if spec.arrival == "poisson":
        for _ in range(spec.n_requests):
            t += rng.exponential(spec.mean_interarrival)
            times.append(t)
        return times
    # bursty: ON phases at burst_factor x the long-run rate, OFF phases
    # slowed so the overall mean inter-arrival stays mean_interarrival:
    #   1/mean = duty/on_gap + (1-duty)/off_gap  with on_gap = mean/factor
    duty = spec.burst_fraction
    on_gap = spec.mean_interarrival / spec.burst_factor
    denom = 1.0 - duty * spec.burst_factor
    if denom <= 0:        # bursts carry the whole rate; OFF goes silent
        off_gap = math.inf
    else:
        off_gap = spec.mean_interarrival * (1.0 - duty) / denom
    on = True
    phase_end = rng.exponential(spec.burst_mean_len)
    while len(times) < spec.n_requests:
        gap = on_gap if on else off_gap
        if math.isinf(gap):
            t = phase_end    # silent OFF phase: jump to the next burst
        else:
            t += rng.exponential(gap)
        while t >= phase_end:
            on = not on
            mean_len = (spec.burst_mean_len if on
                        else spec.burst_mean_len * (1 - duty) / duty)
            phase_end += rng.exponential(mean_len)
        if not math.isinf(gap) or on:
            times.append(t)
    return times


def generate(spec: WorkloadSpec, seed: int = 0) -> list[Request]:
    """Materialize one traffic trace: ``n_requests`` ``Request``s with
    ``t_arrival`` stamped in virtual ticks, sorted by arrival. The same
    (spec, seed) always yields the same trace — scheduling policies are
    compared on identical offered load."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, spec.vocab, spec.prefix_len,
                             dtype=np.int32)
                for _ in range(spec.n_prefixes)]
    ranks = np.arange(1, spec.n_prefixes + 1, dtype=np.float64)
    p = ranks ** -spec.zipf_a
    p /= p.sum()
    times = _arrival_times(spec, rng)
    reqs = []
    for i, t in enumerate(times):
        prefix = prefixes[rng.choice(spec.n_prefixes, p=p)]
        tail_len = _lognormal_len(rng, spec.tail_len_mean,
                                  spec.tail_len_sigma, spec.max_tail)
        tail = rng.integers(0, spec.vocab, tail_len, dtype=np.int32)
        reqs.append(Request(
            rid=i, prompt=np.concatenate([prefix, tail]),
            max_tokens=_lognormal_len(rng, spec.out_mean, spec.out_sigma,
                                      spec.max_out),
            eos=spec.eos, t_arrival=float(t)))
    reqs.sort(key=lambda r: (r.t_arrival, r.rid))
    return reqs


@dataclasses.dataclass
class TrafficReport:
    """Replay outcome: per-request virtual-clock stamps + wall clock."""

    requests: list[Request]
    ticks: int                    # decode ticks driven (idle excluded)
    idle_ticks: int               # clock advanced with nothing admissible
    wall_s: float
    starved: list[int]            # rids still pending at exit

    @property
    def completed(self) -> list[Request]:
        return [r for r in self.requests if r.done]

    @property
    def generated_tokens(self) -> int:
        return sum(len(r.out) for r in self.completed)

    def ttft_ticks(self) -> np.ndarray:
        """TTFT from *arrival* (queue wait included), virtual ticks."""
        return np.array([r.ttft_ticks for r in self.requests
                         if r.ttft_ticks is not None])

    def e2e_ticks(self) -> np.ndarray:
        return np.array([r.done_tick - r.t_arrival
                         for r in self.completed
                         if r.done_tick is not None])

    def ttft_percentile(self, q: float) -> float:
        vals = self.ttft_ticks()
        return float(np.percentile(vals, q)) if len(vals) else math.nan

    def goodput_tokens(self, slo_ticks: float) -> int:
        """Tokens of completed requests whose TTFT met the SLO — tokens
        served too late to matter earn no credit."""
        return sum(len(r.out) for r in self.completed
                   if r.ttft_ticks is not None
                   and r.ttft_ticks <= slo_ticks)

    def goodput_per_tick(self, slo_ticks: float) -> float:
        total = self.ticks + self.idle_ticks
        return self.goodput_tokens(slo_ticks) / max(1, total)

    def goodput_per_s(self, slo_ticks: float) -> float:
        return (self.goodput_tokens(slo_ticks) / self.wall_s
                if self.wall_s else math.inf)

    def summary(self, slo_ticks: float) -> dict:
        """JSON-ready roll-up (the benchmark's per-variant record)."""
        done = self.completed
        return {
            "requests": len(self.requests),
            "completed": len(done),
            "starved": len(self.starved),
            "generated_tokens": self.generated_tokens,
            "ticks": self.ticks,
            "idle_ticks": self.idle_ticks,
            "wall_s": self.wall_s,
            "tokens_per_tick": (self.generated_tokens
                                / max(1, self.ticks + self.idle_ticks)),
            "tokens_per_s": (self.generated_tokens / self.wall_s
                             if self.wall_s else math.inf),
            "ttft_p50_ticks": self.ttft_percentile(50),
            "ttft_p95_ticks": self.ttft_percentile(95),
            "slo_ticks": slo_ticks,
            "goodput_tokens": self.goodput_tokens(slo_ticks),
            "goodput_per_tick": self.goodput_per_tick(slo_ticks),
            "goodput_per_s": self.goodput_per_s(slo_ticks),
        }


def replay(target, requests: list[Request], *, slo_ticks: float | None =
           None, max_ticks: int | None = None,
           on_starvation: str = "raise") -> TrafficReport:
    """Drive ``target`` (a ``ServeEngine`` or ``Router`` — anything with
    ``submit``/``tick_once``/``pending_rids``) through the trace on the
    virtual clock: each loop iteration submits every request whose
    ``t_arrival`` has come due, then advances one decode tick. First
    token and completion are stamped in ticks per request; gaps where
    nothing is admissible fast-forward the clock to the next arrival
    (counted in ``idle_ticks``).

    When ``slo_ticks`` is given, per-request TTFT and end-to-end
    latencies are also recorded into the ``serve.ttft_ticks`` /
    ``serve.e2e_ticks`` obs histograms and goodput/late tokens into the
    ``serve.goodput_tokens`` / ``serve.late_tokens`` counters."""
    if on_starvation not in ("raise", "return"):
        raise ValueError(f"on_starvation must be 'raise' or 'return', "
                         f"got {on_starvation!r}")
    reqs = sorted(requests, key=lambda r: (r.t_arrival or 0.0, r.rid))
    for r in reqs:
        if r.out or r.done or r.resume is not None:
            raise ValueError(f"request rid={r.rid} was already driven; "
                             f"replay needs fresh Request objects")
    work = sum(max(0, len(r.prompt) - 1) + r.max_tokens for r in reqs)
    last_arrival = max((r.t_arrival or 0.0 for r in reqs), default=0.0)
    budget = (max_ticks if max_ticks is not None
              else math.ceil(last_arrival) + 2 * work + 64)
    t = 0          # virtual clock, in decode ticks
    i = 0          # next arrival to submit
    ticks = idle = 0
    unstamped = set(range(len(reqs)))
    t0 = time.perf_counter()
    while t < budget:
        while i < len(reqs) and (reqs[i].t_arrival or 0.0) <= t:
            target.submit(reqs[i])
            i += 1
        progressed = target.tick_once()
        t += 1
        if progressed:
            ticks += 1
            for j in sorted(unstamped):
                r = reqs[j]
                if r.first_tick is None and r.out:
                    r.first_tick = t
                if r.done:
                    r.done_tick = t
                    unstamped.discard(j)
        elif i < len(reqs):
            # idle: nothing admitted yet — fast-forward to next arrival
            nxt = math.ceil(reqs[i].t_arrival or 0.0)
            idle += max(1, nxt - t + 1)
            t = max(t, nxt)
        else:
            break       # no progress possible and no arrivals left
        if i >= len(reqs) and not unstamped:
            break
    wall = time.perf_counter() - t0
    starved = target.pending_rids() if unstamped else []
    report = TrafficReport(requests=reqs, ticks=ticks, idle_ticks=idle,
                           wall_s=wall, starved=starved)
    if slo_ticks is not None:
        m = obs.metrics()
        ttft_h = m.histogram("serve.ttft_ticks", TICK_EDGES)
        e2e_h = m.histogram("serve.e2e_ticks", TICK_EDGES)
        for r in report.completed:
            if r.ttft_ticks is not None:
                ttft_h.observe(r.ttft_ticks)
                which = ("serve.goodput_tokens"
                         if r.ttft_ticks <= slo_ticks
                         else "serve.late_tokens")
                m.counter(which).inc(len(r.out))
            if r.done_tick is not None:
                e2e_h.observe(r.done_tick - (r.t_arrival or 0.0))
    if starved and on_starvation == "raise":
        raise RuntimeError(
            f"replay stopped at tick {t} (budget {budget}) with requests "
            f"still pending (rids {starved}); raise max_ticks or pass "
            f"on_starvation='return'")
    return report
