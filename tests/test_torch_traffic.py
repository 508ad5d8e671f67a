"""Whole replays of the reference's serving benchmarks through both
packages, on the llama3-8b smoke config with the reference's parameters
carried across by the bridge, compared field by field with the wall
clock left out.

The workloads are the reference's own: ``benchmarks/traffic_bench.py``'s
``_spec``, ``SEED`` and ``SLO_TICKS`` and its four variants (``static``,
``continuous``, the ``oom_demo`` pool, ``router_2`` with prefix
transfer), and ``benchmarks/serve_bench.py``'s ``_workload`` through its
four stacks (``contiguous_1``, ``paged_1``, ``contiguous_2``,
``paged_router_2``), primed as it primes them — driven by ``run`` as the
bench measures them (``_measure``) and again by ``replay`` for the tick
stamps. No bench file is read. Every request's tokens and tick stamps,
the tick fields of ``summary()``, the router's ``stats``, preemptions,
resumes, skipped prefix tokens and KV byte counters must be identical.

Last, the chip script's router phase: its tick record (``chip_smoke.
tick_record``) on the CPU does not depend on the weights or their dtype —
what lets the card's record be held against a CPU replay.
"""

import dataclasses

import numpy as np
import pytest

from benchmarks import serve_bench, traffic_bench
from repro import obs as ref_obs
from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.transformer import init_params
from repro.serve import KVCacheOOM as RefOOM
from repro.serve import Request as RefRequest
from repro.serve import Router as RefRouter
from repro.serve import ServeEngine as RefEngine
from repro.serve import generate as ref_generate
from repro.serve import replay as ref_replay
from repro_torch import obs
from repro_torch.checkpoint import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.models import DecoderLM
from repro_torch.serve import (KVCacheOOM, Request, Router, ServeEngine,
                               WorkloadSpec, generate, replay)
from test_torch_workload import record

SLO = traffic_bench.SLO_TICKS


@pytest.fixture(scope="module")
def models():
    """The benches' model: ``init_params(cfg, seed=0)``."""
    cfg = ref_smoke_config("llama3-8b")
    params = init_params(cfg, seed=0)
    tcfg = get_smoke_config("llama3-8b")
    return cfg, params, tcfg, params_from_reference(_flatten(params), tcfg,
                                                    device="cpu")


class Pkg:
    """One package: its engine, router, request, trace and replay."""

    def __init__(self, models, port: bool):
        cfg, params, tcfg, model = models
        self.port = port
        self.cfg, self.params = (tcfg, model) if port else (cfg, params)
        self.Request = Request if port else RefRequest
        self.Router = Router if port else RefRouter
        self.OOM = KVCacheOOM if port else RefOOM
        self.obs = obs if port else ref_obs

    def engine(self, **kw):
        if self.port:
            return ServeEngine(self.cfg, self.params, device="cpu", **kw)
        return RefEngine(self.cfg, self.params, **kw)

    def trace(self):
        spec = traffic_bench._spec(self.cfg)
        if self.port:
            return generate(WorkloadSpec(**dataclasses.asdict(spec)),
                            seed=traffic_bench.SEED)
        return ref_generate(spec, seed=traffic_bench.SEED)

    def replay(self, target, reqs, **kw):
        return (replay if self.port else ref_replay)(target, reqs, **kw)


def both(models, case):
    return [case(Pkg(models, port)) for port in (False, True)]


# -- traffic_bench.py --------------------------------------------------------


def _bench_engine(pkg, **kw):
    # traffic_bench.run's ``engine``
    kw.setdefault("batch", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("paged", True)
    kw.setdefault("kv_block_size", 8)
    return pkg.engine(**kw)


TRAFFIC = {
    "static": lambda pkg: _bench_engine(pkg, scheduler="static",
                                        preempt=False),
    "continuous": lambda pkg: _bench_engine(pkg, scheduler="continuous"),
    "router_2": lambda pkg: pkg.Router([_bench_engine(pkg),
                                        _bench_engine(pkg)],
                                       prefix_transfer=True),
}


@pytest.mark.parametrize("variant", list(TRAFFIC))
def test_traffic_bench_variant_matches_the_reference(models, variant):
    def case(pkg):
        pkg.obs.metrics().reset()
        target = TRAFFIC[variant](pkg)
        rep = pkg.replay(target, pkg.trace(), slo_ticks=SLO)
        snap = pkg.obs.metrics().snapshot()
        return record(rep, target, SLO), {
            k: v for k, v in snap["counters"].items()
            if k.startswith(("serve.goodput", "serve.late", "router."))}
    (want, wc), (got, gc) = both(models, case)
    assert got == want and gc == wc
    assert got["summary"]["completed"] == traffic_bench._spec(
        models[0]).n_requests
    if variant == "router_2":
        assert got["router"]["prefix_routed"] > 0


def test_traffic_bench_gates_hold_on_the_port(models):
    """The bench's tick-domain gates: continuous batching's goodput a
    tick >= 1.5x the static scheduler's, p95 TTFT no worse."""
    pkg = Pkg(models, True)
    s = {name: pkg.replay(TRAFFIC[name](pkg), pkg.trace(),
                          slo_ticks=SLO).summary(SLO)
         for name in ("static", "continuous")}
    assert (s["continuous"]["goodput_per_tick"]
            >= traffic_bench.GOODPUT_BAR * s["static"]["goodput_per_tick"])
    assert s["continuous"]["ttft_p95_ticks"] <= s["static"]["ttft_p95_ticks"]


def test_traffic_bench_oom_demo_matches_the_reference(models):
    """Slot admission over the 12-block pool runs out mid-flight at the
    same tick in both; KV admission finishes the same load with no OOM,
    through the same preemptions and resumes."""
    def case(pkg):
        rng = np.random.default_rng(traffic_bench.SEED)
        prompts = [rng.integers(0, pkg.cfg.vocab_size, 16, dtype=np.int32)
                   for _ in range(6)]

        def engine(**kw):
            return _bench_engine(pkg, batch=4, max_len=32, kv_block_size=4,
                                 kv_blocks=12, **kw)
        base = engine(admission="slot", preempt=False)
        reqs = [pkg.Request(rid=i, prompt=p, max_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            base.submit(r)
        with pytest.raises(pkg.OOM) as err:
            base.run()
        at_oom = dict(tick=base._tick, message=str(err.value),
                      out=[[int(t) for t in r.out] for r in reqs],
                      kv=dict(base.kv.stats))
        ctrl = engine(admission="kv", preempt=True)
        reqs = [pkg.Request(rid=i, prompt=p, max_tokens=8, t_arrival=0.0)
                for i, p in enumerate(prompts)]
        rep = pkg.replay(ctrl, reqs, slo_ticks=SLO)
        return at_oom, record(rep, ctrl, SLO)
    (want_oom, want), (got_oom, got) = both(models, case)
    assert got_oom == want_oom and got == want
    assert got["summary"]["completed"] == 6 and got["preemptions"] > 0


# -- serve_bench.py ----------------------------------------------------------


def _stack(pkg, name):
    """serve_bench.run's stacks, each engine primed with the prefix as
    ``_prime`` primes it."""
    b = serve_bench
    prefix, prompts = b._workload(pkg.cfg, np.random.default_rng(0))
    waves = -(-b.N_REQUESTS // b.BATCH)
    cont_len = (waves + 1) * (b.PREFIX_LEN + b.SUFFIX_LEN + b.GEN_TOKENS) + 8
    paged_len = b.PREFIX_LEN + b.SUFFIX_LEN + b.GEN_TOKENS + b.BLOCK_SIZE
    if name.startswith("contiguous"):
        def mk():
            return pkg.engine(batch=b.BATCH, max_len=cont_len)
    else:
        def mk():
            return pkg.engine(batch=b.BATCH, max_len=paged_len, paged=True,
                              kv_block_size=b.BLOCK_SIZE)
    n = int(name[-1])
    target = mk() if n == 1 else pkg.Router([mk() for _ in range(n)])
    for e in ([target] if n == 1 else target.engines):
        if pkg.port:
            e.submit(Request(rid=-1, prompt=prefix, max_tokens=1))
            e.run()
        else:
            b._prime(e, prefix)
    return target, prompts


STACKS = ("contiguous_1", "paged_1", "contiguous_2", "paged_router_2")


def _measure(target, prompts) -> dict:
    """serve_bench's ``_measure`` over the port's ``Request``."""
    obs.metrics().reset()
    reqs = [Request(rid=i, prompt=p, max_tokens=serve_bench.GEN_TOKENS)
            for i, p in enumerate(prompts)]
    base_tokens = sum(len(r.out) for r in target.completed)
    base_read, base_written = target.kv_bytes_read, target.kv_bytes_written
    for r in reqs:
        target.submit(r)
    done = target.run()
    return {"requests": len(reqs),
            "generated_tokens": sum(len(r.out) for r in done) - base_tokens,
            "kv_bytes_read": target.kv_bytes_read - base_read,
            "kv_bytes_written": target.kv_bytes_written - base_written,
            "prefix_skipped_tokens": getattr(target,
                                             "prefix_skipped_tokens", 0)}


def _outcome(target) -> dict:
    engines = getattr(target, "engines", [target])
    return dict(done=[(r.rid, [int(t) for t in r.out]) for r in
                      target.completed],
                ticks=[e._tick for e in engines],
                stats=getattr(target, "stats", None),
                preemptions=target.preemptions)


@pytest.mark.parametrize("stack", STACKS)
def test_serve_bench_stack_measures_as_the_reference(models, stack):
    """The bench's own measurement (``run``): its non-wall fields, every
    request's tokens and the engines' ticks."""
    ref_target, prompts = _stack(Pkg(models, False), stack)
    want = serve_bench._measure(ref_target, prompts)
    want = {k: v for k, v in want.items()
            if not k.endswith(("_s", "_per_s")) and k != "wall_s"}
    target, tprompts = _stack(Pkg(models, True), stack)
    assert all((a == b).all() for a, b in zip(prompts, tprompts))
    assert _measure(target, tprompts) == want
    assert _outcome(target) == _outcome(ref_target)


@pytest.mark.parametrize("stack", STACKS)
def test_serve_bench_stack_replays_as_the_reference(models, stack):
    """The same stacks driven by ``replay`` (every request arriving at
    tick 0): tokens, tick stamps and the report's tick fields."""
    def case(pkg):
        target, prompts = _stack(pkg, stack)
        reqs = [pkg.Request(rid=i, prompt=p,
                            max_tokens=serve_bench.GEN_TOKENS, t_arrival=0.0)
                for i, p in enumerate(prompts)]
        return record(pkg.replay(target, reqs, slo_ticks=SLO), target, SLO)
    want, got = both(models, case)
    assert got == want
    assert got["summary"]["completed"] == serve_bench.N_REQUESTS
    if stack == "paged_router_2":
        assert got["router"]["prefix_routed"] == serve_bench.N_REQUESTS


# -- the chip script's router phase -----------------------------------------


def test_router_phase_record_ignores_the_weights():
    """``chip_smoke.tick_record`` of the router phase's trace, replayed
    on the CPU as the phase replays it (``cpu_tick_record``: the smoke
    config in float32): equal to a replay over a bfloat16 model with
    other weights — the scheduling never reads a sampled token. (The
    reference's router at this vocabulary compiles a prefill per prompt
    length, ~70 s; ``test_router_replays_a_workload_as_the_reference``
    holds the router's decisions against it on a smaller trace.)"""
    import chip_smoke as cs
    vocab = 128256
    want = cs.cpu_tick_record(0, vocab)
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              vocab_size=vocab, dtype="bfloat16")

    def replayed(trace):
        router, _ = cs.router_setup(cfg, DecoderLM(cfg, device="cpu")
                                    .init(5), 0, "cpu")
        return cs.tick_record(replay(router, trace,
                                     slo_ticks=cs.ROUTER_SLO_TICKS), router)
    spec = WorkloadSpec(vocab=vocab, **cs.ROUTER_SPEC)
    assert replayed(generate(spec, seed=0)) == want
    assert want["stats"]["prefix_transferred"] >= 1
    assert all(r[3] is not None for r in want["requests"])
    # the control: the same trace with two arrivals swapped decides
    # otherwise
    trace = generate(spec, seed=0)
    trace[0].t_arrival, trace[-1].t_arrival = (trace[-1].t_arrival,
                                               trace[0].t_arrival)
    assert replayed(trace) != want
