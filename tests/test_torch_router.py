"""``repro_torch.serve.router.Router`` against ``repro.serve.router.Router``
on the llama3-8b smoke config, the reference's parameters carried across
by the bridge: the reference's router cases (``tests/test_serve_paged.py``)
run through both packages and compared — ragged load with no starvation,
prefix affinity, prefix migration staying exact, deterministic
tie-breaking, starvation propagating, the dispatch counts — with every
request's engine and tokens, the router's ``stats`` and ``router.*``
counters, preemptions, skipped prefix tokens and KV byte counters equal.

Then what only the port has: the engines share one ``DecoderLM``'s
tensors; a router over int8 pools with the paged decode kernel
(``attn_kernel=True``: K6's plain version on the CPU) against the
reference's over the same pools; a router over two ``backend="pim"``
engines token- and tick-identical to one over two jit engines.
"""

import jax
import numpy as np
import pytest

from repro import configs
from repro import obs as ref_obs
from repro.checkpoint.ckpt import _flatten
from repro.models.transformer import build_model
from repro.serve import Request as RefRequest
from repro.serve import Router as RefRouter
from repro.serve import WorkloadSpec as RefSpec
from repro.serve import generate as ref_generate
from repro.serve import replay as ref_replay
from repro_torch import obs
from repro_torch.checkpoint import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.serve import (Request, Router, ServeEngine, WorkloadSpec,
                               generate, replay)
from test_serve_paged import _greedy_reference
from test_torch_workload import record


@pytest.fixture(scope="module")
def models():
    cfg = configs.get_smoke_config("llama3-8b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("llama3-8b")
    return (cfg, model, params, tcfg,
            params_from_reference(_flatten(params), tcfg, device="cpu"))


class Side:
    """One package's router, engine and request classes over its params,
    so a case runs the same code through both."""

    def __init__(self, models, port: bool):
        cfg, _, params, tcfg, tmodel = models
        self.port = port
        self.cfg = tcfg if port else cfg
        self.params = tmodel if port else params
        self.Router = Router if port else RefRouter
        self.Request = Request if port else RefRequest
        self.obs = obs if port else ref_obs

    def router(self, n, **kw):
        if self.port:
            kw["device"] = "cpu"
        return self.Router.replicated(self.cfg, self.params, n, **kw)

    def engine(self, **kw):
        if self.port:
            return ServeEngine(self.cfg, self.params, device="cpu", **kw)
        from repro.serve import ServeEngine as RefEngine
        return RefEngine(self.cfg, self.params, **kw)


def both(models, case):
    """``case(side)`` through the reference, then the port, each with its
    metrics registry reset: the two results, each with the ``router.*``
    counters the case left."""
    out = []
    for port in (False, True):
        side = Side(models, port)
        side.obs.metrics().reset()
        got = case(side)
        counters = side.obs.metrics().snapshot()["counters"]
        out.append((got, {k: v for k, v in counters.items()
                          if k.startswith("router.")}))
    return out


def routed(router, reqs) -> dict:
    """A router's outcome: each request's engine and tokens, its counts."""
    where = {r.rid: i for i, e in enumerate(router.engines)
             for r in e.completed}
    return dict(requests=[(r.rid, where.get(r.rid), [int(t) for t in r.out],
                           r.done) for r in reqs],
                stats=router.stats, starved=router.starved,
                preemptions=router.preemptions,
                skipped=router.prefix_skipped_tokens,
                kv=(router.kv_bytes_read, router.kv_bytes_written),
                ticks=[e._tick for e in router.engines],
                work=router.pending_work(), pending=router.pending_rids())


def test_router_no_starvation_ragged_two_engines(models):
    def case(side):
        rng = np.random.default_rng(7)
        router = side.router(2, batch=2, max_len=32, paged=True,
                             kv_block_size=4)
        reqs = [side.Request(rid=i, prompt=rng.integers(
            0, side.cfg.vocab_size, 3 + i % 5, dtype=np.int32),
            max_tokens=2 + i % 3) for i in range(10)]
        idx = [router.submit(r) for r in reqs]
        done = router.run()
        assert len(done) == 10 and router.starved == []
        return idx, routed(router, reqs)
    (want, wc), (got, gc) = both(models, case)
    assert got == want and gc == wc
    assert min(got[1]["stats"]["per_engine"]) >= 3
    assert gc["router.depth_routed"] == 10


def _warm(side, router, prefix, engine=0):
    router.engines[engine].submit(side.Request(rid=99, prompt=prefix,
                                               max_tokens=1))
    router.engines[engine].run()


def test_router_prefix_affinity(models):
    def case(side):
        rng = np.random.default_rng(8)
        prefix = rng.integers(0, side.cfg.vocab_size, 12, dtype=np.int32)
        router = side.router(2, batch=2, max_len=32, paged=True,
                             kv_block_size=4)
        _warm(side, router, prefix)
        reqs = [side.Request(rid=i, prompt=np.concatenate([prefix, rng.integers(
            0, side.cfg.vocab_size, 2, dtype=np.int32)]), max_tokens=2)
            for i in range(4)]
        hits = [router.engines[0].prefix_lookup(r.prompt) for r in reqs]
        idx = [router.submit(r) for r in reqs]
        router.run()
        return idx, hits, routed(router, reqs)
    (want, wc), (got, gc) = both(models, case)
    assert got == want and gc == wc
    assert got[0] == [0, 0, 0, 0] and got[1] == [12] * 4
    assert got[2]["stats"]["prefix_routed"] == 4 and got[2]["skipped"] > 0


def test_router_prefix_transfer_migrates_and_stays_exact(models):
    """The migrated request's tokens equal the reference router's and
    the lone-request contiguous reference; the byte counters and the
    imported blocks' values equal the reference's."""
    def case(side):
        rng = np.random.default_rng(13)
        prefix = rng.integers(0, side.cfg.vocab_size, 12, dtype=np.int32)
        router = side.router(2, batch=1, max_len=32, paged=True,
                             kv_block_size=4, prefix_transfer=True)
        _warm(side, router, prefix)
        load = [side.Request(rid=50 + i, prompt=rng.integers(
            0, side.cfg.vocab_size, 8, dtype=np.int32), max_tokens=8)
            for i in range(4)]
        for r in load:
            router.engines[0].submit(r)
        prompt = np.concatenate([prefix, rng.integers(
            0, side.cfg.vocab_size, 3, dtype=np.int32)])
        req = side.Request(rid=0, prompt=prompt, max_tokens=4)
        idx = router.submit(req)
        e1 = router.engines[1]
        hit = e1.prefix_lookup(prompt)
        bids = [e1.kv._prefix[k] for k in e1.kv._chain_keys(
            prompt, hit // e1.block_size)]
        pool = e1.cache if side.port else e1.cache["layers"]["block0"]
        blocks = [np.asarray(pool["k"][:, b], np.float32) for b in bids]
        router.run()
        return (idx, hit, routed(router, [req, *load]),
                e1.prefix_skipped_tokens, dict(e1.kv.stats)), blocks, prompt
    (want, wc), (got, gc) = both(models, case)
    assert got[0] == want[0] and gc == wc
    assert len(got[1]) == len(want[1]) == 3
    for a, b in zip(got[1], want[1]):     # the repo's cross-path tolerance
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    idx, hit, out, skipped, kv_stats = got[0]
    assert idx == 1 and hit == 12 and skipped == 12
    assert out["stats"]["prefix_transferred"] == 1
    assert out["stats"]["transferred_blocks"] == 3
    assert kv_stats["imported_blocks"] == 3
    cfg, model, params = models[:3]
    assert out["requests"][0][2] == _greedy_reference(model, params,
                                                      got[2], 4)


def test_router_deterministic_tie_breaking(models):
    def case(side):
        req = side.Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                           max_tokens=2)
        router = side.router(3, batch=1, max_len=16, paged=True,
                             kv_block_size=4)
        first = [router._depth_choice(req) for _ in range(3)]
        scores = [router._load_score(i, req) for i in range(3)]
        router.engines[0].kv._free.pop()
        return first, scores, router._depth_choice(req), [
            e.kv_headroom() for e in router.engines]
    (want, _), (got, _) = both(models, case)
    assert got == want
    assert got[0] == [0, 0, 0] and got[2] == 1


def test_router_kv_pressure_scores_the_missing_blocks(models):
    """An engine whose pool cannot hold a request pays the missing blocks
    in tokens (``block_size`` each), so a request goes to the roomier
    engine even when its queue is deeper."""
    def case(side):
        router = side.router(2, batch=2, max_len=32, paged=True,
                             kv_block_size=4, kv_blocks=6)
        big = side.Request(rid=0, prompt=np.arange(12, dtype=np.int32),
                           max_tokens=6)
        # engine 0's pool down to one free block
        free = router.engines[0].kv._free
        for _ in range(len(free) - 1):
            free.pop()
        router.engines[1].submit(side.Request(
            rid=1, prompt=np.arange(3, dtype=np.int32), max_tokens=2))
        return ([router._load_score(i, big) for i in range(2)],
                [e.kv_headroom() for e in router.engines],
                [e.kv_blocks_needed(big) for e in router.engines],
                router._depth_choice(big))
    (want, _), (got, _) = both(models, case)
    assert got == want
    assert got[0][0] > got[0][1] and got[3] == 1


def test_router_starvation_propagates(models):
    def case(side):
        router = side.router(2, batch=1, max_len=8)
        router.submit(side.Request(rid=3, prompt=np.arange(
            3, dtype=np.int32), max_tokens=50))
        with pytest.raises(RuntimeError, match="pending") as err:
            router.run()
        starved = list(router.starved)
        router2 = side.router(2, batch=1, max_len=8)
        router2.submit(side.Request(rid=4, prompt=np.arange(
            3, dtype=np.int32), max_tokens=50))
        router2.run(on_starvation="return")
        with pytest.raises(ValueError, match="on_starvation") as bad:
            router2.run(on_starvation="skip")
        return str(err.value), starved, list(router2.starved), str(bad.value)
    (want, _), (got, _) = both(models, case)
    assert got == want
    assert got[1] == [3] and got[2] == [4]


def test_router_stats_under_mixed_dispatch(models):
    def case(side):
        rng = np.random.default_rng(14)
        prefix = rng.integers(0, side.cfg.vocab_size, 12, dtype=np.int32)
        router = side.router(2, batch=2, max_len=32, paged=True,
                             kv_block_size=4)
        _warm(side, router, prefix)
        reqs = []
        for i in range(6):
            if i % 2:
                prompt = np.concatenate([prefix, rng.integers(
                    0, side.cfg.vocab_size, 2, dtype=np.int32)])
            else:
                prompt = rng.integers(0, side.cfg.vocab_size, 6,
                                      dtype=np.int32)
            reqs.append(side.Request(rid=i, prompt=prompt, max_tokens=2))
            router.submit(reqs[-1])
        gauges = side.obs.metrics().snapshot()["gauges"]
        router.run()
        return routed(router, reqs), {k: v for k, v in gauges.items()
                                      if k.startswith("router.")}
    (want, wc), (got, gc) = both(models, case)
    assert got == want and gc == wc
    stats = got[0]["stats"]
    assert (stats["prefix_routed"], stats["depth_routed"]) == (3, 3)
    assert sum(stats["per_engine"]) == 6
    assert set(got[1]) == {f"router.{g}.engine{i}" for i in range(2)
                           for g in ("queue_depth", "kv_free_blocks")}


def test_router_replays_a_workload_as_the_reference(models):
    """A seeded bursty trace through two paged routers with prefix
    transfer: the whole replay record equal."""
    spec = dict(n_requests=20, vocab=256, mean_interarrival=4.0,
                n_prefixes=3, prefix_len=8, max_tail=6, max_out=8)

    def case(side):
        router = side.router(2, batch=2, max_len=32, paged=True,
                             kv_block_size=4, prefix_transfer=True)
        if side.port:
            rep = replay(router, generate(WorkloadSpec(**spec), seed=2),
                         slo_ticks=12.0)
        else:
            rep = ref_replay(router, ref_generate(RefSpec(**spec), seed=2),
                             slo_ticks=12.0)
        return record(rep, router, 12.0)
    (want, wc), (got, gc) = both(models, case)
    assert got == want and gc == wc
    assert got["router"]["prefix_routed"] > 0


def test_router_constructor_errors_match(models):
    def case(side):
        errors = []
        for make in (lambda: side.Router([]),
                     lambda: side.router(0),
                     lambda: side.router(2, prefix_transfer=True),
                     lambda: side.Router([side.engine(paged=True),
                                          side.engine()],
                                         prefix_transfer=True)):
            with pytest.raises(ValueError) as err:
                make()
            errors.append(str(err.value))
        return errors
    (want, _), (got, _) = both(models, case)
    assert got == want
    assert "requires every engine to be paged" in got[2]


def test_engine_router_hooks(models):
    _, _, _, tcfg, model = models
    paged = ServeEngine(tcfg, model, paged=True, batch=2, max_len=16,
                        kv_block_size=4, device="cpu")
    lanes = ServeEngine(tcfg, model, device="cpu")
    prompt = np.arange(9, dtype=np.int32)
    assert (paged.prefix_lookup(prompt), lanes.prefix_lookup(prompt)) == (
        0, 0)
    assert paged.kv_headroom() == paged.kv.available_blocks == 8
    assert lanes.kv_headroom() == 1 << 30
    paged.submit(Request(rid=0, prompt=prompt, max_tokens=1))
    paged.run()
    assert paged.prefix_lookup(prompt) == 8
    r = Request(rid=1, prompt=prompt)
    assert (r.t_arrival, r.first_tick, r.done_tick, r.ttft_ticks) == (
        None, None, None, None)
    r.t_arrival, r.first_tick = 2.5, 6
    assert r.ttft_ticks == 3.5


def test_engines_share_the_models_tensors(models):
    """``Router.replicated`` hands every engine the one ``DecoderLM``:
    the same tensors, no weight copied; pim engines share its reference
    tree too."""
    _, _, _, tcfg, model = models
    ptrs = [p.data_ptr() for p in model.parameters()]
    for kw in (dict(paged=True), dict(paged=True, backend="pim"), {}):
        router = Router.replicated(tcfg, model, 2, batch=2, max_len=16,
                                   kv_block_size=4, device="cpu", **kw)
        a, b = router.engines
        assert a.model is b.model is model
        assert [p.data_ptr() for p in a.model.parameters()] == ptrs
        if a.params is not None:
            assert a.params is b.params
        assert a.cache is not b.cache


def test_int8_pool_router_on_the_kernel_path(models):
    """Two engines over int8 pools, every decode site on the paged
    decode kernel (K6's plain version on the CPU), against the
    reference's router over the same pools on its gather path."""
    prompts = [np.random.default_rng(20 + i).integers(
        0, 256, 5 + 3 * i, dtype=np.int32) for i in range(6)]

    def case(side):
        router = side.router(2, batch=2, max_len=32, paged=True,
                             kv_block_size=4, kv_dtype="int8",
                             attn_kernel=side.port)
        reqs = [side.Request(rid=i, prompt=p, max_tokens=4,
                             t_arrival=0.5 * i)
                for i, p in enumerate(prompts)]
        run = replay if side.port else ref_replay
        return record(run(router, reqs, slo_ticks=8.0), router, 8.0)
    (want, wc), (got, gc) = both(models, case)
    assert got == want and gc == wc


def test_pim_engines_route_as_jit_engines(models):
    """A router over two ``backend="pim"`` engines: tokens and the whole
    tick record equal to the router over two jit engines."""
    _, _, _, tcfg, model = models
    spec = WorkloadSpec(n_requests=8, vocab=256, mean_interarrival=2.0,
                        n_prefixes=2, prefix_len=8, max_tail=4, max_out=4)
    out = []
    for backend in ("jit", "pim"):
        router = Router.replicated(tcfg, model, 2, batch=2, max_len=32,
                                   paged=True, kv_block_size=4,
                                   prefix_transfer=True, prefill="batch",
                                   backend=backend, device="cpu")
        out.append(record(replay(router, generate(spec, seed=2),
                                 slo_ticks=8.0), router, 8.0))
    assert out[1] == out[0]
    assert out[0]["router"]["prefix_transferred"] == 1
