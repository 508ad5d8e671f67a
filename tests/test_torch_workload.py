"""``repro_torch.serve.workload`` against ``repro.serve.workload``: the
seeded traces, ``WorkloadSpec``'s checks, ``TrafficReport``'s accounting
and the virtual-clock ``replay`` over the llama3-8b smoke config, the
reference's parameters carried across by the bridge.

A trace must be the reference's to the bit: the same prompts (dtype and
values), ``max_tokens``, ``eos`` and ``t_arrival`` (compared as floats,
not within a tolerance), Poisson and bursty, with and without the bursty
process's silent OFF phase. A replay must stamp every request's first
and last tick as the reference's does, and its report's tick fields must
be equal. The control: two requests' arrivals swapped must break the
trace comparison.
"""

import math

import jax
import numpy as np
import pytest

from repro import configs
from repro.checkpoint.ckpt import _flatten
from repro.models.transformer import build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import TrafficReport as RefReport
from repro.serve import WorkloadSpec as RefSpec
from repro.serve import generate as ref_generate
from repro.serve import replay as ref_replay
from repro.serve import workload as ref_workload
from repro_torch import obs
from repro_torch.checkpoint import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.serve import (Request, ServeEngine, TrafficReport,
                               WorkloadSpec, generate, replay, workload)

# the summary's wall-clock fields: host time, never compared
WALL = ("wall_s", "tokens_per_s", "goodput_per_s")


@pytest.fixture(scope="module")
def models():
    cfg = configs.get_smoke_config("llama3-8b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("llama3-8b")
    return cfg, params, tcfg, params_from_reference(_flatten(params), tcfg,
                                                    device="cpu")


def trace_fields(reqs) -> list:
    """Everything ``generate`` decides, request by request, with each
    float as its exact bits."""
    return [(r.rid, r.prompt.dtype.str, r.prompt.tobytes(), r.max_tokens,
             r.eos, float(r.t_arrival).hex(), r.priority) for r in reqs]


def record(report, target, slo: float) -> dict:
    """What a replay decided, wall clock left out: each request's engine,
    tokens and tick stamps; the report's tick fields and summary; the
    target's preemptions, resumes, skipped prefix tokens, KV byte
    counters, ticks, allocator stats and (a router's) dispatch counts."""
    engines = getattr(target, "engines", [target])
    where = {r.rid: i for i, e in enumerate(engines) for r in e.completed}
    summary = report.summary(slo)
    return dict(
        requests=[(r.rid, where.get(r.rid), [int(t) for t in r.out],
                   r.done, r.first_tick, r.done_tick, r.ttft_ticks,
                   r.preemptions) for r in report.requests],
        ticks=report.ticks, idle_ticks=report.idle_ticks,
        starved=list(report.starved),
        summary={k: v for k, v in summary.items() if k not in WALL},
        e2e=[float(x) for x in report.e2e_ticks()],
        preemptions=target.preemptions,
        resumes=sum(e.resumes for e in engines),
        prefix_skipped_tokens=target.prefix_skipped_tokens,
        kv_bytes=(target.kv_bytes_read, target.kv_bytes_written),
        engine_ticks=[e._tick for e in engines],
        kv_stats=[dict(e.kv.stats) if e.paged else None for e in engines],
        router=getattr(target, "stats", None))


def _spec(**kw):
    # the reference's test_serve_traffic.py _spec
    base = dict(n_requests=16, vocab=64, mean_interarrival=2.0,
                n_prefixes=3, prefix_len=8, max_tail=6, max_out=6)
    base.update(kw)
    return base


SPECS = {
    "poisson": _spec(arrival="poisson"),
    "bursty": _spec(arrival="bursty"),
    # duty x factor >= 1: the OFF phase goes silent
    "silent_off": _spec(arrival="bursty", burst_factor=4.0,
                        burst_fraction=0.3),
    "long_run": _spec(n_requests=400, arrival="bursty", burst_factor=6.0,
                      burst_fraction=0.1),
    "eos": _spec(arrival="poisson", eos=3, zipf_a=2.0, n_prefixes=1),
    # the chip script's router phase: llama3-8b's vocabulary, 8-block
    # system prompts
    "router_phase": dict(n_requests=32, vocab=128256, arrival="bursty",
                         mean_interarrival=1.0, burst_factor=6.0,
                         burst_fraction=0.25, burst_mean_len=12.0,
                         n_prefixes=4, zipf_a=1.2, prefix_len=128,
                         tail_len_mean=32, tail_len_sigma=0.8, max_tail=128,
                         out_mean=16, out_sigma=0.8, max_out=64, eos=None),
}


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("name", list(SPECS))
def test_traces_equal_the_reference_to_the_bit(name, seed):
    want = ref_generate(RefSpec(**SPECS[name]), seed=seed)
    got = generate(WorkloadSpec(**SPECS[name]), seed=seed)
    assert trace_fields(got) == trace_fields(want)
    assert all(isinstance(r, Request) for r in got)
    assert [r.t_arrival for r in got] == sorted(r.t_arrival for r in got)


def test_silent_off_phase_is_taken():
    """The silent OFF case really jumps to the next burst: arrivals come
    only in ON phases, so some gap (an OFF phase, 28 ticks on average
    here) is far above the ON phases' mean gap."""
    spec = WorkloadSpec(**dict(SPECS["silent_off"], n_requests=200))
    times = [r.t_arrival for r in generate(spec, seed=0)]
    on_gap = spec.mean_interarrival / spec.burst_factor
    assert all(math.isfinite(t) for t in times)
    assert max(np.diff(times)) > 10 * on_gap


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_arrival_times_and_lengths_draw_as_the_reference(arrival):
    spec = _spec(arrival=arrival, n_requests=64)
    want = ref_workload._arrival_times(RefSpec(**spec),
                                       np.random.default_rng(5))
    got = workload._arrival_times(WorkloadSpec(**spec),
                                  np.random.default_rng(5))
    assert [float(t).hex() for t in got] == [float(t).hex() for t in want]
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    assert ([workload._lognormal_len(a, 6.0, 0.8, 16) for _ in range(200)]
            == [ref_workload._lognormal_len(b, 6.0, 0.8, 16)
                for _ in range(200)])


def test_swapped_arrivals_break_the_comparison():
    """Control: the comparison sees two requests' arrivals swapped."""
    spec = SPECS["bursty"]
    want = trace_fields(ref_generate(RefSpec(**spec), seed=0))
    got = generate(WorkloadSpec(**spec), seed=0)
    got[2].t_arrival, got[5].t_arrival = got[5].t_arrival, got[2].t_arrival
    assert trace_fields(got) != want


@pytest.mark.parametrize("bad", [
    dict(arrival="uniform"), dict(burst_fraction=1.5),
    dict(burst_fraction=0.0), dict(n_requests=0), dict(n_prefixes=0),
    dict(mean_interarrival=0.0), dict(burst_factor=0.5)])
def test_spec_errors_match_the_reference(bad):
    with pytest.raises(ValueError) as want:
        RefSpec(**_spec(**bad))
    with pytest.raises(ValueError) as got:
        WorkloadSpec(**_spec(**bad))
    assert str(got.value) == str(want.value)


def test_spec_defaults_and_frozen():
    import dataclasses
    assert dataclasses.asdict(WorkloadSpec()) == dataclasses.asdict(
        RefSpec())
    with pytest.raises(dataclasses.FrozenInstanceError):
        WorkloadSpec().n_requests = 3


def _report_requests(request_cls):
    def req(rid, arrival, first, done_tick, n_out):
        r = request_cls(rid=rid, prompt=np.arange(3, dtype=np.int32),
                        max_tokens=n_out, t_arrival=arrival)
        r.first_tick, r.done_tick = first, done_tick
        r.out = list(range(n_out))
        r.done = True
        return r
    return [req(0, 0.0, 4, 10, 5),       # ttft 4  <= slo
            req(1, 2.0, 20, 30, 7),      # ttft 18 > slo
            req(2, 5.0, 12, 14, 3),      # ttft 7  <= slo
            req(3, 1.5, 9, 25, 2)]       # ttft 7.5 <= slo


@pytest.mark.parametrize("slo", [5.0, 7.5, 10.0, 100.0])
def test_goodput_counts_only_slo_met(slo):
    """The reference's pure-accounting case, and every property of the
    report against the reference's on the same stamps."""
    kw = dict(ticks=30, idle_ticks=2, wall_s=1.5, starved=[])
    want = RefReport(requests=_report_requests(RefRequest), **kw)
    got = TrafficReport(requests=_report_requests(Request), **kw)
    assert got.summary(slo) == want.summary(slo)
    assert got.ttft_ticks().tolist() == want.ttft_ticks().tolist()
    assert got.e2e_ticks().tolist() == want.e2e_ticks().tolist()
    assert got.generated_tokens == 17
    assert got.goodput_tokens(10.0) == 10
    assert got.goodput_per_tick(10.0) == pytest.approx(10 / 32)


def test_empty_report_matches_the_reference():
    kw = dict(ticks=0, idle_ticks=0, wall_s=0.0, starved=[4])
    want = RefReport(requests=[], **kw).summary(8.0)
    got = TrafficReport(requests=[], **kw).summary(8.0)
    assert set(got) == set(want)
    for key in want:
        assert (got[key] == want[key]
                or (math.isnan(got[key]) and math.isnan(want[key]))), key


def _paged(engine_cls, cfg, params, **kw):
    device = {"device": "cpu"} if engine_cls is ServeEngine else {}
    return engine_cls(cfg, params, batch=1, max_len=32, paged=True,
                      kv_block_size=4, **kw, **device)


def _both(models, reqs_of, slo=64.0, **kw):
    cfg, params, tcfg, model = models
    ref_eng = _paged(RefEngine, cfg, params, **kw)
    eng = _paged(ServeEngine, tcfg, model, **kw)
    want = ref_replay(ref_eng, reqs_of(RefRequest), slo_ticks=slo)
    got = replay(eng, reqs_of(Request), slo_ticks=slo)
    return (record(got, eng, slo), got), (record(want, ref_eng, slo), want)


def test_replay_measures_ttft_from_arrival(models):
    """The reference's case: a late request's TTFT clock starts at its
    arrival, and its queue wait behind a batch of one is real TTFT."""
    def reqs(cls):
        return [cls(rid=0, prompt=np.arange(4, dtype=np.int32),
                    max_tokens=10, t_arrival=0.5),
                cls(rid=1, prompt=np.arange(5, dtype=np.int32),
                    max_tokens=2, t_arrival=2.0)]
    (got, rep), (want, _) = _both(models, reqs)
    assert got == want
    r0, r1 = rep.requests
    assert r1.first_tick > r0.done_tick
    assert r1.ttft_ticks == r1.first_tick - 2.0
    assert rep.generated_tokens == 12


def test_replay_idle_fast_forward(models):
    def reqs(cls):
        return [cls(rid=0, prompt=np.arange(4, dtype=np.int32),
                    max_tokens=2, t_arrival=25.0),
                cls(rid=1, prompt=np.arange(6, dtype=np.int32),
                    max_tokens=3, t_arrival=60.5)]
    (got, rep), (want, _) = _both(models, reqs, slo=16.0)
    assert got == want
    assert rep.idle_ticks >= 24 + 30       # the clock jumped twice
    assert rep.requests[0].ttft_ticks < 10


def test_replay_rejects_driven_requests(models):
    cfg, params, tcfg, model = models
    for engine_cls, request_cls, cfg_, params_, run in (
            (RefEngine, RefRequest, cfg, params, ref_replay),
            (ServeEngine, Request, tcfg, model, replay)):
        reqs = [request_cls(rid=0, prompt=np.arange(4, dtype=np.int32),
                            max_tokens=2, t_arrival=0.0)]
        run(_paged(engine_cls, cfg_, params_), reqs)
        with pytest.raises(ValueError, match="fresh") as err:
            run(_paged(engine_cls, cfg_, params_), reqs)
        assert str(err.value) == ("request rid=0 was already driven; "
                                  "replay needs fresh Request objects")


def test_replay_starvation_and_its_option(models):
    """A budget too small leaves requests pending: ``on_starvation=
    "return"`` reports them, ``"raise"`` raises the reference's message,
    anything else is refused."""
    cfg, params, tcfg, model = models

    def reqs(cls):
        return [cls(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                    max_tokens=4, t_arrival=float(i)) for i in range(3)]
    outs = []
    for engine_cls, request_cls, cfg_, params_, run in (
            (RefEngine, RefRequest, cfg, params, ref_replay),
            (ServeEngine, Request, tcfg, model, replay)):
        eng = _paged(engine_cls, cfg_, params_)
        rep = run(eng, reqs(request_cls), max_ticks=6,
                  on_starvation="return")
        with pytest.raises(RuntimeError) as err:
            run(_paged(engine_cls, cfg_, params_), reqs(request_cls),
                max_ticks=6)
        with pytest.raises(ValueError, match="on_starvation") as bad:
            run(eng, [], on_starvation="drop")
        outs.append((record(rep, eng, 8.0), str(err.value), str(bad.value)))
    assert outs[0] == outs[1]
    assert outs[1][0]["starved"]


def test_replay_records_the_tick_histograms(models):
    """With ``slo_ticks``, TTFT and end-to-end ticks go to the
    ``serve.ttft_ticks`` / ``serve.e2e_ticks`` histograms (``TICK_EDGES``)
    and each request's tokens to ``serve.goodput_tokens`` or
    ``serve.late_tokens``."""
    from repro_torch.obs.metrics import TICK_EDGES

    def reqs(cls):
        return [cls(rid=i, prompt=np.arange(4 + i, dtype=np.int32),
                    max_tokens=3, t_arrival=0.25 * i) for i in range(4)]
    obs.metrics().reset()
    (got, rep), (want, _) = _both(models, reqs, slo=6.0)
    assert got == want
    snap = obs.metrics().snapshot()
    on_time = sum(len(r.out) for r in rep.requests if r.ttft_ticks <= 6.0)
    assert snap["counters"]["serve.goodput_tokens"] == on_time
    assert snap["counters"]["serve.late_tokens"] == 12 - on_time
    assert on_time and on_time < 12
    ttft = obs.metrics().histogram("serve.ttft_ticks", TICK_EDGES)
    assert ttft.count == 4 and ttft.edges == tuple(TICK_EDGES)
    assert obs.metrics().histogram("serve.e2e_ticks", TICK_EDGES).count == 4
