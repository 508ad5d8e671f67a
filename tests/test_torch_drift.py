"""The port's drift layer (``repro_torch.obs.drift``) on the CPU.

The reference's ``tests/test_obs.py`` drift tests (the llama3 smoke
train step run through the per-block executor, ``measure_drift``, the
paged serve engine's ``drift_report`` with its TTFT/TPOT histograms),
its ``test_kvquant.py`` dequantization errors inside the engine's report
and its ``test_expand.py`` pipeline drift, on the port's executor,
engine and GPipe drivers; and the report's clock. Measured times are the
CPU's, against the paper's modeled PIM times, so no ratio is held to a
value — only to being measured (the CPU runs far above the modeled
hardware in aggregate, as the reference's interpret mode does).
"""

import json

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as ref_configs
from repro.checkpoint.ckpt import _flatten
from repro.models.transformer import build_model
from repro_torch import mapper, obs
from repro_torch.checkpoint import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.core import quant
from repro_torch.models import lenet, transformer
from repro_torch.obs import drift
from repro_torch.parallel import pipeline as pipe
from repro_torch.serve import Request, ServeEngine


@pytest.fixture(autouse=True)
def _disabled_tracer():
    """Every test starts and ends with observability off."""
    obs.disable()
    yield
    obs.disable()


@pytest.fixture(scope="module")
def llama():
    ref_cfg = ref_configs.get_smoke_config("llama3-8b")
    params = build_model(ref_cfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("llama3-8b")
    return cfg, params_from_reference(_flatten(params), cfg, device="cpu")


def _matmul_schedule():
    def f(x, w):
        return x @ w
    meta = dict(device="meta")
    return mapper.build_schedule(f, torch.empty((8, 16), **meta),
                                 torch.empty((16, 8), **meta))


def test_llama_train_step_trace_and_drift(tmp_path, llama):
    """The reference's ``test_llama_train_step_trace_and_drift``: one SGD
    step on ``mean(apply(p, tok)**2)`` through the per-block executor
    under a scoped tracer, joined against its schedule."""
    cfg, model = llama
    params = model.stacked_params()
    tok = torch.tensor([[3, 5, 2, 9]], dtype=torch.int32)

    def train_step(params, tok):
        def loss_fn(p):
            return (transformer.apply(cfg, p, tok) ** 2).mean()
        grads, loss = torch.func.grad_and_value(loss_fn)(params)
        new = pytree.tree_map(lambda p, g: p - 1e-3 * g, params, grads)
        return new, loss

    sched = mapper.build_schedule(train_step, mapper.abstract_like(params),
                                  mapper.abstract_like(tok))
    with obs.scoped() as tr:
        mapper.ScheduleExecutor(sched, device="cpu").run(params, tok)
    report = obs.drift_report(sched, tr)
    assert report.n_measured > 0
    assert report.measured_total_s > 0 and report.modeled_total_s > 0
    assert report.ratio > 1
    assert report.by_ratio()[0].ratio > 1
    assert all(n.measured_s > 0 for n in report.by_ratio())
    assert report.clock == drift.CLOCK_HOST
    assert f"[{sched.report.tech}] drift" in report.summary()
    drift_path = tmp_path / "train.drift.json"
    report.export_json(drift_path)
    loaded = json.loads(drift_path.read_text())
    assert loaded["nodes"] and loaded["ratio"] == pytest.approx(report.ratio)
    assert loaded["clock"] == drift.CLOCK_HOST

    trace_path = tmp_path / "train.trace.json"
    tr.export_chrome(trace_path)
    lanes = obs.validate_chrome_trace(trace_path)
    assert "execute" in lanes and lanes["execute"] >= report.n_measured
    # every node launch span nests under the depth-0 run span
    run, = tr.spans(lane="execute", name="run:schedule")
    for s in tr.spans(lane="execute"):
        assert run.t0_s <= s.t0_s and s.t1_s <= run.t1_s + 1e-9


def test_measure_drift_one_shot():
    sched = _matmul_schedule()
    report = obs.measure_drift(sched, torch.ones(8, 16), torch.ones(16, 8),
                               device="cpu")
    assert report.n_measured == 1 and len(report.nodes) == 1
    assert report.nodes[0].kind == "matmul" and report.nodes[0].launches == 1
    assert not obs.is_enabled()       # scoped tracer was restored


def test_drift_report_requires_spans():
    with pytest.raises(ValueError, match="no execute-lane spans"):
        obs.drift_report(_matmul_schedule(), obs.Tracer())


def test_compiled_program_report_and_the_clock_it_read():
    """A compiled program's call is one run span, its grouped launch one
    node span; on the CPU neither waits for a device, and the report says
    it read the host's clock. Spans that waited for the card (``sync``)
    make it say so."""
    sched = _matmul_schedule()
    prog = mapper.compile_schedule(sched, use_cache=False, device="cpu")
    with obs.scoped() as tr:
        prog(torch.ones(8, 16), torch.ones(16, 8))
    report = obs.drift_report(sched, tr)
    call, = tr.spans(lane="execute", name="program:call")
    assert report.measured_total_s == call.dur_s
    assert report.n_measured == 1 and report.clock == drift.CLOCK_HOST
    assert [s.args["sync"] for s in tr.spans(lane="execute")] == [False] * 2
    synced = obs.Tracer()
    with synced.span("program:call", lane="execute", sync=True):
        with synced.span("matmul:mm.0", lane="execute", node=0, sync=True):
            pass
    assert obs.drift_report(sched, synced).clock == drift.CLOCK_SYNCED
    assert "synced to the device" in obs.drift_report(sched,
                                                      synced).summary()


def test_paged_serve_trace_drift_and_latency_histograms(tmp_path, llama):
    """The reference's ``test_paged_serve_trace_drift_and_latency_
    histograms`` on the port's pim engine."""
    cfg, model = llama
    rng = np.random.default_rng(0)
    obs.metrics().reset()
    eng = ServeEngine(cfg, model, batch=2, max_len=32, paged=True,
                      kv_block_size=4, backend="pim", device="cpu")
    for i in range(3):
        prompt = rng.integers(0, cfg.vocab_size, 3 + i, dtype=np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_tokens=3))
    with obs.scoped() as tr:
        done = eng.run()
    assert len(done) == 3

    trace_path = tmp_path / "serve.trace.json"
    tr.export_chrome(trace_path)
    lanes = obs.validate_chrome_trace(trace_path)
    assert "serve" in lanes and "execute" in lanes
    ticks = tr.spans(lane="serve", name="decode:tick")
    assert len(ticks) == eng._tick > 0
    assert len(tr.spans(lane="execute", name="program:call")) == eng._tick
    admits = [e for e in tr.events if e.kind == "instant"
              and e.name == "admit"]
    assert len(admits) == 3

    # the engine's report joins the program:call spans against the pim
    # schedule's modeled tick, KV traffic included
    report = eng.drift_report(tr)
    assert report.measured_total_s > 0 and len(report.nodes) > 0
    assert report.ratio > 1
    assert report.kv_modeled_s == eng.schedule.kv.t_s > 0
    assert report.modeled_total_s == eng.schedule.report.latency_s

    # per-node ratios from one per-block executor run of the same
    # schedule, on a copy of the pool (the tick writes it in place)
    pool = {k: v.clone() for k, v in eng.cache.items()}
    node_report = obs.measure_drift(
        eng.schedule, eng.params, {"layers": {"block0": pool}},
        torch.zeros(eng.batch, dtype=torch.int32), eng.kv.device_table(),
        torch.from_numpy(eng._pos), device="cpu")
    assert node_report.n_measured > 0
    assert node_report.ratio > 1
    assert node_report.by_ratio()[0].ratio > 1

    snap = obs.metrics().snapshot()
    assert snap["counters"]["serve.submitted"] == 3
    assert snap["counters"]["serve.completed"] == 3
    assert snap["histograms"]["serve.ttft_s"]["count"] == 3
    assert snap["histograms"]["serve.tpot_s"]["count"] == 3
    for r in done:
        assert r.ttft_s is not None and r.ttft_s > 0
        assert r.tpot_s is not None and r.tpot_s > 0
    metrics_path = tmp_path / "serve.metrics.json"
    obs.metrics().export_json(metrics_path)
    assert json.loads(metrics_path.read_text())["counters"]


def test_drift_report_requires_pim_backend(llama):
    cfg, model = llama
    eng = ServeEngine(cfg, model, batch=2, max_len=32, paged=True,
                      kv_block_size=4, device="cpu")
    with pytest.raises(ValueError, match="backend='pim'"):
        eng.drift_report()


def test_kv_dequant_errors_within_budget_and_in_drift_report(llama):
    """The reference's ``test_kvquant.py``
    ``test_kv_dequant_errors_within_budget_and_in_drift_report``: a pim
    engine over an fp8_e4m3 pool measured against a golden fp32 twin; the
    errors ride in its drift report."""
    cfg, model = llama
    obs.metrics().reset()
    prompts = ([1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1])

    def engine(**kw):
        return ServeEngine(cfg, model, batch=2, max_len=32, paged=True,
                           kv_block_size=8, kv_blocks=24, device="cpu",
                           **kw)

    def run(eng):
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=np.asarray(p, np.int32),
                               max_tokens=1))
        return eng.run()

    golden = engine()
    quantized = engine(kv_dtype="fp8_e4m3", backend="pim")
    run(golden)
    with obs.scoped() as tr:
        run(quantized)
        errs = quantized.kv_dequant_errors(golden)
        rep = quantized.drift_report(tr)
    assert errs.shape == (cfg.n_layers,)
    assert float(errs.max()) <= quant.layer_error_budget("fp8_e4m3")
    assert rep.kv_dequant_error is not None
    assert rep.kv_dequant_error["count"] == len(errs)
    assert rep.to_dict()["kv_dequant_error"]["count"] == len(errs)


def _images(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 28, 28, 1)).astype(np.float32))


def test_pipeline_drift_joins_the_drivers_spans():
    """The reference's ``test_expand.py``
    ``test_pipeline_drift_joins_async_spans``: LeNet-5 cut in 4, 4
    microbatches through the asynchronous driver. On the CPU there are no
    streams — the driver is the synchronous one, every cell a span on the
    ``pipeline`` lane and no hand-off onto a stream (``transfers`` 0)."""
    params = lenet.init_lenet(0, device="cpu")
    sched = mapper.map_lenet("serve", partitions=4)
    prog = mapper.compile_partitioned(sched, use_cache=False, device="cpu")
    n_micro = 4
    mbs = [prog.flatten_args(params, _images(4, m)) for m in range(n_micro)]
    with obs.scoped() as tr:
        pipe.run_partitioned_async(prog.stages, prog.out_refs, mbs)
    timeline = sched.pipeline(n_micro)
    rep = obs.pipeline_drift(timeline, tr)
    assert rep.microbatches == n_micro
    assert len(rep.stages) == 4
    assert all(s.cells == n_micro for s in rep.stages)
    assert all(s.measured_s > 0 for s in rep.stages)
    assert rep.transfers == 0 and rep.clock == drift.CLOCK_HOST
    assert rep.measured_interval_s > 0 and rep.ratio > 0
    assert rep.modeled_interval_s == timeline.interval_s
    assert "pipeline drift" in rep.summary()
    assert rep.to_dict()["stages"][0]["cells"] == n_micro


def test_pipeline_drift_counts_forward_and_backward_cells():
    """Under ``gpipe_value_and_grad`` every stage runs a forward and a
    backward cell a microbatch: the drift counts both."""
    params = lenet.init_lenet(0, device="cpu")
    meta = dict(device="meta")
    sched = mapper.build_schedule(
        lenet.lenet_loss, mapper.abstract_like(
            lenet.init_lenet(0, device="meta")),
        torch.empty((2, 28, 28, 1), **meta),
        torch.empty((2,), dtype=torch.int32, **meta), partitions=2)
    prog = mapper.compile_partitioned(sched, use_cache=False, device="cpu")
    labels = torch.tensor([1, 7], dtype=torch.int32)
    flat = [prog.flatten_args(params, _images(2, m), labels)
            for m in range(3)]
    leaves = pytree.tree_leaves(params)
    with obs.scoped() as tr:
        pipe.gpipe_value_and_grad(prog.stages, prog.out_refs[0], flat,
                                  list(range(len(leaves))))
    rep = obs.pipeline_drift(sched.pipeline(3), tr)
    assert [s.cells for s in rep.stages] == [6, 6]


def test_pipeline_drift_requires_spans():
    sched = mapper.map_lenet("serve", partitions=2)
    with obs.scoped() as tr:
        pass
    with pytest.raises(ValueError, match="no pipeline-lane"):
        obs.pipeline_drift(sched.pipeline(4), tr)


def test_partitioned_pim_engine_decodes_through_stage_programs(llama):
    """A partitioned pim engine's ticks run its stage programs: the
    execute lane holds one call span a tick, and the modeled timeline
    is the schedule's."""
    cfg, model = llama
    eng = ServeEngine(cfg, model, batch=2, max_len=16, paged=True,
                      kv_block_size=4, backend="pim", partitions=2,
                      expand_scans=True, attn_kernel=True, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                       max_tokens=2))
    with obs.scoped() as tr:
        eng.run()
    calls = tr.spans(lane="execute", name="program:call")
    assert len(calls) == eng._tick and all(
        c.args["partitions"] == 2 for c in calls)
    assert eng.pipeline_timeline.interval_s == eng.schedule.pipeline(
        8).interval_s
    assert eng.drift_report(tr).n_measured > 0
