"""The port's ``ServeEngine(backend="pim")`` against the reference.

Planning: ``serve.map_paged_tick`` (the schedule the pim engine decodes
through) against the reference's ``ServeEngine._build_pim`` steps —
``mapper.build_schedule`` on ``DecoderLM.decode_step_paged``, then
``place_kv`` and ``attach_kv`` — on the llama3 smoke config (batch 2, a
16-token ``max_len``, blocks of 4) over an fp32, int8 and fp8_e4m3 pool,
the kernel path and the gather path, fp32 and int8 weight grids: the
operator graph node by node (the reference's ``dot_general.N`` named
``mm.N``), the placement, every ``KVPlacement`` field and page, every
``KVTraffic`` field with its links' busy times, the report after
``attach_kv``, the stages, ``reconcile()`` and ``pipeline(4)``; then the
published config at batch 8 and a 2048-token ``max_len`` (traced on meta
tensors), the pool the reference refuses there (one fp32 block of 16
tokens exceeds a subarray), and the partitioned, expanded tick at 2 and 4
partitions. Every number of those rows is also checked against the
reference's own run.

Serving: the port's pim engine gives tokens identical to its jit engine
and to the reference's jit ``ServeEngine`` (recycled slots, batched
prefill, preemption, prefix sharing, int8 and fp8_e4m3 pools, partitions
2 and 4); on an int8 weight grid, identical to the jit engine over the LM
head the grid stores (``mapper.executor.fake_quant_stationary``). The
reference's compiled programs cannot run under jax 0.9.0 (``jax.util``),
so its jit engine is the oracle; its planning of a partitioned tick needs
PR 23's ``_shims`` (``tests/test_torch_partition.py``).
"""

import copy
import dataclasses
import functools

import jax
import jax._src.core as jax_core
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import mapper as ref_mapper
from repro.checkpoint.ckpt import _flatten
from repro.models.transformer import build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import kv as ref_kv
from repro_torch import mapper
from repro_torch.checkpoint import params_from_reference
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import (
    paged_decode_attention_grouped, paged_decode_attention_grouped_q)
from repro_torch.mapper.executor import fake_quant_stationary
from repro_torch.serve import Request, ServeEngine, map_paged_tick


@pytest.fixture(scope="module", autouse=True)
def _shims():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.core, "Literal", jax.extend.core.Literal, raising=False)
    mp.setattr(jax.core, "DropVar", jax_core.DropVar, raising=False)
    mp.setattr(jax.core, "jaxpr_as_fun", jax_core.jaxpr_as_fun,
               raising=False)
    yield
    mp.undo()


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


def _ref_plan(*, full, batch, max_len, bs, kernel, kv_dtype,
              weight_dtype="fp32", partitions=None, expand=False):
    """The reference's ``ServeEngine._build_pim`` planning on
    ShapeDtypeStructs (its engine needs real parameters)."""
    cfg = (ref_configs.get_config if full
           else ref_configs.get_smoke_config)("llama3-8b")
    model = build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    w = -(-max_len // bs)
    nb = 1 + batch * w
    cache = jax.eval_shape(lambda: model.init_paged_cache(
        nb, bs, kv_dtype=kv_dtype))
    step = functools.partial(model.decode_step_paged, kernel=kernel,
                             kv_dtype=kv_dtype)
    ints = [jax.ShapeDtypeStruct(s, jnp.int32)
            for s in ((batch,), (batch, w), (batch,))]
    sched = ref_mapper.build_schedule(step, params, cache, *ints,
                                      weight_dtype=weight_dtype,
                                      partitions=partitions,
                                      expand_scans=expand)
    spec = ref_mapper.KVBlockSpec(
        sites=cfg.n_layers, num_blocks=nb, block_size=bs,
        token_bits=ref_kv.kv_token_bits(cfg.n_kv_heads,
                                        cfg.resolved_head_dim, kv_dtype))
    sched.attach_kv(ref_mapper.place_kv(sched.graph, sched.placement, spec),
                    resident_tokens=max(1, max_len // 2), batch=batch)
    return sched


def _plans(*, full=False, batch=2, max_len=16, bs=4, kernel, kv_dtype,
           weight_dtype="fp32", partitions=None, expand=False):
    cfg = (get_config if full else get_smoke_config)("llama3-8b")
    port = map_paged_tick(cfg, batch=batch, max_len=max_len,
                          kv_block_size=bs, attn_kernel=kernel,
                          kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                          partitions=partitions or 1, expand_scans=expand)
    ref = _ref_plan(full=full, batch=batch, max_len=max_len, bs=bs,
                    kernel=kernel, kv_dtype=kv_dtype,
                    weight_dtype=weight_dtype, partitions=partitions,
                    expand=expand)
    return ref, port


def _node_row(nd):
    return (nd.name.replace("dot_general", "mm"), nd.kind,
            tuple(nd.out_shape), nd.macs, nd.adds, nd.muls, nd.weight_shape,
            tuple(nd.deps), nd.repeat, nd.out_elems)


def _kv_fields(kvp):
    spec = kvp.spec
    pages = [(kvp.block_home(s, b), kvp.block_coords(s, b))
             for s in range(spec.sites) for b in range(spec.num_blocks)]
    return (dataclasses.astuple(spec), kvp.site_first,
            kvp.blocks_per_subarray, kvp.site_consumer, kvp.n_subarrays,
            [kvp.consumer_home(s) for s in range(spec.sites)], pages)


def _traffic(sched):
    kv = sched.kv
    return (dataclasses.astuple(kv), kv.link_busy)


def _assert_plans_equal(ref, port):
    assert [_node_row(nd) for nd in port.graph.nodes] == [
        _node_row(nd) for nd in ref.graph.nodes]
    rp, pp = ref.placement, port.placement
    assert (pp.n_subarrays, pp.n_tiles, pp.n_chips, pp.curve) == (
        rp.n_subarrays, rp.n_tiles, rp.n_chips, rp.curve)
    assert {i: dataclasses.astuple(n) for i, n in
            pp.node_placements.items()} == {
        i: dataclasses.astuple(n) for i, n in rp.node_placements.items()}
    assert _kv_fields(port.kv_placement) == _kv_fields(ref.kv_placement)
    assert port.kv_placement is not None and port.kv.t_s > 0
    assert _traffic(port) == _traffic(ref)
    assert dataclasses.astuple(port.report) == dataclasses.astuple(
        ref.report)
    for s_port, s_ref in zip(port.stages, ref.stages, strict=True):
        got = dataclasses.replace(s_port, name=s_ref.name)
        assert dataclasses.astuple(got) == dataclasses.astuple(s_ref)
    got = port.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"]
    assert got == ref.reconcile()
    assert dataclasses.astuple(port.pipeline(4)) == dataclasses.astuple(
        ref.pipeline(4))


# (attn_kernel, pool, weights) -> (nodes, weight subarrays); the KV pool
# takes 2 subarrays at every row
SMOKE_ROWS = {
    (False, "fp32", "fp32"): (54, 23), (False, "fp32", "int8"): (54, 20),
    (True, "fp32", "fp32"): (47, 23), (True, "fp32", "int8"): (47, 22),
    (False, "int8", "fp32"): (66, 23), (True, "int8", "fp32"): (55, 23),
    (False, "fp8_e4m3", "fp32"): (78, 23),
    (True, "fp8_e4m3", "fp32"): (63, 23),
}


@pytest.mark.parametrize("kernel,pool,weights", list(SMOKE_ROWS))
def test_smoke_planning_equals_reference(kernel, pool, weights):
    ref, port = _plans(kernel=kernel, kv_dtype=pool, weight_dtype=weights)
    _assert_plans_equal(ref, port)
    nodes, subarrays = SMOKE_ROWS[(kernel, pool, weights)]
    assert len(port.graph.nodes) == nodes
    assert port.placement.n_subarrays == subarrays
    assert port.kv_placement.n_subarrays == 2
    # the layer stack folds into repeat 2; pages follow the weights
    assert [nd.repeat for nd in port.graph.nodes] == [2] * (nodes - 5) + [
        1] * 5
    assert min(port.kv_placement.site_first) >= port.placement.n_subarrays
    if pool == "fp32":
        assert port.kv.read_bits == 65_536
        assert port.kv.t_s == pytest.approx(1.56e-7, rel=1e-12)


def test_kernel_path_hides_the_attention_products():
    """With ``attn_kernel`` each site's two attention products lie inside
    K4's op, which the graph does not enter (47 nodes against 54)."""
    _, gather = _plans(kernel=False, kv_dtype="fp32")
    _, kern = _plans(kernel=True, kv_dtype="fp32")
    bmm = [nd for nd in gather.graph.nodes
           if nd.kind == "matmul" and nd.out_shape[-1] in (1, 2)]
    assert len(gather.graph.nodes) - len(kern.graph.nodes) == 7
    assert len(bmm) == 2 and all(nd.repeat == 2 for nd in bmm)
    assert sum(nd.kind == "matmul" for nd in kern.graph.nodes) == 8


# (attn_kernel, pool, block size, weights) -> (nodes, weight subarrays,
# KV subarrays, kv.read_bits, kv.t_s to 5 digits)
FULL_ROWS = {
    (False, "fp32", 8, "fp32"): (54, 28_200, 65_568, 17_179_869_184,
                                 0.06734),
    (True, "fp32", 8, "fp32"): (47, 28_168, 65_568, 17_179_869_184,
                                0.06733),
    (True, "fp32", 8, "int8"): (47, 26_276, 65_568, 17_179_869_184,
                                0.06729),
    (True, "int8", 16, "fp32"): (55, 28_168, 10_944, 4_429_185_024,
                                 0.017381),
}


@pytest.mark.parametrize("kernel,pool,bs,weights", list(FULL_ROWS))
def test_full_width_planning_equals_reference(kernel, pool, bs, weights):
    """The published config (32 layers, 4096 wide, a 128,256 vocab) at
    batch 8 and a 2048-token ``max_len``, traced on meta tensors."""
    ref, port = _plans(full=True, batch=8, max_len=2048, bs=bs,
                       kernel=kernel, kv_dtype=pool, weight_dtype=weights)
    _assert_plans_equal(ref, port)
    nodes, subarrays, kv_subs, read_bits, t_s = FULL_ROWS[
        (kernel, pool, bs, weights)]
    assert len(port.graph.nodes) == nodes
    assert port.placement.n_subarrays == subarrays
    assert port.kv_placement.n_subarrays == kv_subs
    assert port.kv.read_bits == read_bits
    assert port.kv.t_s == pytest.approx(t_s, rel=1e-4)


def test_full_width_fp32_pool_at_block_16_refused_as_reference():
    """An unquantized token is priced at 32 bits a value whatever the
    model dtype: at llama3-8b's width one 16-token block (1,048,576 bits)
    exceeds a subarray (943,104), and both sides refuse it."""
    cfg = get_config("llama3-8b")
    match = r"one KV block \(1048576 bits\) exceeds a subarray's " \
            r"capacity \(943104 bits\)"
    with pytest.raises(ValueError, match=match):
        map_paged_tick(cfg, batch=8, max_len=2048, kv_block_size=16,
                       attn_kernel=True)
    with pytest.raises(ValueError, match=match):
        _ref_plan(full=True, batch=8, max_len=2048, bs=16, kernel=True,
                  kv_dtype="fp32")


@pytest.mark.parametrize("k,sizes,speedup", [
    (2, [42, 47], 1.6511), (4, [40, 2, 40, 7], 2.1468)])
def test_partitioned_tick_equals_reference(k, sizes, speedup):
    """The tick cut into ``k`` partitions after the smoke stack's
    expansion (89 nodes): the cuts, the bits crossing them, the KV pages
    and traffic, and the modeled 8-microbatch timeline."""
    ref, port = _plans(kernel=True, kv_dtype="fp32", partitions=k,
                       expand=True)
    _assert_plans_equal(ref, port)
    rows = [(p.nodes, p.macs, p.adds, p.muls, p.in_bits, p.out_bits)
            for p in port.partitions]
    assert rows == [(p.nodes, p.macs, p.adds, p.muls, p.in_bits, p.out_bits)
                    for p in ref.partitions]
    assert len(port.graph.nodes) == 89
    assert [len(p.nodes) for p in port.partitions] == sizes
    got, want = port.pipeline(8), ref.pipeline(8)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.speedup == pytest.approx(speedup, abs=1e-4)


def test_attach_kv_prices_once_and_joins_link_contention():
    _, port = _plans(kernel=True, kv_dtype="fp32")
    with pytest.raises(ValueError, match="already attached"):
        port.attach_kv(port.kv_placement, resident_tokens=8, batch=2)
    busy = max(port.kv.link_busy.values())
    assert busy > 0
    assert port.pipeline(4).link_busy_s >= busy


# ---------------------------------------------------------------------------
# serving: the pim engine against the jit engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    cfg = ref_configs.get_smoke_config("llama3-8b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("llama3-8b")
    return cfg, params, tcfg, params_from_reference(_flatten(params), tcfg,
                                                    device="cpu")


def _prompts(seed, lengths, vocab, shared_prefix=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, shared_prefix, dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, n, dtype=np.int32)])
            for n in lengths]


def _drive(engine, request_cls, prompts, max_tokens):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_tokens=max_tokens))
    return {r.rid: r.out for r in engine.run()}


def _port(models, prompts, max_tokens, model=None, **opts):
    _, _, tcfg, port_model = models
    eng = ServeEngine(tcfg, model or port_model, paged=True, device="cpu",
                      **opts)
    return eng, _drive(eng, Request, prompts, max_tokens)


def _ref(models, prompts, max_tokens, **opts):
    cfg, params, _, _ = models
    eng = RefEngine(cfg, params, paged=True, **opts)
    return eng, _drive(eng, RefRequest, prompts, max_tokens)


# name -> (engine options, prompt lengths, shared prefix, max_tokens)
SCENARIOS = {
    # 5 requests through 2 slots: recycled slots restart at position 0
    "recycled": (dict(batch=2, max_len=32, kv_block_size=4),
                 (3, 4, 5, 6, 7), 0, 4),
    # a 6-block pool for 3 requests: swap-out and token-identical resume
    "preempt": (dict(batch=2, max_len=16, kv_block_size=4, kv_blocks=6),
                (5, 6, 7), 0, 6),
    # one slot, prompts sharing 12 tokens: cached prefix blocks attached
    "prefix": (dict(batch=1, max_len=32, kv_block_size=4),
               (2, 5), 12, 3),
}


@pytest.mark.parametrize("attn_kernel", [False, True])
@pytest.mark.parametrize("prefill", ["replay", "batch"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_pim_engine_matches_jit_and_reference(models, scenario, prefill,
                                              attn_kernel):
    opts, lengths, shared, max_tokens = SCENARIOS[scenario]
    prompts = _prompts(len(lengths) + shared, lengths,
                       models[0].vocab_size, shared)
    opts = dict(opts, prefill=prefill, attn_kernel=attn_kernel)
    eng, got = _port(models, prompts, max_tokens, backend="pim", **opts)
    _, jit = _port(models, prompts, max_tokens, **opts)
    _, ref = _ref(models, prompts, max_tokens, **opts)
    assert got == jit == ref
    assert all(len(out) == max_tokens for out in got.values())
    if scenario == "preempt":
        assert eng.preemptions > 0 and eng.resumes > 0
    if scenario == "prefix":
        assert eng.kv.stats["shared_blocks"] > 0
    assert eng.kv.live_blocks == 0


def test_pim_backend_parity_and_kv_priced_schedule(models):
    """The reference's ``test_serve_paged.py``
    ``test_pim_backend_parity_and_kv_priced_schedule``: token-identical
    to jit, the pool placed and its traffic priced into a schedule that
    still reconciles."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, models[0].vocab_size, 4 + i, dtype=np.int32)
               for i in range(3)]
    opts = dict(batch=2, max_len=16, kv_block_size=4)
    eng, got = _port(models, prompts, 3, backend="pim", **opts)
    assert got == _port(models, prompts, 3, **opts)[1]
    assert got == _ref(models, prompts, 3, **opts)[1]
    sched = eng.schedule
    assert sched.kv is not None and sched.kv_placement is not None
    assert sched.kv.t_s > 0 and sched.kv.read_bits > 0
    rec = sched.reconcile()
    assert rec["counts_match"] and rec["latency_ge_ideal"]
    assert sched.pipeline(4).interval_s > 0
    kvp = eng.kv_placement
    for site in range(kvp.spec.sites):
        assert kvp.site_first[site] >= sched.placement.n_subarrays
        assert sched.hierarchy.hop_count(kvp.block_home(site, 0),
                                         kvp.consumer_home(site)) >= 0
    assert eng.pipeline_timeline is None


def test_serve_engine_pim_backend_matches_jit(models):
    """The reference's ``test_compile.py``
    ``test_serve_engine_pim_backend_matches_jit`` (its contiguous lanes,
    not ported: here paged) — and the program is built once: every tick
    replays it, its LM head on K1 (the plain version on the CPU)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, models[0].vocab_size, 3 + i, dtype=np.int32)
               for i in range(3)]
    opts = dict(batch=2, max_len=64)
    eng, got = _port(models, prompts, 4, backend="pim", **opts)
    prog = eng.pim_program
    assert got == _port(models, prompts, 4, **opts)[1]
    assert got == _ref(models, prompts, 4, **opts)[1]
    assert eng.pim_program is prog and prog.placed_blocks > 0
    assert (prog.matmul_launches, prog.eltwise_launches) == (1, 3)


@pytest.mark.parametrize("attn_kernel", [False, True])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantized_pool_pim_matches_jit_and_reference(models, kv_dtype,
                                                      attn_kernel):
    """Over an int8 or fp8_e4m3 pool the pim tick quantizes and attends
    as the jit tick (K6 on the kernel path): both pools end bit-equal on
    the kernel path, and in their first layer on the gather path."""
    prompts = _prompts(21, (3, 5, 6), models[0].vocab_size)
    opts = dict(batch=2, max_len=24, kv_block_size=4, kv_dtype=kv_dtype,
                attn_kernel=attn_kernel, prefill="batch")
    before = paged_decode_attention_grouped.launches
    eng, got = _port(models, prompts, 5, backend="pim", **opts)
    jit_eng, jit = _port(models, prompts, 5, **opts)
    assert got == jit == _ref(models, prompts, 5, **opts)[1]
    for name, leaf in eng.cache.items():
        if attn_kernel or name.endswith("_scale"):
            # the gather paths spell attention apart (the pim tick the
            # reference's products, the jit tick the kernel's plain
            # version), so layer 2's K/V differ in their last bits
            first = torch.equal(leaf[0], jit_eng.cache[name][0])
            assert first and (not attn_kernel or torch.equal(
                leaf, jit_eng.cache[name])), name
        if name.endswith("_scale"):
            torch.testing.assert_close(leaf, jit_eng.cache[name],
                                       rtol=1e-5, atol=1e-6)
    # CPU tensors take the plain versions: no launch is counted
    assert paged_decode_attention_grouped.launches == before


def test_int8_weight_grid_matches_jit_over_the_stored_head(models):
    """On an int8 weight grid the LM head (the one placed product outside
    the stack) runs on K5 over the codes the grid stores: the pim engine
    gives the tokens of the jit engine over that stored head."""
    _, _, tcfg, port_model = models
    prompts = _prompts(31, (3, 4, 5, 6), models[0].vocab_size)
    opts = dict(batch=2, max_len=32, kv_block_size=4, attn_kernel=True)
    eng, got = _port(models, prompts, 5, backend="pim", weight_dtype="int8",
                     **opts)
    head = next(nd for nd in eng.schedule.graph.nodes
                if nd.kind == "matmul" and not nd.scanned)
    stored = copy.deepcopy(port_model)
    with torch.no_grad():
        stored.lm_head.w.copy_(fake_quant_stationary(
            eng.schedule, head, port_model.lm_head.w))
    assert not torch.equal(stored.lm_head.w, port_model.lm_head.w)
    assert got == _port(models, prompts, 5, model=stored, **opts)[1]
    assert eng.schedule.hierarchy.subarray.weight_dtype == "int8"


@pytest.mark.parametrize("partitions", [2, 4])
def test_partitioned_pim_engine_is_token_identical(models, partitions):
    """``partitions=K, expand_scans=True``: the tick as K stage programs,
    token-identical to the unpartitioned pim engine and to jit."""
    prompts = _prompts(41, (3, 5, 7), models[0].vocab_size)
    opts = dict(batch=2, max_len=16, kv_block_size=4, attn_kernel=True)
    eng, got = _port(models, prompts, 4, backend="pim",
                     partitions=partitions, expand_scans=True,
                     microbatches=8, **opts)
    assert isinstance(eng.pim_program, mapper.PartitionedProgram)
    assert eng.pim_program.n_partitions == partitions
    assert eng.pipeline_timeline.microbatches == 8
    assert eng.pipeline_timeline.n_partitions == partitions
    whole = _port(models, prompts, 4, backend="pim", **opts)[1]
    assert got == whole == _port(models, prompts, 4, **opts)[1]


def test_act_dtype_prices_the_pim_schedule_narrower(models):
    prompts = _prompts(51, (3, 4), models[0].vocab_size)
    opts = dict(batch=2, max_len=16, kv_block_size=4)
    e8, got = _port(models, prompts, 3, backend="pim", act_dtype="int8",
                    **opts)
    e32, want = _port(models, prompts, 3, backend="pim", **opts)
    assert got == want
    assert (e8.schedule.act_bits, e32.schedule.act_bits) == (8, 32)
    assert e8.schedule.report.latency_s <= e32.schedule.report.latency_s


def test_pim_only_options_are_refused_on_jit(models):
    _, _, tcfg, port_model = models
    for opt, match in ((dict(partitions=2), "partitions require"),
                       (dict(weight_dtype="int8"), "weight_dtype only"),
                       (dict(act_dtype="int8"), "act_dtype only"),
                       (dict(pim_compile={"streams": ()}),
                        "pim_compile only"),
                       (dict(backend="tpu"), "backend must be"),
                       (dict(microbatches=0), "microbatches must be")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(tcfg, port_model, paged=True, device="cpu", **opt)
    with pytest.raises(ValueError, match="needs partitions"):
        ServeEngine(tcfg, port_model, paged=True, device="cpu",
                    backend="pim", pim_compile={"streams": [None]})
    with pytest.raises(ValueError, match="takes 'streams' only"):
        ServeEngine(tcfg, port_model, paged=True, device="cpu",
                    backend="pim", partitions=2,
                    pim_compile={"devices": [None]})


def test_k6_wrapper_is_the_op_the_tick_reaches():
    """The kernel path reaches K4 and K6 through ops the capture keeps
    whole; on CPU tensors they run the wrappers' plain versions."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g)
    store = torch.randn(5, 4, 2, 16, generator=g)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    got = torch.ops.repro_torch.paged_decode(q, store, store, table, pos)
    assert torch.equal(got, paged_decode_attention_grouped(
        q, store, store, table, pos))
    codes = torch.randint(-127, 128, (5, 4, 2, 16), generator=g,
                          dtype=torch.int8)
    scale = torch.rand(5, 4, 2, 1, generator=g)
    got = torch.ops.repro_torch.paged_decode_q(q, codes, scale, codes, scale,
                                               table, pos, "int8")
    assert torch.equal(got, paged_decode_attention_grouped_q(
        q, codes, scale, codes, scale, table, pos, kv_dtype="int8"))
