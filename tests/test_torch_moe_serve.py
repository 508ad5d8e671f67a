"""Serving the mixture-of-experts configs (port queue item 5.3, the serve
half) against the reference, at the smoke configs of granite-moe-1b-a400m
(an MoE block every layer, top-2 of 4, tied head) and
llama4-maverick-400b-a17b (units of a dense block then an MoE block,
top-1 of 4 with the shared expert), in float32:

* ``apply`` and ``make_prefill_step`` logits within rtol = atol = 1e-4;
* the contiguous ``decode_step``: greedy tokens identical, logits within
  1e-4, the per-block caches too;
* ``ServeEngine(backend="jit")`` over fp32 and int8 pools, on the kernel
  and the gather path: tokens identical to the reference's jit engine,
  with batch prefill and with replayed prompts, each against the
  reference's same prefill (capacity drops differ between a whole
  prompt and its replay, so the two are not held to each other);
* ``ServeEngine(backend="pim")`` token-identical to the port's jit
  engine; the compiled decode step (folded and ``expand_scans``) bit for
  bit against the per-block executor and within 1e-4 of the plain step;
* the bridge: parameters both ways, a wrong or missing MoE leaf refused,
  and a two-block pool (maverick's) as the port's one pool.

The schedules are held in ``tests/test_torch_moe_schedules.py``, the
train step in ``tests/test_torch_moe_train*.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.models.transformer import build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import mapper
from repro_torch._tree import leaves_with_path
from repro_torch.checkpoint import (kv_pool_from_reference,
                                    model_from_stacked,
                                    params_from_reference,
                                    stacked_from_reference)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.mapper.executor import max_deviation
from repro_torch.models import transformer
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(reference config, port config, the reference's params, the
    flattened numpy params, the port's tree)."""
    rcfg, cfg = ref_smoke_config(request.param), get_smoke_config(
        request.param)
    rparams = build_model(rcfg).init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(rparams).items()}
    return rcfg, cfg, rparams, flat, stacked_from_reference(flat, cfg,
                                                            device="cpu")


def _tokens(cfg, shape, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_forward_logits_and_prefill_match_reference(case):
    rcfg, cfg, rparams, flat, tree = case
    tokens = _tokens(cfg, (2, 64))
    want = build_model(rcfg).apply(rparams, tokens=jnp.asarray(tokens))
    got = transformer.apply(cfg, tree, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_last = ref_steps.make_prefill_step(rcfg)(
        rparams, {"tokens": jnp.asarray(tokens)})
    got_last = steps.make_prefill_step(cfg)(
        tree, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **TOL)
    # the module the jit engine runs holds the same leaves, block i of
    # unit u at layer u·n + i
    lm = params_from_reference(flat, cfg, device="cpu")
    for key, leaf in leaves_with_path(lm.stacked_params()):
        np.testing.assert_array_equal(leaf.numpy(), flat[key], err_msg=key)
    n = transformer.unit_blocks(cfg)
    assert [hasattr(b, "moe") for b in lm.layers] == [
        transformer.is_moe(cfg, j % n) for j in range(cfg.n_layers)]


def test_decode_step_greedy_matches_reference(case):
    rcfg, cfg, rparams, _, tree = case
    model = build_model(rcfg)
    step = jax.jit(model.decode_step)
    batch, max_len = 8, 16
    ref_cache = model.init_cache(batch, max_len)
    cache = transformer.DecoderLM(cfg, device="cpu").init_cache(batch,
                                                                max_len)
    assert sorted(cache["layers"]) == sorted(ref_cache["layers"])
    first = _tokens(cfg, (batch,), 0)
    rtok, tok = jnp.asarray(first), torch.from_numpy(first)
    for p in range(6):
        want, ref_cache = step(rparams, ref_cache, rtok, jnp.int32(p))
        got, cache = transformer.decode_step(
            cfg, tree, cache, tok, torch.tensor(p, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        rtok = jnp.argmax(want, -1).astype(jnp.int32)
        tok = got.argmax(-1).to(torch.int32)
        assert np.array_equal(tok.numpy(), np.asarray(rtok))
    for (path, leaf), (_, want_leaf) in zip(
            leaves_with_path(cache), leaves_with_path(ref_cache),
            strict=True):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want_leaf),
                                   err_msg=path, **TOL)


def _serve(engine_cls, request_cls, cfg, params, prompts, **opts):
    ticks = []

    def sample(logits):
        ticks.append(logits.numpy().copy() if torch.is_tensor(logits)
                     else np.asarray(logits).copy())
        return logits.argmax(-1)

    eng = engine_cls(cfg, params, paged=True, sample=sample, batch=3,
                     max_len=32, kv_block_size=4, **opts)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_tokens=4))
    return {r.rid: r.out for r in eng.run()}, ticks


def _prompts(cfg, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in (3, 8, 11, 5)]


@pytest.mark.parametrize("prefill", ["batch", "replay"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_paged_serving_matches_reference(case, kv_dtype, prefill):
    rcfg, cfg, rparams, flat, _ = case
    prompts = _prompts(cfg)
    want, want_ticks = _serve(RefEngine, RefRequest, rcfg, rparams, prompts,
                              kv_dtype=kv_dtype, prefill=prefill)
    model = params_from_reference(flat, cfg, device="cpu")
    for kernel in (True, False):
        got, ticks = _serve(ServeEngine, Request, cfg, model, prompts,
                            kv_dtype=kv_dtype, prefill=prefill,
                            attn_kernel=kernel, device="cpu")
        assert got == want
        if kv_dtype == "fp32":
            for a, b in zip(ticks, want_ticks, strict=True):
                np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_pim_engine_matches_jit_engine(case, kv_dtype):
    rcfg, cfg, rparams, flat, _ = case
    model = params_from_reference(flat, cfg, device="cpu")
    prompts = _prompts(cfg, 5)
    outs = [_serve(ServeEngine, Request, cfg, model, prompts,
                   attn_kernel=True, kv_dtype=kv_dtype, prefill="batch",
                   backend=backend, device="cpu")[0]
            for backend in ("jit", "pim")]
    assert outs[0] == outs[1]


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        pytree.tree_leaves(a), pytree.tree_leaves(b), strict=True))


@pytest.mark.parametrize("expand", [False, True])
def test_compiled_decode_step_equals_executor_and_plain(case, expand):
    rcfg, cfg, rparams, flat, tree = case
    batch, max_len = 8, 32
    cache = transformer.DecoderLM(cfg, device="cpu").init_cache(batch,
                                                                max_len)
    tok = torch.from_numpy(_tokens(cfg, (batch,), 5))
    prog = mapper.compile_arch(cfg.name, "serve", batch=batch,
                               seq_len=max_len, config=cfg,
                               expand_scans=expand, device="cpu")
    for p in range(3):
        pos = torch.tensor(p, dtype=torch.int32)
        got = prog(tree, cache, tok, pos)
        ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
        assert _leaves_equal(got, ex.run(tree, cache, tok, pos))
        plain = transformer.decode_step(cfg, tree, cache, tok, pos)
        max_deviation(got, plain, **TOL)
        (logits, cache), tok = got, got[0].argmax(-1).to(torch.int32)
        assert torch.equal(tok, plain[0].argmax(-1).to(torch.int32))
    if expand:       # the router, attention and head products on K1
        assert prog.matmul_launches > 0 and prog.eltwise_launches > 0


def test_bridge_carries_the_moe_leaves_and_pools(case):
    rcfg, cfg, rparams, flat, tree = case
    keys = set(transformer.leaf_shapes(cfg))
    moe_keys = {k for k in keys if "/moe/" in k}
    want = {f"layers/block{transformer.unit_blocks(cfg) - 1}/moe/{n}"
            for n in ("router", "w_gate", "w_up", "w_down")}
    if cfg.shared_expert:
        want |= {k.replace("/moe/", "/moe/shared_expert/")
                 for k in want if not k.endswith("router")}
    assert moe_keys == want == {k for k in flat if "/moe/" in k}
    assert keys == set(flat)
    model = params_from_reference(flat, cfg, device="cpu")
    assert _leaves_equal(model.stacked_params(), tree)
    assert _leaves_equal(model_from_stacked(tree, cfg, device="cpu")
                         .stacked_params(), tree)
    # a missing or wrong MoE leaf is refused
    some = sorted(moe_keys)[0]
    missing = {k: v for k, v in flat.items() if k != some}
    wrong = {**flat, some: flat[some][..., :1]}
    for bad in (missing, wrong):
        with pytest.raises(ValueError):
            stacked_from_reference(bad, cfg, device="cpu")
        with pytest.raises(ValueError):
            params_from_reference(bad, cfg, device="cpu")
    # the reference's pool, one site per block, as the port's one pool
    rmodel = build_model(rcfg)
    for kv_dtype in ("fp32", "int8"):
        rcache = jax.tree.map(
            lambda a: jnp.asarray(np.random.default_rng(a.size).integers(
                -100, 100, a.shape).astype(a.dtype)),
            rmodel.init_paged_cache(5, 4, kv_dtype=kv_dtype))
        pool = kv_pool_from_reference(rcache, kv_dtype, device="cpu")
        n = transformer.unit_blocks(cfg)
        assert sorted(rcache["layers"]) == [f"block{i}" for i in range(n)]
        assert all(t.shape[0] == cfg.n_layers for t in pool.values())
        want = dict(leaves_with_path(rcache))
        got = dict(leaves_with_path(transformer.pool_tree(cfg, pool)))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(want[path]),
                                          err_msg=path)
            # a view: the tree's writes land in the pool
            name = path.rsplit("/", 1)[1]
            assert leaf.data_ptr() - pool[name].data_ptr() == (
                int(path.split("/")[1][len("block"):])
                * pool[name][0].nbytes)
