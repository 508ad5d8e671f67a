"""The port's quantized-KV serving path against the reference's.

* The plain K6 (``repro_torch.kernels.ref.paged_decode_attention_q_ref``,
  which the wrapper runs for CPU tensors) against the reference's Pallas
  ``paged_decode_attention_grouped_q`` in interpret mode, for the four
  grids; scratch block 0 holds large finite garbage (max-magnitude codes,
  scale 3e4) that must never be read.
* ``paged_decode_attention`` / ``paged_prefill_attention`` and the
  ``ServeEngine`` with ``int8`` and ``fp8_e4m3`` pools against
  ``repro.models.attention`` and the reference engine at the same
  ``kv_dtype``: outputs within 1e-5, tokens identical, logits within
  1e-4 (the reference's cross-path tolerance).
* The pool the port writes. The quantizer is bit-equal to the reference's
  on equal inputs (``test_torch_quant.py``), so every (token, kv head)
  vector whose float K/V equals the reference's bit for bit gets
  bit-equal codes and scale. The float K/V themselves come out of torch's
  and XLA's matrix products, which round differently in the last bits;
  where they differ, the scale differs within 1e-5 relative and the
  dequantized values within the grid's error bound. After a whole engine
  run the codes are still bit-equal but for a share of at most 1e-3.
* The allocator moves codes and scales together, bit-exactly (CoW, swap,
  prefix export/import), for the int8 and the int16-held fp16 codes.

Same numpy-seeded inputs on both sides.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.checkpoint.ckpt import _flatten
from repro.core import quant as ref_q
from repro.kernels.flash_attention import (
    paged_decode_attention_grouped_q as pallas_k6)
from repro.models import attention as ref_attn
from repro.models.transformer import build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import kv as ref_kv
from repro_torch import obs as port_obs
from repro_torch.checkpoint import (kv_pool_from_reference,
                                    params_from_reference)
from repro_torch.configs import get_smoke_config
from repro_torch.core import quant
from repro_torch.kernels.ref import paged_decode_attention_q_ref
from repro_torch.models import DecoderLM, attention
from repro_torch.serve import Request, ServeEngine, kv

# the module (``repro_torch.kernels.flash_attention`` the package attribute
# is K7's wrapper, as in the reference)
port_k = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = dict(rtol=1e-5, atol=1e-5)
GRIDS = ("int8", "fp8_e4m3", "fp8_e5m2", "fp16")
SERVE_GRIDS = ("int8", "fp8_e4m3")
BS, W = 4, 5
POSITIONS = (0, 5, 7, 13)      # as in test_torch_paged_attention.py


def _port(a) -> torch.Tensor:
    """A reference array as the port holds it (uint16 codes as int16)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _ref_view(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _max_code(name: str, negative: bool = False) -> int:
    s = ref_q.spec(name)
    if s.kind == "int":
        return -127 if negative else 127
    code = (((1 << s.n_exp) - 1) << s.n_mant) | ((1 << s.n_mant) - 1)
    return code | (1 << (s.n_exp + s.n_mant)) if negative else code


def _table(rng, n):
    pos = np.asarray(POSITIONS, np.int32)
    table = np.zeros((len(pos), W), np.int32)
    for i, p in enumerate(pos):
        nv = p // BS + 1
        table[i, :nv] = rng.choice(n - 1, nv, replace=False) + 1
    return table, pos


def _quantized_pool(rng, name, n, g, d):
    """Codes and scales of random K and V (reference numpy arrays), with
    scratch block 0 overwritten by max-magnitude codes and scale 3e4."""
    leaves = {}
    for leaf, neg in (("k", False), ("v", True)):
        x = rng.standard_normal((n, BS, g, d)).astype(np.float32)
        codes, scale = (np.array(a) for a in ref_q.quantize_kv(
            jnp.asarray(x), name))
        codes[0] = _max_code(name, neg)
        scale[0] = 3.0e4
        leaves[leaf], leaves[leaf + "_scale"] = codes, scale
    return leaves


def _k6_inputs(rep: int, name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    g, d = 2, 16
    n = 1 + len(POSITIONS) * W
    table, pos = _table(rng, n)
    pool = _quantized_pool(rng, name, n, g, d)
    q = rng.standard_normal((len(POSITIONS), g * rep, d)).astype(np.float32)
    return q, pool, table, pos


def _k6_args(q, pool, table, pos):
    return (q, pool["k"], pool["k_scale"], pool["v"], pool["v_scale"],
            table, pos)


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("name", GRIDS)
def test_plain_k6_matches_pallas_kernel(name, rep):
    q, pool, table, pos = _k6_inputs(rep, name)
    args = _k6_args(q, pool, table, pos)
    want = pallas_k6(*(jnp.asarray(a) for a in args), kv_dtype=name,
                     interpret=True)
    targs = [_port(a) for a in args]
    got = paged_decode_attention_q_ref(*targs, name)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = port_k.paged_decode_attention_grouped_q.launches
    via = port_k.paged_decode_attention_grouped_q(*targs, kv_dtype=name)
    assert torch.equal(via, got)
    assert port_k.paged_decode_attention_grouped_q.launches == before


@pytest.mark.parametrize("name", SERVE_GRIDS)
def test_plain_k6_bfloat16_q_matches_pallas_kernel(name):
    """bf16 q: the probabilities stay float32 (v is float32 once
    dequantized) and only the output is rounded to bf16 — the reference
    kernel's rounding, not its gather path's."""
    q, pool, table, pos = _k6_inputs(4, name, seed=1)
    q16 = jnp.asarray(q).astype(jnp.bfloat16)
    args = _k6_args(q, pool, table, pos)
    want = pallas_k6(q16, *(jnp.asarray(a) for a in args[1:]),
                     kv_dtype=name, interpret=True)
    qt = torch.from_numpy(np.array(q16.astype(jnp.float32))).bfloat16()
    got = paged_decode_attention_q_ref(qt, *(_port(a) for a in args[1:]),
                                       name)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of float32 values that agree to ~1e-6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -8, atol=1e-5)


# ---------------------------------------------------------------------------
# model-level paged attention against repro.models.attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def site():
    cfg = configs.get_smoke_config("llama3-8b")
    tcfg = get_smoke_config("llama3-8b")
    params = ref_attn.init_attention(
        jax.random.PRNGKey(0), cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim, jnp.float32)
    attn = attention.init_attention(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(attn, name).copy_(torch.from_numpy(
                np.array(params[name])))
    return cfg, tcfg, params, attn


def _float_pool(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (1 + 4 * W, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {leaf: rng.standard_normal(shape).astype(np.float32)
            for leaf in ("k", "v")}


def _quantize_pool(pool, name):
    out = {}
    for leaf in ("k", "v"):
        codes, scale = ref_q.quantize_kv(jnp.asarray(pool[leaf]), name)
        out[leaf], out[leaf + "_scale"] = np.array(codes), np.array(scale)
    return out


def _port_pool(pool):
    return {k: _port(v) for k, v in pool.items()}


def _check_written(name, got_q, want_q, got_f, want_f, written):
    """The port's quantized pool ``got_q`` against the reference's
    ``want_q``, blocks 1.. only (block 0 is scratch). ``got_f`` /
    ``want_f``: the float K/V each side wrote in the same call over an
    fp32 pool. Entries not written are untouched and bit-equal; a written
    vector whose float K/V agree bit for bit has bit-equal codes and
    scale; any other written vector agrees within the grid's bound."""
    live = slice(1, None)
    for leaf in ("k", "v"):
        codes, scale = _ref_view(got_q[leaf])[live], \
            got_q[leaf + "_scale"].numpy()[live]
        rc, rs = np.asarray(want_q[leaf])[live], \
            np.asarray(want_q[leaf + "_scale"])[live]
        same_f = np.all(got_f[leaf].numpy()[live].view(np.uint32)
                        == np.asarray(want_f[leaf])[live].view(np.uint32),
                        axis=-1)
        exact = ~written[live] | same_f
        assert np.array_equal(codes[exact], rc[exact])
        assert np.array_equal(scale[exact].view(np.uint32),
                              rs[exact].view(np.uint32))
        np.testing.assert_allclose(scale, rs, rtol=1e-5, atol=0)
        dq = np.asarray(ref_q.dequantize_kv(jnp.asarray(rc),
                                            jnp.asarray(rs), name))
        got = quant.dequantize_kv(_port(codes), torch.from_numpy(scale),
                                  name).numpy()
        bound = 2 * np.asarray(ref_q.error_bound(
            jnp.asarray(dq), name, jnp.asarray(rs))) + 1e-5 * np.abs(
                dq).max(-1, keepdims=True)
        assert (np.abs(got - dq) <= bound).all()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", SERVE_GRIDS)
def test_paged_decode_attention_matches_reference(site, name, use_kernel):
    cfg, tcfg, params, attn = site
    rng = np.random.default_rng(3)
    n = 1 + 4 * W
    table, pos = _table(rng, n)
    fpool = _float_pool(cfg, 4)
    qpool = _quantize_pool(fpool, name)
    x = rng.standard_normal((len(pos), 1, cfg.d_model)).astype(np.float32)
    xj, tj, pj = jnp.asarray(x), jnp.asarray(table), jnp.asarray(pos)
    want, new = ref_attn.paged_decode_attention(
        xj, params, cfg, {k: jnp.asarray(v) for k, v in qpool.items()}, tj,
        pj, use_kernel=use_kernel, kv_dtype=name)
    pool = _port_pool(qpool)
    got = attention.paged_decode_attention(
        torch.from_numpy(x), attn, tcfg, pool["k"], pool["v"],
        torch.from_numpy(table), torch.from_numpy(pos),
        use_kernel=use_kernel, kv_dtype=name, k_scale=pool["k_scale"],
        v_scale=pool["v_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the float K/V each side writes, from the same call over fp32 pools
    _, want_f = ref_attn.paged_decode_attention(
        xj, params, cfg, {k: jnp.asarray(v) for k, v in fpool.items()}, tj,
        pj)
    got_f = {k: torch.from_numpy(v.copy()) for k, v in fpool.items()}
    attention.paged_decode_attention(
        torch.from_numpy(x), attn, tcfg, got_f["k"], got_f["v"],
        torch.from_numpy(table), torch.from_numpy(pos))
    written = np.zeros(pool["k_scale"].shape[:3], bool)
    for b, p in enumerate(pos):
        written[table[b, p // BS], p % BS] = True
    _check_written(name, pool, new, got_f, want_f, written)


@pytest.mark.parametrize("p0,n_new", [(0, 7), (4, 9), (8, 1)])
@pytest.mark.parametrize("name", SERVE_GRIDS)
def test_paged_prefill_attention_matches_reference(site, name, p0, n_new):
    cfg, tcfg, params, attn = site
    fpool = _float_pool(cfg, 6)
    qpool = _quantize_pool(fpool, name)
    rng = np.random.default_rng(7)
    t = -(-n_new // BS) * BS                 # padded to whole blocks
    x = rng.standard_normal((1, t, cfg.d_model)).astype(np.float32)
    table_row = rng.choice(fpool["k"].shape[0] - 1, W, replace=False).astype(
        np.int32) + 1
    table_row[(p0 + n_new - 1) // BS + 1:] = 0        # scratch tail
    xj, rj = jnp.asarray(x), jnp.asarray(table_row)
    want, new = ref_attn.paged_prefill_attention(
        xj, params, cfg, {k: jnp.asarray(v) for k, v in qpool.items()}, rj,
        jnp.int32(p0), jnp.int32(n_new), kv_dtype=name)
    pool = _port_pool(qpool)
    got = attention.paged_prefill_attention(
        torch.from_numpy(x), attn, tcfg, pool["k"], pool["v"],
        torch.from_numpy(table_row), p0, n_new, kv_dtype=name,
        k_scale=pool["k_scale"], v_scale=pool["v_scale"])
    # rows past n_new are padding: don't-cares on both sides
    np.testing.assert_allclose(got[:, :n_new].numpy(),
                               np.asarray(want)[:, :n_new], **TOL)
    _, want_f = ref_attn.paged_prefill_attention(
        xj, params, cfg, {k: jnp.asarray(v) for k, v in fpool.items()}, rj,
        jnp.int32(p0), jnp.int32(n_new))
    got_f = {k: torch.from_numpy(v.copy()) for k, v in fpool.items()}
    attention.paged_prefill_attention(
        torch.from_numpy(x), attn, tcfg, got_f["k"], got_f["v"],
        torch.from_numpy(table_row), p0, n_new)
    written = np.zeros(pool["k_scale"].shape[:3], bool)
    for p in range(p0, p0 + n_new):
        written[table_row[p // BS], p % BS] = True
    _check_written(name, pool, new, got_f, want_f, written)


# ---------------------------------------------------------------------------
# the serve engine against the reference engine, same kv_dtype
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    cfg = configs.get_smoke_config("llama3-8b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("llama3-8b")
    return cfg, params, tcfg, params_from_reference(_flatten(params), tcfg,
                                                    device="cpu")


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lengths]


def _drive(engine_cls, request_cls, cfg, params, prompts, max_tokens,
           to_numpy, **opts):
    ticks = []

    def sample(logits):
        ticks.append(to_numpy(logits))
        return logits.argmax(-1)

    eng = engine_cls(cfg, params, paged=True, sample=sample, **opts)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_tokens=max_tokens))
    return eng, {r.rid: r.out for r in eng.run()}, ticks


# name -> (engine options, prompt lengths, max_tokens)
SCENARIOS = {
    "kernel-replay": (dict(attn_kernel=True, prefill="replay"),
                      (5, 9, 3, 12), 6),
    "kernel-batch": (dict(attn_kernel=True, prefill="batch"),
                     (5, 9, 3, 12), 6),
    "gather-replay": (dict(attn_kernel=False, prefill="replay"),
                      (5, 9, 3, 12), 6),
    "gather-batch": (dict(attn_kernel=False, prefill="batch"),
                     (5, 9, 3, 12), 6),
    # a 6-block pool (as tests/test_kvquant.py's swap round trip): the
    # youngest slot is swapped out with its codes and scales, then resumed
    "preempt": (dict(attn_kernel=True, prefill="replay", kv_blocks=6),
                (5, 3), 10),
}


# The engines' float K/V differ from each other in the last bits, yet
# their codes almost never do: over the ten engine scenarios below, 1
# code of 2,560 written differs (fp8_e4m3, preempt) and none elsewhere,
# while ~65% of the scales differ by up to 20 ulps (1.3e-6 relative).
MAX_CODE_FLIP_SHARE = 1e-3


def _check_pools(name, port_cache, ref_cache):
    """The port's whole pool against the reference's (scratch block
    included). Codes are bit-equal but for at most ``MAX_CODE_FLIP_SHARE``
    of the written ones, each such value within twice the grid's error
    bound of the reference's; scales within 1e-5 relative. The float K/V
    the run quantized are not observable here (``_check_written`` holds
    them per site)."""
    want = kv_pool_from_reference(jax.tree.map(np.asarray, ref_cache), name,
                                  device="cpu")
    assert set(port_cache) == set(want)
    for leaf in ("k", "v"):
        assert port_cache[leaf].dtype == want[leaf].dtype
        scale, rs = port_cache[leaf + "_scale"], want[leaf + "_scale"]
        np.testing.assert_allclose(scale.numpy(), rs.numpy(), rtol=1e-5,
                                   atol=0)
        written = ((scale != 0) | (rs != 0)).expand_as(want[leaf])
        flips = int((port_cache[leaf] != want[leaf]).sum())
        assert flips <= MAX_CODE_FLIP_SHARE * int(written.sum()), (
            f"{leaf}: {flips} codes differ of {int(written.sum())} written")
        got = quant.dequantize_kv(port_cache[leaf], scale, name).numpy()
        dq = quant.dequantize_kv(want[leaf], rs, name).numpy()
        bound = 2 * quant.error_bound(torch.from_numpy(dq), name, rs).numpy()
        assert (np.abs(got - dq) <= bound + 1e-6).all()


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("name", SERVE_GRIDS)
def test_engine_matches_reference_at_same_kv_dtype(models, name, scenario):
    cfg, params, tcfg, model = models
    opts, lengths, max_tokens = SCENARIOS[scenario]
    opts = dict(batch=2, max_len=32, kv_block_size=4, kv_dtype=name, **opts)
    prompts = _prompts(len(lengths), lengths, cfg.vocab_size)
    ref, want, ref_ticks = _drive(RefEngine, RefRequest, cfg, params,
                                  prompts, max_tokens, np.asarray, **opts)
    eng, got, ticks = _drive(ServeEngine, Request, tcfg, model, prompts,
                             max_tokens, lambda t: t.numpy().copy(),
                             device="cpu", **opts)
    assert got == want
    assert len(ticks) == len(ref_ticks)
    for a, b in zip(ticks, ref_ticks):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    for attr in ("preemptions", "resumes", "kv_bytes_read",
                 "kv_bytes_written", "prefill_batched_tokens", "_tick"):
        assert getattr(eng, attr) == getattr(ref, attr), attr
    assert eng.kv.stats == ref.kv.stats
    if scenario == "preempt":
        assert eng.preemptions > 0 and eng.resumes > 0
    _check_pools(name, eng.cache, ref.cache)


def test_quantized_pool_leaves_and_byte_counts(models):
    cfg, params, tcfg, model = models
    for name in ("fp32",) + GRIDS:
        ref = RefEngine(cfg, params, paged=True, batch=2, max_len=32,
                        kv_block_size=4, kv_dtype=name)
        eng = ServeEngine(tcfg, model, paged=True, batch=2, max_len=32,
                          kv_block_size=4, kv_dtype=name, device="cpu")
        want = ref.cache["layers"]["block0"]
        assert sorted(eng.cache) == sorted(want)
        for leaf, t in eng.cache.items():
            w = np.asarray(want[leaf])
            assert tuple(t.shape) == w.shape
            assert t.element_size() == w.dtype.itemsize
        assert eng._tok_bytes == ref._tok_bytes
        assert eng.kv.kv_dtype == ref.kv.kv_dtype


@pytest.mark.parametrize("name", SERVE_GRIDS)
def test_kv_dequant_errors_match_reference(models, name):
    cfg, params, tcfg, model = models
    prompts = _prompts(11, (8, 8), cfg.vocab_size)
    opts = dict(batch=2, max_len=32, kv_block_size=4)
    errs = []
    for cls, req, c, p, extra, to_np in (
            (RefEngine, RefRequest, cfg, params, {}, np.asarray),
            (ServeEngine, Request, tcfg, model, {"device": "cpu"},
             lambda t: t.numpy())):
        golden, _, _ = _drive(cls, req, c, p, prompts, 1, to_np, **opts,
                              **extra)
        quantized, _, _ = _drive(cls, req, c, p, prompts, 1, to_np,
                                 kv_dtype=name, **opts, **extra)
        errs.append(quantized.kv_dequant_errors(golden))
    port_obs.metrics().reset()
    got = np.asarray(errs[1])
    assert got.shape == (cfg.n_layers,) and got.dtype == np.float32
    np.testing.assert_allclose(got, errs[0], rtol=0, atol=1e-6)
    # layer 0's K/V come from the embeddings alone, so its error is the
    # quantizer's and within budget; later layers add the propagated error
    assert float(got[0]) <= quant.layer_error_budget(name)
    # recorded into the port's metrics
    eng = ServeEngine(tcfg, model, paged=True, kv_dtype=name,
                      device="cpu", **opts)
    eng.kv_dequant_errors(eng.cache)
    hist = port_obs.metrics().snapshot()["histograms"]
    assert hist["serve.kv_dequant_rel_error"]["count"] == cfg.n_layers


@pytest.mark.parametrize("name", SERVE_GRIDS)
def test_bfloat16_model_raises_on_quantized_gather_paths(name):
    """Both packages reject a bf16 model over a quantized pool on the
    gather decode path and in batch prefill; the kernel path runs."""
    cfg = configs.get_smoke_config("llama3-8b")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    ref_model = build_model(cfg16)
    params = ref_model.init(jax.random.PRNGKey(0))
    cache = ref_model.init_paged_cache(6, 4, kv_dtype=name)
    token = jnp.zeros((2,), jnp.int32)
    table = jnp.asarray([[1, 2], [3, 4]], jnp.int32)
    pos = jnp.asarray([0, 1], jnp.int32)
    with pytest.raises(TypeError):
        ref_model.decode_step_paged(params, cache, token, table, pos,
                                    kernel=False, kv_dtype=name)
    with pytest.raises(TypeError):
        ref_model.prefill_paged(params, cache, jnp.zeros((4,), jnp.int32),
                                table[0], 0, 3, kv_dtype=name)
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="bfloat16")
    model = DecoderLM(tcfg, device="cpu").init(0)
    pool = model.init_paged_cache(6, 4, kv_dtype=name)
    args = (torch.zeros(2, dtype=torch.long), torch.tensor(
        [[1, 2], [3, 4]], dtype=torch.int32), torch.tensor(
        [0, 1], dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        model.decode_step_paged(pool, *args, kernel=False, kv_dtype=name)
    with pytest.raises(TypeError, match="float32"):
        model.prefill_paged(pool, torch.zeros(4, dtype=torch.long),
                            args[1][0], 0, 3, kv_dtype=name)
    assert not pool["k_scale"].any()         # nothing was written
    logits, _ = model.decode_step_paged(pool, *args, kernel=True,
                                        kv_dtype=name)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())
    assert pool["k_scale"].any()


# ---------------------------------------------------------------------------
# sizing and the allocator over quantized pools
# ---------------------------------------------------------------------------


def test_blocks_for_bytes_reproduces_the_kvquant_capacity():
    # BENCH_kvquant.json "capacity": the llama3 smoke config (2 kv heads x
    # head_dim 16, 2 sites), block size 8, a 10-block fp32 pool's bytes
    g, d, sites, bs = 2, 16, 2, 8
    assert kv.kv_token_bytes(g, d, sites, "fp32") == 512
    assert kv.kv_token_bytes(g, d, sites, "fp8_e4m3") == 160
    pool = 10 * bs * kv.kv_token_bytes(g, d, sites, "fp32")
    assert pool == 40960
    assert kv.blocks_for_bytes(pool, bs, g, d, sites, "fp32") == 10
    assert kv.blocks_for_bytes(pool, bs, g, d, sites, "fp8_e4m3") == 32
    assert kv.blocks_for_bytes(pool, bs, g, d, sites, "int8") == 32
    for name in ("fp32",) + GRIDS + ("fp8",):
        assert (kv.blocks_for_bytes(pool, bs, g, d, sites, name)
                == ref_kv.blocks_for_bytes(pool, bs, g, d, sites, name))
        assert kv.kv_token_bits(g, d, name) == ref_kv.kv_token_bits(
            g, d, name)
    assert kv.blocks_for_bytes(1, bs, g, d, sites, "fp32") == 2


@pytest.mark.parametrize("name", ["int8", "fp16"])
def test_allocator_moves_codes_and_scales_bit_exactly(name):
    """CoW, swap out/in and prefix export/import over a quantized pool,
    stepped beside the reference's allocator: the pools stay bit-equal
    (fp16-grid codes held as int16 included)."""
    n, bs, slots, max_len = 8, 2, 2, 10
    rng = np.random.default_rng(9)
    codes, scale = ref_q.quantize_kv(jnp.asarray(
        rng.standard_normal((1, n, bs, 1, 4)).astype(np.float32)), name)
    rs = {"k": codes, "k_scale": scale}
    ps = {k: _port(v) for k, v in rs.items()}
    port = kv.PagedKVCache(n, bs, slots, max_len, kv_dtype=name,
                           device="cpu")
    ref = ref_kv.PagedKVCache(n, bs, slots, max_len, kv_dtype=name)
    assert port.kv_dtype == ref.kv_dtype

    def same():
        for leaf in rs:
            assert np.array_equal(_ref_view(ps[leaf]).view(np.uint8),
                                  np.asarray(rs[leaf]).view(np.uint8))

    prompt = np.arange(5, dtype=np.int32)
    for alloc in (port, ref):
        alloc.alloc_slot(0, prompt)
    for pos in range(5):
        ps = port.ensure(ps, 0, pos)
        rs = ref.ensure(rs, 0, pos)
        port.note_filled(0, pos)
        ref.note_filled(0, pos)
    port.fork_slot(0, 1)
    ref.fork_slot(0, 1)
    ps, rs = port.ensure(ps, 1, 4), ref.ensure(rs, 1, 4)   # CoW copy
    assert port.stats == ref.stats and port.stats["cow_copies"] == 1
    same()
    pp, rp = port.swap_out(ps, 1), ref.swap_out(rs, 1)
    for (pi, pc), (ri, rc) in zip(pp.pages, rp.pages):
        assert pi == ri
        for leaf in rs:
            assert np.array_equal(_ref_view(pc[leaf]).view(np.uint8),
                                  np.asarray(rc[leaf]).view(np.uint8))
    port.free_slot(0)
    ref.free_slot(0)
    (ps, shared), (rs, rshared) = (port.swap_in(ps, 0, prompt, pp),
                                   ref.swap_in(rs, 0, prompt, rp))
    assert shared == rshared
    assert np.array_equal(port.table, ref.table)
    same()
    (pc, pe), (rc, re_) = (port.export_prefix(ps, prompt),
                           ref.export_prefix(rs, prompt))
    assert pc == rc > 0
    other_p = kv.PagedKVCache(n, bs, slots, max_len, kv_dtype=name,
                              device="cpu")
    other_r = ref_kv.PagedKVCache(n, bs, slots, max_len, kv_dtype=name)
    zp = {k: torch.zeros_like(v) for k, v in ps.items()}
    zr = {k: jnp.zeros_like(v) for k, v in rs.items()}
    ps, rs = other_p.import_prefix(zp, prompt, pe), \
        other_r.import_prefix(zr, prompt, re_)
    assert other_p.stats == other_r.stats
    same()


def test_kv_pool_bridge_rejects_mismatched_pools(models):
    cfg, params, _, _ = models
    ref_cache = jax.tree.map(np.asarray, build_model(cfg).init_paged_cache(
        4, 4, kv_dtype="int8"))
    pool = kv_pool_from_reference(ref_cache, "int8", device="cpu")
    assert pool["k"].dtype == torch.int8 and sorted(pool) == [
        "k", "k_scale", "v", "v_scale"]
    with pytest.raises(ValueError, match="leaves"):
        kv_pool_from_reference(ref_cache, "fp32", device="cpu")
    with pytest.raises(ValueError, match="codes"):
        kv_pool_from_reference(ref_cache, "fp8_e4m3", device="cpu")
    fp16 = jax.tree.map(np.asarray, build_model(cfg).init_paged_cache(
        4, 4, kv_dtype="fp16"))
    assert kv_pool_from_reference(fp16, "fp16", device="cpu")[
        "v"].dtype == torch.int16
