"""The dense attention variants (port queue item 5.1) against the
reference: qwen2.5's q/k/v biases, qwen3's per-head q/k RMS norm and
chatglm3's rotation over half the head dims.

Every parity test runs on the smoke configs of qwen2.5-32b, qwen3-32b
and chatglm3-6b and on two cuts the smoke configs cannot show: qwen3's
with ``head_dim=32`` (H·hd 128 ≠ d_model 64) and chatglm3's with 32 query
heads over 2 KV heads (rep 16, K4's ``_MAX_REP``, ``head_dim=16``). The
reference's init sets every bias to zero and every norm scale to one, so
a dropped bias or norm would pass over initialised params: the params
here are the reference's init with seeded non-zero biases and scales
away from one, handed to both frameworks through ``checkpoint.bridge``.

* ``head_rms_norm`` and ``apply_rope`` (``"half"``, ``"none"``) against
  the reference's, float32 and bfloat16;
* the forward logits (``apply``, and the module the jit engine runs)
  within rtol = atol = 1e-4, ``make_prefill_step`` too;
* the contiguous ``decode_step``: greedy tokens identical, logits within
  1e-4; paged serving (``ServeEngine``, kernel and gather paths) over
  fp32 and int8 pools: tokens identical to the reference's engine;
* the compiled decode and train steps (``compile_arch``, folded and
  with ``expand_scans``: the bias adds and the head norm's products on
  K3) bit for bit against the per-block executor and within 1e-4 of the
  plain step, and ``ServeEngine(backend="pim")`` token-identical to the
  jit engine;
* the bridge carries the new leaves both ways, AdamW state included;
  ``check_ported`` names item 5.4b (the recurrent train step).

The gradients and the train step are held in
``tests/test_torch_variant_grads.py``, the schedules in
``tests/test_torch_variant_schedules.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.models import layers as ref_layers
from repro.models.transformer import build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import mapper
from repro_torch._tree import leaves_with_path
from repro_torch.checkpoint import (model_from_stacked,
                                    opt_state_from_reference,
                                    params_from_reference,
                                    stacked_from_reference)
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.mapper.executor import max_deviation
from repro_torch.models import layers, transformer
from repro_torch.optim import make_optimizer
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("qwen2.5-32b", "qwen3-32b", "chatglm3-6b")
# name -> (arch, config changes)
CASES = {**{arch: (arch, {}) for arch in ARCHS},
         "qwen3-hd32": ("qwen3-32b", dict(head_dim=32)),
         "rep16": ("chatglm3-6b", dict(n_heads=32, n_kv_heads=2,
                                       head_dim=16))}


def _perturbed(flat: dict, seed: int) -> dict:
    """``flat`` with seeded non-zero biases and norm scales away from 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, v in flat.items():
        v = np.asarray(v)
        if key.endswith("_bias"):
            v = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif key.endswith(("q_norm", "k_norm")):
            v = (1 + 0.25 * rng.standard_normal(v.shape)).astype(v.dtype)
        out[key] = v
    return out


def _cfgs(name: str, **more):
    arch, changes = CASES[name]
    return (dataclasses.replace(ref_smoke_config(arch), **changes, **more),
            dataclasses.replace(get_smoke_config(arch), **changes, **more))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, reference config, port config, the reference's params tree,
    the flattened numpy params, the port's tree)."""
    rcfg, cfg = _cfgs(request.param)
    init = build_model(rcfg).init(jax.random.PRNGKey(0))
    flat = _perturbed({k: np.asarray(v) for k, v in _flatten(init).items()},
                      7)
    rparams = jax.tree.map(jnp.asarray, transformer.param_tree(flat))
    return (request.param, rcfg, cfg, rparams, flat,
            stacked_from_reference(flat, cfg, device="cpu"))


def _tokens(cfg, shape, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_rms_norm_and_half_rope_match_reference(dtype):
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((2, 5, 4, 32))).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(32)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 5)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    js, ts = (jnp.asarray(scale).astype(dtype),
              torch.from_numpy(scale).to(getattr(torch, dtype)))
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
           else dict(rtol=8e-3, atol=8e-3))

    def close(got, want):
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)

    close(layers.head_rms_norm(tx, ts, 1e-5),
          ref_layers.head_rms_norm(jx, js, 1e-5))
    for style in ("half", "full"):
        for theta in (10_000.0, 1_000_000.0):
            close(layers.apply_rope(tx, torch.from_numpy(pos), theta=theta,
                                    style=style),
                  ref_layers.apply_rope(jx, jnp.asarray(pos), theta=theta,
                                        style=style))
    got = layers.apply_rope(tx, torch.from_numpy(pos), theta=1.0,
                            style="none")
    assert got is tx
    # the half rotation leaves the second half of each head as it was
    half = layers.apply_rope(tx, torch.from_numpy(pos), theta=1e4,
                             style="half")
    assert torch.equal(half[..., 16:], tx[..., 16:])
    # M-RoPE (item 5.2) over a grid whose t, h and w rows differ
    grid = np.stack([pos, pos // 3 + 7, pos % 11]).astype(np.int32)
    kw = dict(theta=1e6, style="mrope", sections=(4, 6, 6))
    close(layers.apply_rope(tx, torch.from_numpy(grid), **kw),
          ref_layers.apply_rope(jx, jnp.asarray(grid), **kw))


# ---------------------------------------------------------------------------
# forward and decode
# ---------------------------------------------------------------------------


def test_forward_logits_and_prefill_match_reference(case):
    name, rcfg, cfg, rparams, flat, tree = case
    model = build_model(rcfg)
    tokens = _tokens(cfg, (2, 16))
    want = model.apply(rparams, tokens=jnp.asarray(tokens))
    got = transformer.apply(cfg, tree, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_last = ref_steps.make_prefill_step(rcfg)(
        rparams, {"tokens": jnp.asarray(tokens)})
    got_last = steps.make_prefill_step(cfg)(
        tree, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **TOL)
    # the module the jit engine runs holds the same leaves
    lm = params_from_reference(flat, cfg, device="cpu")
    for key, leaf in leaves_with_path(lm.stacked_params()):
        np.testing.assert_array_equal(leaf.numpy(), flat[key], err_msg=key)
    attn = lm.layers[0].attn
    assert hasattr(attn, "q_bias") == cfg.qkv_bias
    assert hasattr(attn, "q_norm") == cfg.qk_norm
    # the seeded init: zero biases, unit scales, as the reference's
    fresh = transformer.DecoderLM(cfg, device="cpu").init(0).layers[0].attn
    for leaf in ("q_bias", "k_bias", "v_bias"):
        if cfg.qkv_bias:
            assert not fresh[leaf].any()
    for leaf in ("q_norm", "k_norm"):
        if cfg.qk_norm:
            assert bool((fresh[leaf] == 1).all())


def test_decode_step_greedy_matches_reference(case):
    name, rcfg, cfg, rparams, _, tree = case
    model = build_model(rcfg)
    step = jax.jit(model.decode_step)
    batch, max_len = 2, 16
    ref_cache = model.init_cache(batch, max_len)
    cache = {"layers": {"block0": {
        k: torch.zeros(tuple(v.shape)) for k, v in transformer.DecoderLM(
            cfg, device="meta").init_cache(batch, max_len)["layers"][
                "block0"].items()}}}
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


def _serve(engine_cls, request_cls, cfg, params, prompts, **opts):
    ticks = []

    def sample(logits):
        ticks.append(np.asarray(logits).copy() if not torch.is_tensor(
            logits) else logits.numpy().copy())
        return logits.argmax(-1)

    eng = engine_cls(cfg, params, paged=True, sample=sample, batch=2,
                     max_len=24, kv_block_size=4, **opts)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_tokens=4))
    return {r.rid: r.out for r in eng.run()}, ticks


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_paged_serving_matches_reference(case, kv_dtype):
    name, rcfg, cfg, rparams, flat, _ = case
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 6, 9)]
    want, want_ticks = _serve(RefEngine, RefRequest, rcfg, rparams, prompts,
                              kv_dtype=kv_dtype, prefill="batch")
    model = params_from_reference(flat, cfg, device="cpu")
    for kernel in (True, False):
        got, ticks = _serve(ServeEngine, Request, cfg, model, prompts,
                            kv_dtype=kv_dtype, prefill="batch",
                            attn_kernel=kernel, device="cpu")
        assert got == want
        if kv_dtype == "fp32":
            for a, b in zip(ticks, want_ticks, strict=True):
                np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# the compiled steps and the pim engine
# ---------------------------------------------------------------------------


def _counting(monkeypatch, fn_name: str) -> list:
    calls = []
    real = getattr(ref, fn_name)
    monkeypatch.setattr(ref, fn_name, lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    return calls


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        pytree.tree_leaves(a), pytree.tree_leaves(b), strict=True))


# arch -> (expanded serve: K1 launches, K3 launches, K3 members; expanded
# train: the same) on the CPU, the kernels' plain versions counted
COMPILED = {"qwen2.5-32b": ((15, 37, 57), (42, 168, 293)),
            "qwen3-32b": ((15, 47, 63), (42, 182, 320)),
            "chatglm3-6b": ((15, 35, 51), (42, 148, 254))}


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_steps_equal_executor_and_plain_step(arch, monkeypatch):
    rcfg = ref_smoke_config(arch)
    cfg = dataclasses.replace(get_smoke_config(arch), grad_accum=1)
    flat = _perturbed({k: np.asarray(v) for k, v in _flatten(
        build_model(rcfg).init(jax.random.PRNGKey(1))).items()}, 3)
    tree = stacked_from_reference(flat, cfg, device="cpu")
    shape = (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"layers": {"block0": {"k": torch.zeros(shape),
                                   "v": torch.zeros(shape)}}}
    tok = torch.from_numpy(_tokens(cfg, (2,), 5))
    pos = torch.tensor(3, dtype=torch.int32)
    batch = {k: torch.as_tensor(v) for k, v in TokenStream(
        cfg.vocab_size, 16, 2).batch(0).items()}
    opt = make_optimizer("adamw", lr=3e-4).init(tree)
    for kind, args, plain in (
            ("serve", (tree, cache, tok, pos),
             lambda: transformer.decode_step(cfg, tree, cache, tok, pos)),
            ("train", (tree, opt, batch),
             lambda: steps.make_train_step(cfg)(tree, opt, batch))):
        seq = 32 if kind == "serve" else 16
        prog = mapper.compile_arch(arch, kind, batch=2, seq_len=seq,
                                   config=cfg, expand_scans=True,
                                   device="cpu")
        waves = _counting(monkeypatch, "pim_mac_wave_ref")
        got = prog(*args)
        assert (prog.matmul_launches, prog.eltwise_launches,
                prog.eltwise_calls) == COMPILED[arch][kind == "train"]
        assert len(waves) == prog.eltwise_launches
        ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
        assert _leaves_equal(got, ex.run(*args))
        max_deviation(got, plain(), **TOL)


def test_pim_engine_matches_jit_engine():
    """chatglm3's rep-16 cut (32 q heads over 2 kv heads, half rope) and
    qwen3's head norm through ``ServeEngine(backend="pim")``: tokens
    identical to the jit engine's, over the kernel path."""
    for name in ("rep16", "qwen3-32b"):
        rcfg, cfg = _cfgs(name)
        flat = _perturbed({k: np.asarray(v) for k, v in _flatten(
            build_model(rcfg).init(jax.random.PRNGKey(2))).items()}, 4)
        model = params_from_reference(flat, cfg, device="cpu")
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (4, 7, 2)]
        outs = [_serve(ServeEngine, Request, cfg, model, prompts,
                       attn_kernel=True, backend=backend, device="cpu")[0]
                for backend in ("jit", "pim")]
        assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the bridge and what stays unported
# ---------------------------------------------------------------------------


def test_bridge_carries_the_variant_leaves(case):
    name, rcfg, cfg, rparams, flat, tree = case
    keys = set(transformer.leaf_shapes(cfg))
    assert {k for k in keys if "_bias" in k} == (
        {f"layers/block0/attn/{n}_bias" for n in "qkv"} if cfg.qkv_bias
        else set())
    assert {k for k in keys if "_norm" in k and "final" not in k} == (
        {f"layers/block0/attn/{n}_norm" for n in "qk"} if cfg.qk_norm
        else set())
    order = transformer.stack_leaves(cfg)
    assert list(order) == sorted(order)
    model = params_from_reference(flat, cfg, device="cpu")
    assert _leaves_equal(model.stacked_params(), tree)
    assert _leaves_equal(model_from_stacked(tree, cfg, device="cpu")
                         .stacked_params(), tree)
    ropt = ref_make_optimizer("adamw", lr=3e-4).init(rparams)
    opt = opt_state_from_reference(
        {k: np.asarray(v) for k, v in _flatten(ropt).items()}, cfg,
        device="cpu")
    assert pytree.tree_structure(opt) == pytree.tree_structure(
        steps.abstract_opt_state(cfg, steps.abstract_params(cfg)))
    # a tree without the config's variant leaves, or with leaves it has
    # not, is refused
    variant = {k for k in flat if k.endswith(("_bias", "q_norm", "k_norm"))}
    wrong = ({k: v for k, v in flat.items() if k not in variant} if variant
             else {**flat, "layers/block0/attn/q_bias": np.zeros(
                 (cfg.n_layers, 1), np.float32)})
    with pytest.raises(ValueError, match="differ"):
        stacked_from_reference(wrong, cfg, device="cpu")


@pytest.mark.parametrize("changes,item", [
    (dict(n_experts=4, top_k=2, moe_d_ff=32), "5.3"),
    (dict(block_pattern="xlstm"), "5.4"),
    # zamba2's shared block: one group a layer, no q/k/v biases
    (dict(block_pattern="mamba_shared_attn", ssm_state=16,
          shared_attn_every=1, qkv_bias=False), "5.4"),
    (dict(n_experts=4, top_k=1, moe_d_ff=32, moe_interleave=2), "5.3"),
    (dict(n_experts=4, top_k=2, moe_d_ff=32, shared_expert=True), "5.3")])
def test_check_ported_names_the_items_still_to_port(changes, item):
    """No item is left to refuse (``check_ported`` went with item 5.4b):
    each family serves and trains — MoE (item 5.3, 5.3b:
    tests/test_torch_moe*.py) and the recurrent patterns (item 5.4, 5.4b:
    tests/test_torch_recurrent*.py), whose train step takes an AdamW
    step here."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"), **changes)
    model = transformer.DecoderLM(cfg, device="cpu").init(0)
    if item == "5.4":
        tree = model.stacked_params()
        tokens = torch.from_numpy(_tokens(cfg, (2, 8)))
        _, opt, loss = steps.make_train_step(cfg)(
            tree, make_optimizer("adamw", lr=3e-4).init(tree),
            {"tokens": tokens, "labels": tokens})
        assert bool(torch.isfinite(loss)) and int(opt["step"]) == 1
        return
    tree = model.stacked_params()
    tokens = torch.from_numpy(_tokens(cfg, (2, 8)))
    logits = transformer.apply(cfg, tree, tokens)
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    grads, loss = torch.func.grad_and_value(steps.make_loss_fn(cfg))(
        tree, {"tokens": tokens, "labels": tokens})
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all())
               for g in pytree.tree_leaves(grads))
