"""The model's inputs and outputs (port queue item 5.2) against the
reference: musicgen-medium's frame-embedding inputs and qwen2-vl-2b's
embedding inputs, M-RoPE over a (t, h, w) position grid and LM head tied
to the embedding table.

Every parity test runs on the smoke configs of both (2 layers, narrow
widths), the parameters the reference's init handed to both frameworks
through ``checkpoint.bridge``, the inputs made from a seed with numpy.
qwen2-vl's sequences run under a grid whose rows differ (``_grid``: text
positions, then an image block with t constant and h / w stepping over a
2-D patch grid, then text again), so a port that ignored the sections, or
read one row for all three, would fail. Tolerance rtol = atol = 1e-4.

* the forward logits (``apply``) with embeddings and with token ids,
  ``make_prefill_step``, and at seq 2560 (above
  ``CHUNKED_ATTN_THRESHOLD``: the chunked attention);
* the contiguous ``decode_step`` with token ids and with [B, 1, D]
  embeddings: greedy tokens identical, logits within 1e-4;
* paged serving (``ServeEngine``, kernel and gather paths, batch
  prefill) over fp32 and int8 pools: tokens identical to the reference's
  engine, fp32 logits within 1e-4; ``ServeEngine(backend="pim")``
  token-identical to the jit engine;
* the loss's gradients against ``jax.grad`` (full attention, chunked,
  and ``grad_accum=2`` under remat), qwen2-vl's tied table's through the
  head, musicgen's unused table's zero; a train step's parameters,
  the zero-gradient table's AdamW move included;
* the compiled decode and train steps (``compile_arch``, expanded) bit
  for bit against the per-block executor and within 1e-4 of the plain
  step;
* the bridge: a tied tree has no ``lm_head``, both ways, AdamW state too.

The schedules are held in ``tests/test_torch_io_schedules.py``.
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
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.launch import steps as ref_steps
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
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.mapper.executor import max_deviation
from repro_torch.models import transformer
from repro_torch.optim import make_optimizer
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("musicgen-medium", "qwen2-vl-2b")


def _cfgs(arch: str, **changes):
    return (dataclasses.replace(ref_smoke_config(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(arch, reference config, port config, the reference's params tree,
    the flattened numpy params, the port's tree)."""
    rcfg, cfg = _cfgs(request.param)
    init = build_model(rcfg).init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(init).items()}
    rparams = jax.tree.map(jnp.asarray, transformer.param_tree(flat))
    return (request.param, rcfg, cfg, rparams, flat,
            stacked_from_reference(flat, cfg, device="cpu"))


def _tokens(cfg, shape, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _embeds(cfg, shape, seed=3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def _grid(b: int, s: int, seed: int = 4) -> np.ndarray:
    """A qwen2-vl position grid [3, B, S]: per row, ``n0`` text tokens
    (t = h = w = i), an image of ``ph`` x ``pw`` patches at t = n0, h = n0
    + i, w = n0 + j, then text from one past the image's largest position
    on; ``n0`` and the image's height differ by row."""
    rng = np.random.default_rng(seed)
    g = np.zeros((3, b, s), np.int32)
    for row in range(b):
        n0 = int(rng.integers(1, max(2, s // 4)))
        ph = int(rng.integers(2, 5))
        pw = max(1, (s - n0) // (2 * ph))
        img = np.stack([np.full((ph, pw), n0),
                        n0 + np.arange(ph)[:, None].repeat(pw, 1),
                        n0 + np.arange(pw)[None].repeat(ph, 0)]).reshape(3, -1)
        n_img = img.shape[1]
        after = s - n0 - n_img
        start = img.max() + 1
        g[:, row] = np.concatenate([
            np.broadcast_to(np.arange(n0), (3, n0)), img,
            np.broadcast_to(start + np.arange(after), (3, after))], 1)
    assert (g[0] != g[1]).any() and (g[1] != g[2]).any()
    return g


def _inputs(cfg, b: int, s: int, kind: str) -> dict:
    """The model's keyword inputs: ``embeds`` or ``tokens``, and a
    position grid under M-RoPE."""
    out = ({"embeds": _embeds(cfg, (b, s))} if kind == "embeds"
           else {"tokens": _tokens(cfg, (b, s))})
    if cfg.needs_position_grid:
        out["positions"] = _grid(b, s)
    return out


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["embeds", "tokens"])
def test_forward_and_prefill_match_reference(case, kind):
    arch, rcfg, cfg, rparams, flat, tree = case
    model = build_model(rcfg)
    inputs = _inputs(cfg, 2, 16, kind)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    want = model.apply(rparams, **{k: jnp.asarray(v)
                                   for k, v in inputs.items()})
    got = transformer.apply(cfg, tree, **tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the default positions: the arange (broadcast to the grid)
    np.testing.assert_allclose(
        transformer.apply(cfg, tree, **{k: v for k, v in tin.items()
                                        if k != "positions"}).numpy(),
        np.asarray(model.apply(rparams, **{k: jnp.asarray(v)
                                           for k, v in inputs.items()
                                           if k != "positions"})), **TOL)
    if kind == "embeds":
        batch = {**inputs, "labels": _tokens(cfg, (2, 16))}
        want_last = ref_steps.make_prefill_step(rcfg)(
            rparams, {k: jnp.asarray(v) for k, v in batch.items()})
        got_last = steps.make_prefill_step(cfg)(
            tree, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                                   **TOL)
    if cfg.needs_position_grid:
        # the grid matters: every row set to the text positions differs
        flat_grid = dict(tin, positions=tin["positions"][0:1].expand(
            3, -1, -1))
        assert not torch.allclose(transformer.apply(cfg, tree, **flat_grid),
                                  got, **TOL)


def test_chunked_forward_matches_reference(case):
    """Seq 2560, a multiple of 512 above ``CHUNKED_ATTN_THRESHOLD``: the
    chunked attention, the embeddings and (qwen2-vl) a grid at that
    length."""
    arch, rcfg, cfg, rparams, flat, tree = case
    inputs = _inputs(cfg, 1, 2560, "embeds")
    want = build_model(rcfg).hidden_states(
        rparams, **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = transformer.hidden_states(
        cfg, tree, **{k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["tokens", "embeds"])
def test_decode_step_greedy_matches_reference(case, kind):
    """The contiguous ``decode_step``: token ids fed back greedily, or a
    fresh [B, 1, D] embedding each step (the stub frontend's frame)."""
    arch, rcfg, cfg, rparams, _, tree = case
    model = build_model(rcfg)
    step = jax.jit(model.decode_step)
    batch, max_len = 2, 16
    ref_cache = model.init_cache(batch, max_len)
    cache = {"layers": {"block0": {
        k: torch.zeros(tuple(v.shape)) for k, v in transformer.DecoderLM(
            cfg, device="meta").init_cache(batch, max_len)["layers"][
                "block0"].items()}}}
    first = _tokens(cfg, (batch,), 0)
    frames = _embeds(cfg, (6, batch, 1))
    rtok, tok = jnp.asarray(first), torch.from_numpy(first)
    for p in range(6):
        if kind == "embeds":
            rtok, tok = jnp.asarray(frames[p]), torch.from_numpy(frames[p])
        want, ref_cache = step(rparams, ref_cache, rtok, jnp.int32(p))
        got, cache = transformer.decode_step(
            cfg, tree, cache, tok, torch.tensor(p, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert np.array_equal(got.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(want, -1)))
        rtok = jnp.argmax(want, -1).astype(jnp.int32)
        tok = got.argmax(-1).to(torch.int32)


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
    arch, rcfg, cfg, rparams, flat, _ = case
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


def test_pim_engine_matches_jit_engine(case):
    """``ServeEngine(backend="pim")``: the mapped paged tick, the tied
    head on K1 (qwen2-vl) and K4 at rep 1 (musicgen) and rep 2 (the
    smoke qwen2-vl), token-identical to the jit engine."""
    arch, rcfg, cfg, rparams, flat, _ = case
    model = params_from_reference(flat, cfg, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 7, 2)]
    outs = [_serve(ServeEngine, Request, cfg, model, prompts,
                   attn_kernel=True, backend=backend, device="cpu")[0]
            for backend in ("jit", "pim")]
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# gradients and the train step
# ---------------------------------------------------------------------------


def _batch(cfg, b: int, s: int) -> dict:
    batch = {"embeds": _embeds(cfg, (b, s), s),
             "labels": _tokens(cfg, (b, s), s)}
    if cfg.needs_position_grid:
        batch["positions"] = _grid(b, s, s)
    return batch


def _assert_grads_close(got, want_tree):
    want = {k: np.asarray(v) for k, v in _flatten(want_tree).items()}
    assert {k for k, _ in leaves_with_path(got)} == set(want)
    for key, g in leaves_with_path(got):
        w = want[key]
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (key, err)


# mode -> (batch, seq, config changes)
MODES = {"full": (2, 16, dict(grad_accum=1)),
         "chunked": (1, 2560, dict(grad_accum=1)),
         "accum_remat": (2, 16, dict(grad_accum=2, remat=True))}


@pytest.mark.parametrize("mode", list(MODES))
def test_gradients_and_train_step_match_reference(case, mode):
    arch, _, _, rparams, flat, _ = case
    b, s, more = MODES[mode]
    rcfg, cfg = _cfgs(arch, **more)
    batch = _batch(cfg, b, s)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tree = stacked_from_reference(flat, cfg, device="cpu")
    loss_fn = ref_steps.make_loss_fn(build_model(rcfg))
    wl, wg = jax.jit(jax.value_and_grad(loss_fn))(rparams, batch)
    gg, gl = torch.func.grad_and_value(steps.make_loss_fn(cfg))(tree, tbatch)
    assert abs(float(gl) - float(wl)) <= 1e-4
    _assert_grads_close(gg, wg)
    table = gg["embed"]["table"]
    if cfg.input_embed_stub and not cfg.tie_embeddings:
        # musicgen: the table is unused under embeddings, its gradient 0
        assert table is not None and not table.any()
    else:
        # qwen2-vl: the tied table's gradient comes through the head
        assert table.abs().max() > 0
    if mode == "chunked":
        return
    rstep = jax.jit(ref_steps.make_train_step(rcfg))
    rp, ropt, want = rstep(rparams, ref_make_optimizer(
        "adamw", lr=3e-4).init(rparams), batch)
    params, opt, got = steps.make_train_step(cfg)(
        tree, make_optimizer("adamw", lr=3e-4).init(tree), tbatch)
    assert abs(float(got) - float(want)) <= 1e-4
    # AdamW's first update is lr · g / (|g| + eps), about lr · sign(g): a
    # parameter whose gradient lies within the gradients' float32
    # rounding of 0 may move by up to 2 lr the other way. Every parameter
    # off the tolerance must be such a one; a leaf whose gradient is 0
    # throughout (musicgen's table) moves by the decay alone, as the
    # reference's, and its moments stay 0
    wg = {k: np.asarray(v) for k, v in _flatten(wg).items()}
    want_p = {k: np.asarray(v) for k, v in _flatten(rp).items()}
    for key, p in leaves_with_path(params):
        g = np.abs(wg[key])
        if not g.any():
            np.testing.assert_allclose(p.numpy(), want_p[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)
            assert not (p.numpy() == flat[key]).all(), key
            continue
        off = ~np.isclose(p.numpy(), want_p[key], **TOL)
        assert (g[off] <= 1e-4 * g.max()).all(), key
    want_m = {k: np.asarray(v) for k, v in _flatten(ropt["m"]).items()}
    for key, m in leaves_with_path(opt["m"]):
        if not wg[key].any():
            assert not m.any() and not want_m[key].any(), key


# ---------------------------------------------------------------------------
# the compiled steps
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
# train: the same) on the CPU, the kernels' plain versions counted;
# musicgen's train step at batch 2 launches each layer's attention output
# product on K1 too (the reference's unbatched dot_general with wo, where
# a [B, S, H·hd] view of the heads' layout once traced as a batched bmm)
COMPILED = {"musicgen-medium": ((15, 35, 51), (42, 148, 254)),
            "qwen2-vl-2b": ((15, 43, 59), (42, 146, 247))}


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_steps_equal_executor_and_plain_step(arch, monkeypatch):
    rcfg, cfg = _cfgs(arch)
    flat = {k: np.asarray(v) for k, v in _flatten(
        build_model(rcfg).init(jax.random.PRNGKey(1))).items()}
    tree = stacked_from_reference(flat, cfg, device="cpu")
    shape = (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"layers": {"block0": {"k": torch.zeros(shape),
                                   "v": torch.zeros(shape)}}}
    tok = torch.from_numpy(_tokens(cfg, (2,), 5))
    pos = torch.tensor(3, dtype=torch.int32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 16).items()}
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


# ---------------------------------------------------------------------------
# the bridge and what stays unported
# ---------------------------------------------------------------------------


def test_bridge_carries_a_tied_tree(case):
    arch, rcfg, cfg, rparams, flat, tree = case
    keys = set(transformer.leaf_shapes(cfg))
    assert keys == set(flat)
    assert ("lm_head/w" in keys) == (not cfg.tie_embeddings)
    model = params_from_reference(flat, cfg, device="cpu")
    assert (model.lm_head is None) == cfg.tie_embeddings
    assert _leaves_equal(model.stacked_params(), tree)
    assert _leaves_equal(model_from_stacked(tree, cfg, device="cpu")
                         .stacked_params(), tree)
    ropt = ref_make_optimizer("adamw", lr=3e-4).init(rparams)
    opt = opt_state_from_reference(
        {k: np.asarray(v) for k, v in _flatten(ropt).items()}, cfg,
        device="cpu")
    assert pytree.tree_structure(opt) == pytree.tree_structure(
        steps.abstract_opt_state(cfg, steps.abstract_params(cfg)))
    # a head the config ties away, or one it lacks, is refused
    wrong = ({**flat, "lm_head/w": np.zeros((cfg.d_model, cfg.vocab_size),
                                            np.float32)}
             if cfg.tie_embeddings else
             {k: v for k, v in flat.items() if k != "lm_head/w"})
    with pytest.raises((ValueError, KeyError)):
        params_from_reference(wrong, cfg, device="cpu")
    with pytest.raises(ValueError, match="differ"):
        stacked_from_reference(wrong, cfg, device="cpu")


def test_input_specs_follow_the_reference(case):
    """The traced batch: the reference's keys in its (sorted) order, the
    embeddings in the model dtype, the grid [3, B, S] int32."""
    arch, rcfg, cfg, *_ = case
    shape = steps.ShapeSpec("m", 8, 2, "train")
    want = ref_steps.input_specs(rcfg, RefShapeSpec("m", 8, 2, "train"))
    got = steps.input_specs(cfg, shape)
    assert list(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
