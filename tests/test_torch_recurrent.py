"""The recurrent families for serving (port queue item 5.4, the serve
half) against the reference, at the smoke configs of xlstm-350m
(alternating mLSTM / sLSTM blocks, 2 units) and zamba2-7b (Mamba2 layers
with a weight-tied attention + MLP block every 2: 2 groups and a tail
layer), in float32, the reference's parameters carried across by the
bridge (rtol = atol = 1e-4 unless a line says otherwise):

* ``apply`` and ``hidden_states``; ``make_prefill_step``; zamba2 at seq
  2560, above ``CHUNKED_ATTN_THRESHOLD`` (its shared attention on the
  chunked pair scan);
* 8 contiguous ``decode_step``s: logits, greedy tokens and the new
  states and KV, leaf by leaf;
* decode == prefill inside the port within the reference's own 2e-3 /
  2e-2 (``tests/test_arch_smoke.py``);
* the bridge both ways (a missing, an extra and a misshapen leaf
  refused), the module's tree shared with the module, the published
  trees' sizes on meta tensors;
* ``DecoderLM`` on CUDA by default; the differentiated stack and the
  train step refused naming item 5.4b; the paged entry points refused
  with the reference's ``NotImplementedError``.

The engine is held in ``tests/test_torch_recurrent_serve.py``, the
schedules in ``tests/test_torch_recurrent_schedules.py``, the blocks in
``tests/test_torch_ssm.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.models.transformer import build_model
from repro_torch._tree import leaves_with_path
from repro_torch.checkpoint import (model_from_stacked,
                                    params_from_reference,
                                    stacked_from_reference)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.optim import make_optimizer
from repro_torch.serve import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("xlstm-350m", "zamba2-7b")


@functools.cache
def _reference(arch: str):
    """(reference config, port config, the reference's params, the
    flattened numpy params, the port's tree), made once an arch."""
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    # jitted: the eager init of zamba2's vmapped groups takes ~10 s
    rparams = jax.jit(build_model(rcfg).init)(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(rparams).items()}
    return rcfg, cfg, rparams, flat, stacked_from_reference(flat, cfg,
                                                            device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _reference(request.param)


def _tokens(cfg, shape, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_forward_hidden_states_and_prefill_match_reference(case):
    rcfg, cfg, rparams, _, tree = case
    model = build_model(rcfg)
    tokens = _tokens(cfg, (2, 32))
    want = model.apply(rparams, tokens=jnp.asarray(tokens))
    got = transformer.apply(cfg, tree, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_h = model.hidden_states(rparams, tokens=jnp.asarray(tokens))
    got_h = transformer.hidden_states(cfg, tree, torch.from_numpy(tokens))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    want_last = ref_steps.make_prefill_step(rcfg)(
        rparams, {"tokens": jnp.asarray(tokens)})
    got_last = steps.make_prefill_step(cfg)(
        tree, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **TOL)


def test_decode_steps_match_reference(case):
    rcfg, cfg, rparams, _, tree = case
    model = build_model(rcfg)
    step = jax.jit(model.decode_step)
    batch, max_len = 4, 16
    ref_cache = model.init_cache(batch, max_len)
    cache = transformer.DecoderLM(cfg, device="cpu").init_cache(batch,
                                                                max_len)
    assert [p for p, _ in leaves_with_path(cache)] == sorted(
        _flatten(ref_cache))
    first = _tokens(cfg, (batch,), 0)
    rtok, tok = jnp.asarray(first), torch.from_numpy(first)
    for p in range(8):
        want, ref_cache = step(rparams, ref_cache, rtok, jnp.int32(p))
        got, cache = transformer.decode_step(
            cfg, tree, cache, tok, torch.tensor(p, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        rtok = jnp.argmax(want, -1).astype(jnp.int32)
        tok = got.argmax(-1).to(torch.int32)
        assert np.array_equal(tok.numpy(), np.asarray(rtok))
    want_leaves = _flatten(ref_cache)
    for path, leaf in leaves_with_path(cache):
        assert leaf.dtype == torch.float32 or path.endswith(("/k", "/v"))
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(want_leaves[path]),
                                   err_msg=path, **TOL)


def test_decode_consistent_with_prefill(case):
    """Greedy decode logits == the full-sequence logits position by
    position, at the reference's own tolerance."""
    _, cfg, _, _, tree = case
    s, b = 8, 2
    toks = torch.from_numpy(_tokens(cfg, (b, s), 4))
    full = transformer.apply(cfg, tree, toks)
    cache = transformer.DecoderLM(cfg, device="cpu").init_cache(b, s)
    for t in range(s):
        lg, cache = transformer.decode_step(
            cfg, tree, cache, toks[:, t], torch.tensor(t, dtype=torch.int32))
        torch.testing.assert_close(lg, full[:, t], atol=2e-3, rtol=2e-2)


def test_zamba2_forward_above_2048_matches_reference():
    """seq 2560: the shared attention on the chunked pair scan, the
    Mamba2 layers on 20 chunks of 128."""
    rcfg, cfg, rparams, _, tree = _reference("zamba2-7b")
    tokens = _tokens(cfg, (1, 2560), 6)
    want = ref_steps.make_prefill_step(rcfg)(
        rparams, {"tokens": jnp.asarray(tokens)})
    got = steps.make_prefill_step(cfg)(tree,
                                       {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bridge_carries_the_trees_both_ways(case):
    _, cfg, _, flat, tree = case
    model = params_from_reference(flat, cfg, device="cpu")
    assert sorted(p for p, _ in leaves_with_path(model.stacked_params())
                  ) == sorted(transformer.leaf_shapes(cfg))
    for key, leaf in leaves_with_path(model.stacked_params()):
        np.testing.assert_array_equal(leaf.numpy(), flat[key], err_msg=key)
    again = model_from_stacked(tree, cfg, device="cpu")
    for (key, a), (_, b) in zip(leaves_with_path(again.stacked_params()),
                                leaves_with_path(tree), strict=True):
        assert torch.equal(a, b), key
    # the layer modules hold the slices: xlstm's layer 2u + 1 is unit u's
    # sLSTM, zamba2's layer u·every + j group u's Mamba2 layer j, the tail
    # after the groups, the shared block once
    if cfg.block_pattern == "xlstm":
        np.testing.assert_array_equal(model.layers[3].r_z.numpy(),
                                      flat["layers/slstm/r_z"][1])
    else:
        e = cfg.shared_attn_every
        np.testing.assert_array_equal(model.layers[e + 1].w_in.numpy(),
                                      flat["layers/mamba/w_in"][1, 1])
        np.testing.assert_array_equal(model.layers[-1].w_out.numpy(),
                                      flat["tail_layers/mamba/w_out"][-1])
        np.testing.assert_array_equal(model.shared.attn.wq.numpy(),
                                      flat["shared_attn/wq"])
    # the shared tree: the module's parameters become views of its leaves
    shared = model.shared_stacked_params()
    stacked = "layers/mlstm/w_q" if cfg.block_pattern == "xlstm" else \
        "layers/mamba/w_in"
    leaf = transformer.leaf_at(shared, stacked)
    assert model.layers[0].get_parameter(stacked.rsplit("/", 1)[1]
                                         ).data_ptr() == leaf.data_ptr()
    assert model.shared_stacked_params() is shared


def test_bridge_refuses_missing_extra_and_misshapen_leaves(case):
    _, cfg, _, flat, _ = case
    key = next(k for k in flat if k.startswith("layers/"))
    missing = {k: v for k, v in flat.items() if k != key}
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(missing, cfg, device="cpu")
    with pytest.raises(ValueError, match="differ"):
        stacked_from_reference(missing, cfg, device="cpu")
    extra = {**flat, "layers/mlstm/w_x": flat["embed/table"]}
    with pytest.raises(ValueError, match="not ported"):
        params_from_reference(extra, cfg, device="cpu")
    with pytest.raises(ValueError, match="differ"):
        stacked_from_reference(extra, cfg, device="cpu")
    bad = {**flat, key: flat[key][..., :1]}
    with pytest.raises(ValueError, match=key):
        params_from_reference(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match=key):
        stacked_from_reference(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_published_trees_equal_the_reference_on_meta(arch):
    """The published configs' trees, leaf by leaf, on meta tensors (the
    reference's through ``jax.eval_shape``): 292.0 M and 6.787 B
    parameters."""
    cfg = get_config(arch)
    want = jax.eval_shape(lambda: build_model(ref_config(arch)).init(
        jax.random.PRNGKey(0)))
    want = {"/".join(k.key for k in path): tuple(v.shape) for path, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    assert transformer.leaf_shapes(cfg) == {k: want[k] for k in
                                            transformer.leaf_shapes(cfg)}
    assert set(want) == set(transformer.leaf_shapes(cfg))
    model = transformer.DecoderLM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in want.values())
    assert n == {"xlstm-350m": 291_988_576, "zamba2-7b": 6_787_076_688}[arch]
    assert len(model.layers) == cfg.n_layers
    assert transformer.tail_units(cfg) == (3 if arch == "zamba2-7b" else 0)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            transformer.DecoderLM(get_smoke_config(arch))
        transformer.DecoderLM(get_smoke_config(arch), device="cpu")


def test_differentiated_stack_and_train_step_raise_naming_item_5_4b(case):
    """Item 5.4b is ported: the entry points that refused (naming it)
    until then train. ``make_train_step`` takes an AdamW step with a
    finite loss, a differentiated ``hidden_states`` (the written-out
    stack, ``transformer._RecurrentStack``) gives finite gradients, and
    the same tree still serves undifferentiated (the gradients against
    the reference's: ``tests/test_torch_recurrent_train*.py``)."""
    _, cfg, _, _, tree = case
    # batch 2: zamba2's published grad_accum=2 splits it in microbatches
    toks = torch.from_numpy(_tokens(cfg, (2, 4)))
    _, opt, loss = steps.make_train_step(cfg)(
        tree, make_optimizer("adamw", lr=3e-4).init(tree),
        {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(loss)) and int(opt["step"]) == 1
    grads, loss = torch.func.grad_and_value(steps.make_loss_fn(cfg))(
        tree, {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all())
               for _, g in leaves_with_path(grads))
    table = tree["embed"]["table"].clone().requires_grad_()
    hidden = transformer.hidden_states(
        cfg, {**tree, "embed": {"table": table}}, toks)
    hidden.square().sum().backward()
    assert table.grad is not None and bool(torch.isfinite(table.grad).all())
    # undifferentiated, the same tree serves
    with torch.no_grad():
        assert transformer.hidden_states(cfg, tree, toks).shape == (
            2, 4, cfg.d_model)


def test_paged_entry_points_raise_the_reference_errors(case):
    _, cfg, _, _, tree = case
    model = transformer.DecoderLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="holds recurrent state"):
        model.init_paged_cache(8, 4)
    ints = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged decode requires"):
        model.decode_step_paged({}, ints, ints[:, None], ints)
    with pytest.raises(NotImplementedError, match="paged decode requires"):
        transformer.decode_step_paged(cfg, tree, {}, ints, ints[:, None],
                                      ints)
    with pytest.raises(NotImplementedError, match="paged prefill requires"):
        model.prefill_paged({}, ints, ints, 0, 1)
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        ServeEngine(cfg, model, paged=True, device="cpu")
