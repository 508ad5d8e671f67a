"""The chunked (flash) attention above seq 2048 and the prefill step in the
port against the reference's.

* ``attention.flash_attention_pair`` and ``flash_attention_xla``: the
  forward against the reference's functions and the port's
  ``full_causal_attention`` (the reference's tolerance, atol 2e-5 and rtol
  1e-5), the gradients of their written-out VJPs against ``jax.vjp`` of
  the reference's custom VJPs (atol 3e-5, rtol 1e-4), at GQA rep 2 and 4;
  a sequence that is not a multiple of the chunk raises, as the
  reference's reshape fails there;
* ``attention_block(chunked=True)``, ``transformer.hidden_states`` /
  ``apply`` and ``steps.make_prefill_step`` at the smoke config, seq 2560
  (five chunks of 512), within 1e-4 of the reference.

The schedules of these steps are held in ``test_torch_long_schedules.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attention
from repro.models.transformer import build_model
from repro_torch.checkpoint import stacked_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import attention, transformer
from test_torch_arch_train import _flat_np

SEQ = 2560
TOL = dict(rtol=1e-4, atol=1e-4)

FLASH = {
    "pair": (lambda q, k, v, c: ref_attention.flash_attention_pair(
        q, k, v, c), lambda q, k, v, c: attention.flash_attention_pair(
        q, k, v, c)),
    "xla": (lambda q, k, v, c: ref_attention.flash_attention_xla(
        q, k, v, c, c), lambda q, k, v, c: attention.flash_attention_xla(
        q, k, v, c, c)),
}


def _qkv(rep: int, s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, g, d = 2, 2, 8
    q = rng.standard_normal((b, s, g * rep, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, g, d)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("rep", [2, 4])
@pytest.mark.parametrize("variant", sorted(FLASH))
def test_flash_forward_matches_reference(variant, rep):
    ref_fn, port_fn = FLASH[variant]
    q, k, v, _ = _qkv(rep, 64)
    got = port_fn(*map(torch.from_numpy, (q, k, v)), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_fn(q, k, v, 16)),
                               atol=2e-5, rtol=1e-5)
    full = attention.full_causal_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5,
                               rtol=1e-5)
    # one chunk: the whole sequence a single (diagonal) tile
    np.testing.assert_allclose(
        port_fn(*map(torch.from_numpy, (q, k, v)), 64).numpy(),
        full.numpy(), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("rep", [2, 4])
@pytest.mark.parametrize("variant", sorted(FLASH))
def test_flash_gradients_match_reference(variant, rep):
    ref_fn, port_fn = FLASH[variant]
    q, k, v, dout = _qkv(rep, 48, seed=rep)
    _, vjp = jax.vjp(lambda a, b, c: ref_fn(a, b, c, 16), q, k, v)
    want = vjp(dout)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(port_fn(*leaves, 16), leaves,
                              torch.from_numpy(dout))
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("variant", sorted(FLASH))
def test_chunk_not_dividing_the_sequence_raises(variant):
    _, port_fn = FLASH[variant]
    q, k, v, _ = _qkv(2, 40)
    with pytest.raises(ValueError, match="multiple of the attention chunk"):
        port_fn(*map(torch.from_numpy, (q, k, v)), 16)


@pytest.fixture(scope="module")
def smoke():
    rcfg = ref_smoke_config("llama3-8b")
    ref_params = build_model(rcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("llama3-8b")
    tree = stacked_from_reference(_flat_np(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, SEQ)).astype(np.int32)
    return rcfg, ref_params, cfg, tree, tokens


def test_hidden_states_apply_and_prefill_above_2048(smoke):
    rcfg, ref_params, cfg, tree, tokens = smoke
    model = build_model(rcfg)
    want_h = model.hidden_states(ref_params, tokens=jnp.asarray(tokens))
    want = model.apply(ref_params, tokens=jnp.asarray(tokens))
    want_last = ref_steps.make_prefill_step(rcfg)(
        ref_params, {"tokens": jnp.asarray(tokens)})
    lm = transformer.DecoderLM(cfg, device="meta")
    t = torch.from_numpy(tokens)
    np.testing.assert_allclose(lm.hidden_states(tree, t).numpy(),
                               np.asarray(want_h), **TOL)
    got = lm.apply(tree, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    last = steps.make_prefill_step(cfg)(tree, {"tokens": t})
    assert last.shape == (1, cfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), **TOL)
    assert torch.equal(last, got[:, -1])


def test_attention_block_chunked_matches_reference(smoke):
    rcfg, ref_params, cfg, _, _ = smoke
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, SEQ, rcfg.d_model)).astype(np.float32)
    pos = np.arange(SEQ, dtype=np.int32)[None]
    attn = {k: np.array(v[0]) for k, v in
            ref_params["layers"]["block0"]["attn"].items()}
    want = ref_attention.attention_block(x, attn, rcfg, pos, chunked=True)
    got = attention.attention_block(
        torch.from_numpy(x), {k: torch.from_numpy(v)
                              for k, v in attn.items()}, cfg,
        torch.from_numpy(pos), chunked=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
