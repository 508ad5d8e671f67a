"""The port's decode step against a contiguous cache, against the
reference's.

``DecoderLM.decode_step`` on both sides over the reference's seeded
parameters (carried across by ``checkpoint.bridge.stacked_from_reference``),
llama3-8b's smoke config (float32), batch 2, a 32-token cache: 8 greedy
steps from the same first tokens, the logits of every step within the
reference's rtol = atol = 1e-4, the tokens identical, and the updated
cache after every step within the same tolerance. The cache update is
the reference's ``dynamic_update_slice_in_dim`` at a negative position
and one past the end too, and the module's own weights, its stacked tree
and the bridge agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.transformer import build_model
from repro_torch.checkpoint import (model_from_stacked, params_from_reference,
                                    stacked_from_reference)
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, transformer
from repro_torch.models.transformer import DecoderLM

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, MAX_LEN, STEPS = 2, 32, 8


@pytest.fixture(scope="module")
def ref_and_port():
    rcfg = ref_smoke_config("llama3-8b")
    model = build_model(rcfg)
    params = model.init(jax.random.PRNGKey(0))
    flat = _flatten(params)
    cfg = get_smoke_config("llama3-8b")
    return model, params, flat, cfg, stacked_from_reference(flat, cfg,
                                                            device="cpu")


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_greedy_steps_and_cache_match_reference(ref_and_port):
    model, params, _, cfg, tree = ref_and_port
    step = jax.jit(model.decode_step)
    ref_cache = model.init_cache(BATCH, MAX_LEN)
    port = DecoderLM(cfg, device="meta")
    cache = {"layers": {"block0": {
        name: torch.zeros(tuple(t.shape), dtype=t.dtype)
        for name, t in port.init_cache(BATCH, MAX_LEN)["layers"][
            "block0"].items()}}}
    first = np.random.default_rng(0).integers(0, cfg.vocab_size, BATCH,
                                              dtype=np.int32)
    ref_tok, tok = jnp.asarray(first), torch.from_numpy(first)
    for p in range(STEPS):
        want, ref_cache = step(params, ref_cache, ref_tok, jnp.int32(p))
        got, cache = transformer.decode_step(cfg, tree, cache, tok,
                                             torch.tensor(p, dtype=torch.int32))
        assert got.shape == (BATCH, cfg.vocab_size)
        _close(got, want)
        for name in ("k", "v"):
            _close(cache["layers"]["block0"][name],
                   ref_cache["layers"]["block0"][name])
        ref_tok = jnp.argmax(want, -1).astype(jnp.int32)
        tok = got.argmax(-1).to(torch.int32)
        assert np.array_equal(tok.numpy(), np.asarray(ref_tok))


@pytest.mark.parametrize("pos", [-1, 0, 31, 40])
def test_cache_update_is_dynamic_update_slice(pos):
    rng = np.random.default_rng(pos % 7)
    cache = rng.standard_normal((2, 32, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
    want = jax.lax.dynamic_update_slice_in_dim(
        jnp.asarray(cache), jnp.asarray(new), jnp.int32(pos), axis=1)
    got = attention._updated(torch.from_numpy(cache), torch.from_numpy(new),
                             torch.tensor(pos, dtype=torch.int32))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_module_tree_and_bridge_agree(ref_and_port):
    _, _, flat, cfg, tree = ref_and_port
    model = params_from_reference(flat, cfg, device="cpu")
    stacked = model.stacked_params()
    assert torch.utils._pytree.tree_structure(stacked) == \
        torch.utils._pytree.tree_structure(tree)
    for a, b in zip(torch.utils._pytree.tree_leaves(stacked),
                    torch.utils._pytree.tree_leaves(tree), strict=True):
        assert torch.equal(a, b)
    again = model_from_stacked(tree, cfg, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters(), strict=True):
        assert torch.equal(a, b), n
    cache = model.init_cache(BATCH, MAX_LEN)
    assert cache["layers"]["block0"]["k"].shape == (
        cfg.n_layers, BATCH, MAX_LEN, cfg.n_kv_heads, cfg.resolved_head_dim)
    tok = torch.tensor([1, 2], dtype=torch.int32)
    pos = torch.tensor(0, dtype=torch.int32)
    got = model.decode_step(stacked, cache, tok, pos)[0]
    assert torch.equal(got, transformer.decode_step(cfg, tree, cache, tok,
                                                    pos)[0])
    with pytest.raises(ValueError, match="differ"):
        stacked_from_reference({k: v for k, v in flat.items()
                                if k != "lm_head/w"}, cfg, device="cpu")
