"""Gradients and the train step of the dense attention variants (port
queue item 5.1) against the reference, on the cases of
``tests/test_torch_dense_variants.py`` (the three smoke configs, qwen3's
``head_dim=32`` cut and the rep-16 cut, with seeded non-zero biases and
norm scales away from one): the loss's gradients (``hidden_states``
under autograd: the written-out stack VJP, ``_LayerStack``) against
``jax.grad`` of the reference's loss within 1e-4 of each leaf's largest,
with full attention (seq 16) and chunked attention (seq 2560: the pair
scan); a train step's loss within 1e-4 and its parameters within
rtol = atol = 1e-4, without and with ``grad_accum=2`` under remat; and
``rope_style="none"``'s gradients on llama3-8b's smoke config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.models.transformer import build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch._tree import leaves_with_path
from repro_torch.checkpoint import stacked_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.optim import make_optimizer
from test_torch_dense_variants import _cfgs, _tokens, case  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# gradients and the train step
# ---------------------------------------------------------------------------


def _batch(cfg, b: int, s: int) -> dict:
    tokens = _tokens(cfg, (b, s), s)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}


def _assert_grads_close(got, want_tree):
    want = {k: np.asarray(v) for k, v in _flatten(want_tree).items()}
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
    name, _, _, rparams, flat, _ = case
    b, s, more = MODES[mode]
    rcfg, cfg = _cfgs(name, **more)
    batch = _batch(cfg, b, s)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tree = stacked_from_reference(flat, cfg, device="cpu")
    wl, wg = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(
        build_model(rcfg))))(rparams, batch)
    if mode != "accum_remat":
        # hidden_states under autograd: the written-out stack VJP
        gg, gl = torch.func.grad_and_value(steps.make_loss_fn(cfg))(tree,
                                                                    tbatch)
        assert abs(float(gl) - float(wl)) <= 1e-4
        _assert_grads_close(gg, wg)
    if mode == "chunked":
        return
    rstep = jax.jit(ref_steps.make_train_step(rcfg))
    rp, _, want = rstep(rparams, ref_make_optimizer("adamw", lr=3e-4).init(
        rparams), batch)
    params, _, got = steps.make_train_step(cfg)(
        tree, make_optimizer("adamw", lr=3e-4).init(tree), tbatch)
    assert abs(float(got) - float(want)) <= 1e-4
    # AdamW's first update is lr · g / (|g| + eps), about lr · sign(g): a
    # parameter whose gradient lies within the gradients' float32
    # rounding of 0 may move by up to 2 lr the other way. Every parameter
    # off the tolerance must be such a one
    wg = {k: np.asarray(v) for k, v in _flatten(wg).items()}
    want_p = {k: np.asarray(v) for k, v in _flatten(rp).items()}
    for key, p in leaves_with_path(params):
        off = ~np.isclose(p.numpy(), want_p[key], **TOL)
        g = np.abs(wg[key])
        assert (g[off] <= 1e-4 * g.max()).all(), key


def test_no_rope_gradients_match_reference():
    """``rope_style="none"`` (no published config uses it): the stack
    without rotation or tables, its gradients against the reference's on
    llama3-8b's smoke config so cut."""
    rcfg = dataclasses.replace(ref_smoke_config("llama3-8b"),
                               rope_style="none")
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              rope_style="none")
    flat = {k: np.asarray(v) for k, v in _flatten(build_model(rcfg).init(
        jax.random.PRNGKey(0))).items()}
    rparams = jax.tree.map(jnp.asarray, transformer.param_tree(flat))
    batch = _batch(cfg, 2, 16)
    wl, wg = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(
        build_model(rcfg))))(rparams, batch)
    gg, gl = torch.func.grad_and_value(steps.make_loss_fn(cfg))(
        stacked_from_reference(flat, cfg, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(gl) - float(wl)) <= 1e-4
    _assert_grads_close(gg, wg)
