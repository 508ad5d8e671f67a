"""The recurrent train step (port queue item 5.4b) against the reference:
xlstm-350m and zamba2-7b at their smoke configs, in float32, from the
reference's own init handed across (``checkpoint.stacked_from_reference``)
with its constant leaves seeded away from their init (``f_bias``,
``dt_bias``, ``a_log``, ``d_skip`` and every norm scale; the init makes
them constants, under which a leaf's VJP could be wrong unseen; ``a_log``
near -1, see ``_reference_init``):

* the gradient of every leaf of ``make_loss_fn`` within 1e-4 of the
  leaf's largest against ``jax.grad`` of the reference's loss, at the
  smoke rows: xlstm at seq 16, with remat, at seq 512 (two mLSTM
  chunks), with ``grad_accum=2``; zamba2 at seq 16 (its published
  ``grad_accum=2``), with remat, with ``grad_accum=1`` and at seq 256
  (two Mamba2 chunks). zamba2 at seq 2560 (the shared block's chunked
  attention) and inputs that tie are in
  ``tests/test_torch_recurrent_train_long.py``. The
  port's stack (``transformer._RecurrentStack``) is the reference's
  linearized forward and transpose, op for op (``models.lin``): where
  torch's derivative rules differ from JAX's, JAX's hold (``max`` at a
  tie, ``abs`` at 0, the initial ``m`` of -1e30);
* ``transformer.hidden_states`` differentiated by autograd (the stack's
  VJP) against ``torch.func`` of the undifferentiated stack's own ops
  (``_forward_recurrent``), and the turned-around refusals: the train
  step runs for every block pattern.

Two AdamW steps against the reference's and the compiled step are in
``tests/test_torch_recurrent_train_step.py``, the schedules in
``tests/test_torch_recurrent_train_schedules*.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.models.transformer import build_model
from repro_torch._tree import leaves_with_path, tree_map
from repro_torch.checkpoint import stacked_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import layers, transformer
from repro_torch.optim import make_optimizer

XLSTM, ZAMBA2 = "xlstm-350m", "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
# leaves the reference's init makes constants: seeded away from them
SEEDED = ("f_bias", "dt_bias", "a_log", "d_skip", "scale")


def configs(arch, **changes):
    return (dataclasses.replace(ref_smoke_config(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def token_batch(cfg, batch: int, seq: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32) for name in ("tokens", "labels")}


@functools.cache
def _reference_init(arch: str):
    """The reference's smoke init, its constant leaves seeded."""
    rp = jax.jit(build_model(ref_smoke_config(arch)).init)(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def seeded(path, leaf):
        key = jax.tree_util.keystr(path)
        if any(f"'{name}'" in key for name in SEEDED):
            # a_log near -1: A = -exp(a_log) keeps a 128-token chunk's
            # decays exp(A_t - A_s) finite above its diagonal, which the
            # reference's select masks only after the exp (at A near -1
            # they overflow, and both frameworks' gradients are NaN)
            shift = -1.0 if "'a_log'" in key else 0.0
            return leaf + jnp.asarray(
                shift + 0.2 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(seeded, rp)


def reference_state(arch, **changes):
    """(reference config, port config, the reference's seeded params, the
    port's tree of the same values)."""
    rcfg, cfg = configs(arch, **changes)
    rp = _reference_init(arch)
    return rcfg, cfg, rp, stacked_from_reference(flat_np(rp), cfg,
                                                 device="cpu")


def assert_grads_match(rcfg, cfg, rp, tree, batch):
    want_loss, want = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(
        build_model(rcfg))))(rp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    got, loss = torch.func.grad_and_value(steps.make_loss_fn(cfg))(
        tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    want = flat_np(want)
    got = {key: g.numpy() for key, g in leaves_with_path(got)}
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        w = want[key]
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key


# (arch, config changes, batch, seq)
GRADS = [(XLSTM, dict(), 2, 16),
         (XLSTM, dict(remat=True), 2, 16),
         (XLSTM, dict(), 1, 512),
         (XLSTM, dict(grad_accum=2), 2, 16),
         (ZAMBA2, dict(), 2, 16),
         (ZAMBA2, dict(remat=True), 2, 16),
         (ZAMBA2, dict(grad_accum=1), 2, 16),
         (ZAMBA2, dict(), 2, 256)]


@pytest.mark.parametrize("arch,changes,batch,seq", GRADS,
                         ids=[f"{a.split('-')[0]}-{b}x{s}" + "".join(
                             f"-{k}{v}" for k, v in c.items())
                             for a, c, b, s in GRADS])
def test_gradients_match_reference(arch, changes, batch, seq):
    rcfg, cfg, rp, tree = reference_state(arch, **changes)
    assert_grads_match(rcfg, cfg, rp, tree, token_batch(cfg, batch, seq))


@pytest.mark.parametrize("arch,remat", [(XLSTM, False), (ZAMBA2, True)],
                         ids=["xlstm", "zamba2-remat"])
def test_differentiated_stack_matches_autograd_of_its_forward(arch, remat):
    """The written-out VJP against autograd through the undifferentiated
    stack's own ops (``_forward_recurrent``): the same function."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    gen = torch.Generator().manual_seed(1)
    params = tree_map(lambda p: p + 0.1 * torch.randn(
        p.shape, generator=gen), transformer.DecoderLM(
            cfg, device="cpu").init(0).stacked_params())
    b, s = 2, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    w = torch.randn(b, s, cfg.d_model, generator=gen)

    def stack(p):
        return (transformer.hidden_states(cfg, p, tokens) * w).sum()

    def plain(p):
        x = layers.embed(tokens, p["embed"]["table"])
        pos = torch.arange(s)[None].expand(b, s)
        x = transformer._forward_recurrent(cfg, p, x, pos, False)
        return (layers.rms_norm(x, p["final_norm"]["scale"], cfg.norm_eps)
                * w).sum()

    got, loss = torch.func.grad_and_value(stack)(params)
    want, want_loss = torch.func.grad_and_value(plain)(params)
    torch.testing.assert_close(loss, want_loss, **TOL)
    for (key, g), (_, r) in zip(leaves_with_path(got),
                                leaves_with_path(want), strict=True):
        assert (g - r).abs().max() <= 1e-4 * r.abs().max(), key


@pytest.mark.parametrize("arch", [XLSTM, ZAMBA2])
def test_train_step_runs_for_every_block_pattern(arch):
    """``make_train_step`` of a recurrent config takes an AdamW step (it
    refused until item 5.4b)."""
    cfg = get_smoke_config(arch)
    params = transformer.DecoderLM(cfg, device="cpu").init(0).stacked_params()
    _, opt, loss = steps.make_train_step(cfg)(
        params, make_optimizer("adamw", lr=3e-4).init(params),
        {k: torch.from_numpy(v) for k, v in token_batch(cfg, 2, 8).items()})
    assert torch.isfinite(loss) and int(opt["step"]) == 1
