"""The mixture-of-experts train step's gradients (port queue item 5.3b)
against the reference, at the smoke configs of granite-moe-1b-a400m (an
MoE block every layer, top-2 of 4, tied head) and
llama4-maverick-400b-a17b (units of a dense block then an MoE block with
the shared expert, top-1 of 4), in float32:

* each leaf's gradient of the loss (``steps.make_loss_fn`` under
  ``torch.func.grad``: the written-out stack VJP ``_LayerStack`` with
  ``moe.moe_block_bwd``) within 1e-4 of the leaf's largest against
  ``jax.grad`` of the reference's loss, from the reference's own init
  through the bridge: full attention at seq 16, maverick at 4 layers
  (two units of two blocks; at top-2, and under remat) and granite at
  seq 2560 (the chunked attention) under remat.
  Under top-1 the renormalized gate weight is 1 whatever the router
  gives, so maverick's router gradient is zero in exact arithmetic and
  holds only rounding noise on both sides (~1e-10): that leaf is held to
  1e-6 of the largest gradient of the tree instead;
* a capacity that drops assignments (``capacity_factor=0.1``, one
  group): the gradients as above, and at one block the combine's
  transpose against the reference's own (read from its VJP's jaxpr):
  the slots no kept assignment holds, a dropped assignment's
  included, exactly zero on both sides;
* the two gathers' transposes (``estimator.scatter_add``): the same bits
  on two runs with many duplicate indices, without
  ``torch.use_deterministic_algorithms``;
* the recurrent block patterns, refused here until item 5.4b, take an
  AdamW step through ``make_train_step``.

The train step itself and its compiled program are held in
``tests/test_torch_moe_train_step.py``, the schedules in
``tests/test_torch_moe_train_schedules.py``.
"""

import dataclasses
import functools

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.models import moe as ref_moe
from repro.models.transformer import build_model
from repro_torch._tree import leaves_with_path
from repro_torch.checkpoint import stacked_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.core import estimator
from repro_torch.launch import steps
from repro_torch.models import moe, transformer
from repro_torch.optim import make_optimizer

GRANITE, MAVERICK = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(arch, **changes):
    return (dataclasses.replace(ref_smoke_config(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def _flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def _batch(cfg, batch: int, seq: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32) for name in ("tokens", "labels")}


@functools.cache
def _reference_init(arch: str, n_layers: int):
    rcfg = dataclasses.replace(ref_smoke_config(arch), n_layers=n_layers)
    return jax.jit(build_model(rcfg).init)(jax.random.PRNGKey(0))


def reference_state(arch, **changes):
    """(reference config, port config, the reference's params from its own
    init, the port's tree of the same values). The changes other than
    ``n_layers`` leave the tree's shapes as they are."""
    rcfg, cfg = _configs(arch, **changes)
    rp = _reference_init(arch, rcfg.n_layers)
    return rcfg, cfg, rp, stacked_from_reference(_flat_np(rp), cfg,
                                                 device="cpu")


def _assert_grads_match(rcfg, cfg, rp, tree, batch):
    want_loss, want = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(
        build_model(rcfg))))(rp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    got, loss = torch.func.grad_and_value(steps.make_loss_fn(cfg))(
        tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    want = _flat_np(want)
    got = {key: g.numpy() for key, g in leaves_with_path(got)}
    assert sorted(got) == sorted(want)
    largest = max(np.abs(w).max() for w in want.values())
    for key, g in got.items():
        w = want[key]
        if key.endswith("moe/router") and cfg.top_k == 1:
            # zero in exact arithmetic (module docstring)
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * largest
            continue
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key


# (arch, config changes, batch, seq)
GRADS = [(GRANITE, dict(), 2, 16),
         (MAVERICK, dict(), 2, 16),
         (MAVERICK, dict(n_layers=4, top_k=2), 2, 16),
         (MAVERICK, dict(n_layers=4, remat=True), 2, 16),
         (GRANITE, dict(remat=True), 1, 2560)]


@pytest.mark.parametrize("arch,changes,batch,seq", GRADS,
                         ids=[f"{a.split('-')[0]}-{s}-" + "-".join(
                             f"{k}{v}" for k, v in c.items())
                             for a, c, _, s in GRADS])
def test_gradients_match_reference(arch, changes, batch, seq):
    rcfg, cfg, rp, tree = reference_state(arch, **changes)
    _assert_grads_match(rcfg, cfg, rp, tree, _batch(cfg, batch, seq))


DROPS = dict(capacity_factor=0.1, moe_groups=1)


def test_gradients_with_dropped_assignments_match_reference():
    rcfg, cfg, rp, tree = reference_state(GRANITE, **DROPS)
    # one group of 64 tokens, 128 assignments over 4 experts of C slots
    c = moe.capacity(64, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    assert 64 * cfg.top_k > cfg.n_experts * c
    _assert_grads_match(rcfg, cfg, rp, tree, _batch(cfg, 2, 32, 1))


def _ref_vjp_values(x, p, ct, cfg) -> dict:
    """The reference's VJP of ``moe_block`` at ``x`` for ``ct``, its jaxpr
    evaluated with one more output: the cotangent of ``x`` and of the
    parameters, and the combine gather's transpose (the output of its
    third ``take_along_axis`` call: the cotangent of ``out_buf``)."""
    def vjp(x, p):
        return jax.vjp(lambda a, b: ref_moe.moe_block(a, b, cfg), x, p)[1](
            ct)

    closed = jax.make_jaxpr(vjp)(x, p)
    takes = [e for e in closed.jaxpr.eqns
             if e.params.get("name") == "take_along_axis"]
    jaxpr = closed.jaxpr.replace(
        outvars=[*closed.jaxpr.outvars, takes[2].outvars[0]])
    *outs, ct_out_buf = jax.jit(jax.extend.core.jaxpr_as_fun(
        closed.replace(jaxpr=jaxpr)))(*jax.tree.leaves((x, p)))
    dx, dp = jax.tree.unflatten(jax.tree.structure((x, p)), outs)
    return dict(dx=np.asarray(dx), dp=_flat_np(dp),
                ct_out_buf=np.asarray(ct_out_buf))


def test_dropped_assignments_transpose_as_the_reference():
    rcfg, cfg = _configs(GRANITE, **DROPS)
    rp = ref_moe.init_moe(jax.random.PRNGKey(3), cfg.d_model, cfg.n_experts,
                          cfg.moe_d_ff, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    want = _ref_vjp_values(jnp.asarray(x), rp, jnp.asarray(ct), rcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    r = moe.moe_forward(torch.from_numpy(x), tp, cfg, lin=True)
    keep = r["keep"][..., 0].numpy()
    assert 0 < (~keep).sum() < keep.size
    grp, tl, k, d = r["gathered"].shape
    e, c = cfg.n_experts, r["buf"].shape[2]
    _, ct_out = moe.combine_bwd(torch.from_numpy(ct).reshape(grp, tl, d), r,
                                e * c)
    ct_out = ct_out.numpy()
    comb = r["comb"].numpy()
    held = np.zeros((grp, e * c), bool)
    g_at, a_at = np.nonzero(keep)
    held[g_at, comb[g_at, a_at]] = True
    want_out = want["ct_out_buf"].reshape(ct_out.shape)
    assert (ct_out[~held] == 0).all() and (want_out[~held] == 0).all()
    # a slot 0 of an expert that a dropped assignment points at as well
    assert held[0][comb[~keep]].all()
    np.testing.assert_allclose(ct_out, want_out, **TOL)
    # the block's whole VJP
    dx, grads = moe.moe_block_bwd(torch.from_numpy(ct),
                                  {**r, "x": torch.from_numpy(x)}, tp, cfg)
    np.testing.assert_allclose(dx.numpy(), want["dx"], **TOL)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want["dp"][key], err_msg=key,
                                   **TOL)


@pytest.mark.parametrize("trailing", [(), (64,)])
def test_gather_transposes_are_deterministic(trailing):
    """``scatter_add`` with many duplicates (a dropped assignment's slot,
    a token's k slots): two runs give the same bits, and the sums are
    the float64 ones within float32 rounding."""
    assert not torch.are_deterministic_algorithms_enabled()
    gen = torch.Generator().manual_seed(0)
    src = torch.randn((4, 20_000, *trailing), generator=gen)
    index = torch.randint(0, 7, (4, 20_000), generator=gen,
                          dtype=torch.int32)
    a = estimator.scatter_add(src, index, 7)
    b = estimator.scatter_add(src, index, 7)
    assert a.shape == (4, 7, *trailing) and torch.equal(a, b)
    want = torch.zeros((4, 7, *trailing), dtype=torch.float64)
    for g in range(4):
        want[g].index_add_(0, index[g].long(), src[g].double())
    torch.testing.assert_close(a.double(), want, rtol=1e-5, atol=1e-3)
    # the whole block's VJP, twice
    cfg = get_smoke_config(GRANITE)
    rp = ref_moe.init_moe(jax.random.PRNGKey(0), cfg.d_model, cfg.n_experts,
                          cfg.moe_d_ff, jnp.float32)
    tp = jax.tree.map(lambda t: torch.from_numpy(np.array(t)), rp)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    ct = torch.randn(x.shape, generator=gen)
    r = {**moe.moe_forward(x, tp, cfg, lin=True), "x": x}
    one, two = (moe.moe_block_bwd(ct, r, tp, cfg) for _ in range(2))
    assert torch.equal(one[0], two[0])
    assert all(torch.equal(one[1][k], two[1][k]) for k in one[1])


def test_recurrent_block_patterns_still_refused():
    """The recurrent block patterns refused here until item 5.4b; now
    they train as the MoE configs do: one AdamW step of each, a finite
    loss."""
    cfg = dataclasses.replace(get_smoke_config(GRANITE), n_experts=0,
                              block_pattern="xlstm")
    params = transformer.DecoderLM(cfg, device="cpu").init(0).stacked_params()
    _, opt, loss = steps.make_train_step(cfg)(
        params, make_optimizer("adamw", lr=3e-4).init(params),
        {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 8).items()})
    assert torch.isfinite(loss) and int(opt["step"]) == 1
    rcfg, cfg, rp, tree = reference_state(GRANITE)
    step = steps.make_train_step(cfg)
    _, opt, loss = step(tree, make_optimizer("adamw", lr=3e-4).init(tree),
                        {k: torch.from_numpy(v) for k, v in
                         _batch(cfg, 2, 8).items()})
    assert torch.isfinite(loss) and int(opt["step"]) == 1
