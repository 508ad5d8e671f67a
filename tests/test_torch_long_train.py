"""llama3-8b's train step above seq 2048 and with ``grad_accum > 1`` in
the port against the reference's.

* the plain train step at the smoke config, seq 2560 (the chunked
  attention: five chunks, fifteen causal pairs), remat off and on,
  tracking the reference's jitted step over two ``TokenStream`` steps in
  ``test_plain_train_step_tracks_reference``'s form: the first step's
  gradients within 1e-5 of each leaf's largest, losses within 1e-4, the
  parameters within rtol = atol = 1e-4;
* the ``grad_accum=2`` step against the reference's ``grad_accum=2``
  step (seq 16, and seq 2560 where both apply), and within 1e-4 of the
  port's own ``grad_accum=1`` step on the same batch: the two
  microbatches are of equal size, so the mean of their means is the
  batch mean;
* ``compile_arch(kind="train")`` on the CPU for those steps: the program
  equals the per-block executor bit for bit and the plain step within
  1e-4; K3 (its plain version here) is the only PIM kernel it launches;
* ``Trainer(backend="pim")`` against ``backend="jit"`` with
  ``grad_accum=2``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import TokenStream as RefTokenStream
from repro.launch import steps as ref_steps
from repro.models.transformer import build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import mapper
from repro_torch._tree import leaves_with_path
from repro_torch.checkpoint import stacked_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.optim import make_optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_arch_train import _counting, _flat_np, _tensors

SEQ = 2560
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**changes):
    return (dataclasses.replace(ref_smoke_config("llama3-8b"), **changes),
            dataclasses.replace(get_smoke_config("llama3-8b"), **changes))


@pytest.fixture(scope="module")
def ref_params():
    return build_model(ref_smoke_config("llama3-8b")).init(
        jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# the plain steps against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_plain_train_step_tracks_reference_above_2048(ref_params, remat):
    rcfg, cfg = _cfgs(remat=remat)
    stream = RefTokenStream(rcfg.vocab_size, SEQ, 1, seed=0)
    _, want_g = jax.value_and_grad(ref_steps.make_loss_fn(build_model(
        rcfg)))(ref_params, stream.batch(0))
    params = stacked_from_reference(_flat_np(ref_params), cfg,
                                    device="cpu")
    got_g, _ = torch.func.grad_and_value(steps.make_loss_fn(cfg))(
        params, _tensors(stream.batch(0)))
    want_g = _flat_np(want_g)
    for key, g in leaves_with_path(got_g):
        w = want_g[key]
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), key
    rstep = jax.jit(ref_steps.make_train_step(rcfg))
    rp, ropt = ref_params, ref_make_optimizer("adamw", lr=3e-4).init(
        ref_params)
    opt = make_optimizer("adamw", lr=3e-4).init(params)
    step = steps.make_train_step(cfg)
    for i in range(2):
        rp, ropt, want = rstep(rp, ropt, stream.batch(i))
        params, opt, got = step(params, opt, _tensors(stream.batch(i)))
        assert abs(float(got) - float(want)) <= 1e-4
    want_p = _flat_np(rp)
    for key, p in leaves_with_path(params):
        np.testing.assert_allclose(p.numpy(), want_p[key], err_msg=key,
                                   **TOL)


@pytest.mark.parametrize("seq", [16, SEQ])
def test_grad_accum_step_matches_reference(ref_params, seq):
    rcfg, cfg = _cfgs(grad_accum=2)
    batch = RefTokenStream(rcfg.vocab_size, seq, 2, seed=3).batch(0)
    ropt = ref_make_optimizer("adamw", lr=3e-4).init(ref_params)
    rp, _, want = jax.jit(ref_steps.make_train_step(rcfg))(
        ref_params, ropt, batch)
    params = stacked_from_reference(_flat_np(ref_params), cfg,
                                    device="cpu")
    opt = make_optimizer("adamw", lr=3e-4).init(params)
    got_p, got_opt, got = steps.make_train_step(cfg)(params, opt,
                                                     _tensors(batch))
    assert abs(float(got) - float(want)) <= 1e-4
    want_p = _flat_np(rp)
    for key, p in leaves_with_path(got_p):
        np.testing.assert_allclose(p.numpy(), want_p[key], err_msg=key,
                                   **TOL)
    # one step on the whole batch: the same mean
    one = steps.make_train_step(dataclasses.replace(cfg, grad_accum=1))(
        params, opt, _tensors(batch))
    for a, b in zip(pytree.tree_leaves((got_p, got_opt, got)),
                    pytree.tree_leaves(one), strict=True):
        torch.testing.assert_close(a, b, **TOL)
    # a batch the microbatches do not divide: the reference's assertion
    with pytest.raises(AssertionError, match="grad_accum=2"):
        steps.make_train_step(cfg)(params, opt, _tensors(RefTokenStream(
            rcfg.vocab_size, seq, 3).batch(0)))


# ---------------------------------------------------------------------------
# the compiled step and the trainer
# ---------------------------------------------------------------------------

# (name, config changes, batch, seq, K3 waves, eltwise calls)
COMPILED = [("chunked", dict(), 1, SEQ, 84, 148),
            ("chunked_remat", dict(remat=True), 1, SEQ, 84, 148),
            ("accum", dict(grad_accum=2), 2, 16, 74, 134)]


@pytest.fixture
def deterministic():
    """Deterministic algorithms for the bit-for-bit holds: on the CPU the
    embedding's backward accumulates 2560 rows on several threads, in an
    order that varies from run to run (at seq 16 it runs on one)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("name,changes,batch,seq,waves,calls", COMPILED,
                         ids=[c[0] for c in COMPILED])
def test_compiled_long_step_equals_executor_and_plain_step(
        ref_params, monkeypatch, deterministic, name, changes, batch, seq,
        waves, calls):
    _, cfg = _cfgs(**changes)
    prog = mapper.compile_arch("llama3-8b", "train", batch=batch,
                               seq_len=seq, config=cfg, device="cpu")
    params = stacked_from_reference(_flat_np(ref_params), cfg,
                                    device="cpu")
    opt = make_optimizer("adamw", lr=3e-4).init(params)
    batch_t = _tensors(TokenStream(cfg.vocab_size, seq, batch).batch(0))
    k3 = _counting(monkeypatch, "pim_mac_wave_ref")
    products = [_counting(monkeypatch, fn) for fn in (
        "pim_matmul_ref", "pim_matmul_grouped_ref",
        "pim_matmul_grouped_q_ref")]
    got = prog(params, opt, batch_t)
    assert (len(k3), prog.eltwise_launches, prog.eltwise_calls,
            prog.matmul_launches) == (waves, waves, calls, 0)
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    interp = ex.run(params, opt, batch_t)
    assert (ex.eltwise_launches, ex.matmul_launches) == (calls, 0)
    assert not any(products)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(interp),
                    strict=True):
        assert torch.equal(a, b)
    want = steps.make_train_step(cfg)(params, opt, batch_t)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want),
                    strict=True):
        torch.testing.assert_close(a, b, **TOL)


def test_pim_trainer_matches_jit_trainer_with_grad_accum(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), grad_accum=2)
    stream = TokenStream(cfg.vocab_size, 16, 2, seed=0)

    def init_state():
        p = transformer.DecoderLM(cfg, device="cpu").init(0).stacked_params()
        return p, make_optimizer("adamw", lr=3e-4).init(p)

    losses = {}
    for backend in ("pim", "jit"):
        tr = Trainer(TrainerConfig(total_steps=3,
                                   ckpt_dir=str(tmp_path / backend)),
                     train_step=steps.make_train_step(cfg),
                     init_state=init_state, batch_fn=stream.batch,
                     backend=backend, device="cpu")
        losses[backend] = tr.run()["losses"]
        if backend == "pim":
            assert tr.pim_program.eltwise_launches == 74
    np.testing.assert_allclose(losses["pim"], losses["jit"], rtol=0,
                               atol=1e-4)
    assert len(losses["pim"]) == 3
