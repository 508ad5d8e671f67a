"""The recurrent train step (port queue item 5.4b) as a step: xlstm-350m
and zamba2-7b at their smoke configs, in float32.

* two AdamW steps of ``steps.make_train_step`` from the reference's own
  init (its constant leaves seeded, ``test_torch_recurrent_train.py``)
  and optimizer state, against its jitted ``make_train_step``: the
  losses within 1e-4, every leaf of the parameters and of the moments m
  and v within rtol = atol = 1e-4; xlstm with and without remat, zamba2
  with its published ``grad_accum=2`` (the microbatch scan);
* ``compile_arch(kind="train", device="cpu")``: the program equals the
  per-block executor bit for bit, a second run equals the first, and the
  plain step within 1e-4; K3 (its plain version here) is the only PIM
  kernel it launches, at the counts the chip script's
  ``recurrent_train`` phase holds the card to (``chip_smoke.
  REC_TRAIN_K3``: the holds' cut structure — xlstm's 4 layers, zamba2's
  13 in groups of 6 — whose width does not move them);
* ``Trainer(backend="pim")`` on xlstm's smoke config against
  ``backend="jit"`` over 3 ``TokenStream`` steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.launch import steps as ref_steps
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import mapper
from repro_torch._tree import leaves_with_path
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.optim import make_optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_recurrent_train import (TOL, XLSTM, ZAMBA2, flat_np,
                                        reference_state, token_batch)


@pytest.mark.parametrize("arch,changes", [(XLSTM, {}),
                                          (XLSTM, dict(remat=True)),
                                          (ZAMBA2, {})],
                         ids=["xlstm", "xlstm-remat", "zamba2-accum2"])
def test_two_adamw_steps_match_reference(arch, changes):
    rcfg, cfg, rp, params = reference_state(arch, **changes)
    ropt = ref_make_optimizer("adamw", lr=3e-4).init(rp)
    opt = make_optimizer("adamw", lr=3e-4).init(params)
    rstep = jax.jit(ref_steps.make_train_step(rcfg))
    step = steps.make_train_step(cfg)
    for i in range(2):
        batch = token_batch(cfg, 2, 16, seed=i)
        rp, ropt, want = rstep(rp, ropt, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        params, opt, got = step(params, opt, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        assert abs(float(got) - float(want)) <= 1e-4
    for mine, theirs in ((params, rp), (opt, ropt)):
        want_leaves = flat_np(theirs)
        got_leaves = dict(leaves_with_path(mine))
        assert sorted(got_leaves) == sorted(want_leaves)
        for key, leaf in got_leaves.items():
            np.testing.assert_allclose(leaf.numpy(), want_leaves[key],
                                       err_msg=key, **TOL)
    assert int(opt["step"]) == int(ropt["step"]) == 2


def _counting(monkeypatch, name: str) -> list:
    calls = []
    real = getattr(ref, name)
    monkeypatch.setattr(ref, name, lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    return calls


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        pytree.tree_leaves(a), pytree.tree_leaves(b), strict=True))


# (arch, config changes, K3 launches, eltwise calls) of the compiled step
# at batch 2, seq 16: AdamW's update of every leaf and the step counter,
# the final norm and its VJP, the hoisted index sums, outside the folded
# loops; zamba2 in the chip hold's structure besides its smoke one
K3 = [(XLSTM, {}, 142, 256), (ZAMBA2, {}, 194, 354),
      (ZAMBA2, dict(n_layers=13, shared_attn_every=6), 194, 354)]


@pytest.mark.parametrize("arch,changes,launches,calls", K3,
                         ids=["xlstm", "zamba2", "zamba2-13-layers"])
def test_compiled_train_step_equals_executor_and_plain_step(
        monkeypatch, arch, changes, launches, calls):
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    prog = mapper.compile_arch(arch, "train", batch=2, seq_len=16,
                               config=cfg, device="cpu")
    params = transformer.DecoderLM(cfg, device="cpu").init(0).stacked_params()
    opt = make_optimizer("adamw", lr=3e-4).init(params)
    batch = {k: torch.as_tensor(v) for k, v in TokenStream(
        cfg.vocab_size, 16, 2).batch(0).items()}
    waves = _counting(monkeypatch, "pim_mac_wave_ref")
    products = [_counting(monkeypatch, name) for name in (
        "pim_matmul_ref", "pim_matmul_grouped_ref",
        "pim_matmul_grouped_q_ref")]
    got = prog(params, opt, batch)
    assert (len(waves), prog.eltwise_launches, prog.eltwise_calls,
            prog.matmul_launches) == (launches, launches, calls, 0)
    assert _equal(got, prog(params, opt, batch))
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    assert _equal(got, ex.run(params, opt, batch))
    assert (ex.eltwise_launches, ex.matmul_launches) == (calls, 0)
    assert not any(products)
    want = steps.make_train_step(cfg)(params, opt, batch)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want),
                    strict=True):
        torch.testing.assert_close(a, b, **TOL)


def test_pim_trainer_matches_jit_trainer(tmp_path):
    cfg = get_smoke_config(XLSTM)
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
            assert tr.pim_program.eltwise_launches == 142
    np.testing.assert_allclose(losses["pim"], losses["jit"], rtol=0,
                               atol=1e-4)
    assert len(losses["pim"]) == 3
