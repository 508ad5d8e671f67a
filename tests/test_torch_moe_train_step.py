"""The mixture-of-experts train step (port queue item 5.3b) against the
reference, at the smoke configs of granite-moe-1b-a400m and
llama4-maverick-400b-a17b, in float32:

* two AdamW steps of ``steps.make_train_step`` from the reference's own
  init and optimizer state, against its jitted ``make_train_step``: the
  losses within 1e-4, every leaf of the parameters and of the moments m
  and v within rtol = atol = 1e-4; for granite, maverick, and maverick
  with ``grad_accum=2`` (the microbatch scan);
* ``compile_arch(kind="train", device="cpu")``: the program equals the
  per-block executor bit for bit, a second run equals the first (the
  gathers' transposes sum in a fixed order) and the plain step within
  1e-4; K3 (its plain version here) is the only PIM kernel it launches,
  at the counts the chip script's ``moe_train`` phase holds the card to
  (``chip_smoke.MOE_TRAIN_K3``: granite's, and maverick's with the
  hold's float32 AdamW state).
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
from test_torch_moe_train import (GRANITE, MAVERICK, TOL, _batch, _flat_np,
                                  reference_state)

# (arch, config changes, K3 launches, eltwise calls) of the compiled
# smoke step at batch 2, seq 16: AdamW's update of every leaf and the
# step counter, outside the folded loops; maverick's published bfloat16
# AdamW state, and the float32 state of the chip script's hold
K3 = [(GRANITE, {}, 84, 148), (MAVERICK, {}, 239, 293),
      (MAVERICK, dict(opt_state_dtype="float32"), 164, 293)]


@pytest.mark.parametrize("arch,changes", [(GRANITE, {}), (MAVERICK, {}),
                                          (MAVERICK, dict(grad_accum=2))],
                         ids=["granite", "maverick", "maverick-accum2"])
def test_two_adamw_steps_match_reference(arch, changes):
    rcfg, cfg, rp, params = reference_state(arch, **changes)
    ropt = ref_make_optimizer("adamw", lr=3e-4,
                              state_dtype=rcfg.opt_state_dtype).init(rp)
    opt = make_optimizer("adamw", lr=3e-4,
                         state_dtype=cfg.opt_state_dtype).init(params)
    rstep = jax.jit(ref_steps.make_train_step(rcfg))
    step = steps.make_train_step(cfg)
    for i in range(2):
        batch = _batch(cfg, 2, 16, seed=i)
        rp, ropt, want = rstep(rp, ropt, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        params, opt, got = step(params, opt, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        assert abs(float(got) - float(want)) <= 1e-4
    for mine, theirs in ((params, rp), (opt, ropt)):
        want_leaves = _flat_np(theirs)
        got_leaves = dict(leaves_with_path(mine))
        assert sorted(got_leaves) == sorted(want_leaves)
        for key, leaf in got_leaves.items():
            np.testing.assert_allclose(leaf.float().numpy(),
                                       want_leaves[key].astype(np.float32),
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


@pytest.mark.parametrize("arch,changes,launches,calls", K3,
                         ids=["granite", "maverick", "maverick-f32-state"])
def test_compiled_train_step_equals_executor_and_plain_step(
        monkeypatch, arch, changes, launches, calls):
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    prog = mapper.compile_arch(arch, "train", batch=2, seq_len=16,
                               config=cfg, device="cpu")
    params = transformer.DecoderLM(cfg, device="cpu").init(0).stacked_params()
    opt = make_optimizer("adamw", lr=3e-4,
                         state_dtype=cfg.opt_state_dtype).init(params)
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
