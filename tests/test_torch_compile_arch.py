"""llama3-8b's decode step compiled through the mapper, on the CPU.

``compile_arch("llama3-8b", "serve", smoke=True)`` runs one decode step
through the placement: the nodes outside the layer stack on the PIM
kernels' plain versions (K1 on the LM head, one grouped launch; K3 on the
final norm's three MACs), the stack natively. Held, on the reference's
seeded parameters: the program against the per-block executor (K2 per
block) and against the plain ``decode_step`` at rtol = atol = 1e-4, the
logits against the reference's ``jax.jit(decode_step)``, 8 greedy steps
of tokens identical to the plain step's, and the launches against
``BENCH_fusion.json``'s ``llama3_8b_decode`` (1 grouped matmul launch,
4 in all; 8 placed blocks, 8 matmul launches and 11 in all per block).
The int8 twin runs the LM head on K5's plain version, held against the
plain step over the weights the grid stores
(``executor.run_fake_quant_plain``).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.transformer import build_model
from repro_torch import mapper
from repro_torch.checkpoint import stacked_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref
from repro_torch.mapper.executor import (max_deviation,
                                         run_fake_quant_plain)
from repro_torch.models import transformer

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, MAX_LEN, STEPS = 2, 32, 8


@pytest.fixture(scope="module")
def setup():
    model = build_model(ref_smoke_config("llama3-8b"))
    params = model.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("llama3-8b")
    tree = stacked_from_reference(_flatten(params), cfg, device="cpu")
    return model, params, cfg, tree


def _cache(cfg):
    shape = (cfg.n_layers, BATCH, MAX_LEN, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": {"block0": {"k": torch.zeros(shape),
                                  "v": torch.zeros(shape)}}}


def _first_tokens(cfg) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, BATCH, dtype=np.int32))


def _counting(monkeypatch, name: str) -> list:
    calls = []
    real = getattr(ref, name)
    monkeypatch.setattr(ref, name, lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    return calls


def test_program_equals_executor_plain_step_and_reference(setup,
                                                         monkeypatch):
    model, params, cfg, tree = setup
    prog = mapper.compile_arch("llama3-8b", "serve", smoke=True,
                               batch=BATCH, seq_len=MAX_LEN, device="cpu")
    waves = _counting(monkeypatch, "pim_mac_wave_ref")
    grouped = _counting(monkeypatch, "pim_matmul_grouped_ref")
    cache, tok = _cache(cfg), _first_tokens(cfg)
    pos = torch.tensor(3, dtype=torch.int32)
    logits, new = prog(tree, cache, tok, pos)
    bench = json.loads((ROOT / "BENCH_fusion.json").read_text())[
        "llama3_8b_decode"]
    assert (prog.matmul_launches, prog.kernel_launches, prog.placed_blocks) \
        == (bench["grouped_matmul_launches"], bench["grouped_total_launches"],
            bench["placed_blocks"]) == (1, 4, 8)
    assert (len(grouped), len(waves)) == (1, 3)
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    got_ex = ex.run(tree, cache, tok, pos)
    assert (ex.matmul_launches, ex.kernel_launches, ex.placed_blocks) == (
        bench["per_block_matmul_launches"], bench["per_block_total_launches"],
        bench["placed_blocks"]) == (8, 11, 8)
    max_deviation((logits, new), got_ex, **TOL)
    assert prog.verify(tree, cache, tok, pos, **TOL) <= 1e-4
    plain = transformer.decode_step(cfg, tree, cache, tok, pos)
    max_deviation((logits, new), plain, **TOL)
    want, _ = jax.jit(model.decode_step)(
        params, model.init_cache(BATCH, MAX_LEN), jnp.asarray(tok.numpy()),
        jnp.int32(3))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_greedy_steps_through_the_program_match_plain_step(setup):
    _, _, cfg, tree = setup
    prog = mapper.compile_arch("llama3-8b", "serve", smoke=True,
                               batch=BATCH, seq_len=MAX_LEN, device="cpu")
    cache = plain_cache = _cache(cfg)
    tok = plain_tok = _first_tokens(cfg)
    for p in range(STEPS):
        pos = torch.tensor(p, dtype=torch.int32)
        logits, cache = prog(tree, cache, tok, pos)
        want, plain_cache = transformer.decode_step(cfg, tree, plain_cache,
                                                    plain_tok, pos)
        max_deviation(logits, want, **TOL)
        tok = logits.argmax(-1).to(torch.int32)
        plain_tok = want.argmax(-1).to(torch.int32)
        assert torch.equal(tok, plain_tok)
    max_deviation(cache, plain_cache, **TOL)


def test_int8_grid_runs_the_head_on_k5(setup, monkeypatch):
    _, _, cfg, tree = setup
    prog = mapper.compile_arch("llama3-8b", "serve", smoke=True,
                               batch=BATCH, seq_len=MAX_LEN,
                               weight_dtype="int8", device="cpu")
    k5 = _counting(monkeypatch, "pim_matmul_grouped_q_ref")
    cache, tok = _cache(cfg), _first_tokens(cfg)
    pos = torch.tensor(5, dtype=torch.int32)
    logits, new = prog(tree, cache, tok, pos)
    # the head's one matmul launch is K5's: 1 x 2 blocks of 128 columns
    assert (len(k5), prog.matmul_launches, prog.kernel_launches,
            prog.placed_blocks) == (1, 1, 4, 2)
    want = run_fake_quant_plain(prog.schedule, tree, cache, tok, pos)
    max_deviation((logits, new), want, **TOL)
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    max_deviation((logits, new), ex.run(tree, cache, tok, pos), **TOL)
    assert ex.placed_blocks == 2
    # the grid is coarse enough to move the logits off the fp32 step's
    fp32 = transformer.decode_step(cfg, tree, cache, tok, pos)[0]
    assert float((logits - fp32).abs().max()) > 1e-4
