"""The port's ``ServeEngine`` against the reference's
``ServeEngine(paged=True, attn_kernel=True)`` (Pallas kernel in interpret
mode) on the llama3 smoke config, with the reference's parameters handed
across through the checkpoint bridge.

Generated tokens must be identical and per-tick logits, recorded through
``sample=``, within rtol = atol = 1e-4 — the reference's own cross-path
tolerance (``repro/mapper/compile.py`` ``verify``). Preemptions, resumes,
the allocator's ``stats`` and the byte counters must be equal.
"""

import jax
import numpy as np
import pytest

from repro import configs
from repro.checkpoint.ckpt import _flatten
from repro.models.transformer import build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.checkpoint import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import paged_decode_attention_grouped
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    cfg = configs.get_smoke_config("llama3-8b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("llama3-8b")
    return cfg, params, tcfg, params_from_reference(_flatten(params), tcfg,
                                                    device="cpu")


def _prompts(seed, lengths, vocab, shared_prefix=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, shared_prefix, dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, n, dtype=np.int32)])
            for n in lengths]


# name -> (engine options, prompt lengths, shared prefix, max_tokens)
SCENARIOS = {
    # 5 requests through 2 slots: recycled slots restart at position 0
    "recycled": (dict(batch=2, max_len=32, kv_block_size=4),
                 (3, 4, 5, 6, 7), 0, 4),
    # a 6-block pool for 3 requests: swap-out and token-identical resume
    "preempt": (dict(batch=2, max_len=16, kv_block_size=4, kv_blocks=6),
                (5, 6, 7), 0, 6),
    # one slot, prompts sharing 12 tokens: cached prefix blocks attached
    "prefix": (dict(batch=1, max_len=32, kv_block_size=4),
               (2, 5), 12, 3),
}


def _drive(engine_cls, request_cls, cfg, params, prompts, max_tokens,
           to_numpy, **opts):
    ticks = []

    def sample(logits):
        ticks.append(to_numpy(logits))
        return logits.argmax(-1)

    eng = engine_cls(cfg, params, paged=True, sample=sample, **opts)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_tokens=max_tokens))
    done = {r.rid: r.out for r in eng.run()}
    return eng, done, ticks


@pytest.mark.parametrize("prefill", ["replay", "batch"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_reference(models, scenario, prefill):
    cfg, params, tcfg, model = models
    opts, lengths, shared, max_tokens = SCENARIOS[scenario]
    prompts = _prompts(len(lengths) + shared, lengths, cfg.vocab_size,
                       shared)
    ref, want, ref_ticks = _drive(
        RefEngine, RefRequest, cfg, params, prompts, max_tokens, np.asarray,
        attn_kernel=True, prefill=prefill, **opts)
    eng, got, ticks = _drive(
        ServeEngine, Request, tcfg, model, prompts, max_tokens,
        lambda t: t.numpy().copy(), attn_kernel=True, prefill=prefill,
        device="cpu", **opts)
    assert got == want
    assert len(ticks) == len(ref_ticks)
    for a, b in zip(ticks, ref_ticks):
        np.testing.assert_allclose(a, b, **TOL)
    for attr in ("preemptions", "resumes", "kv_bytes_read",
                 "kv_bytes_written", "prefill_batched_tokens",
                 "prefix_skipped_tokens", "_tick"):
        assert getattr(eng, attr) == getattr(ref, attr), attr
    assert eng.kv.stats == ref.kv.stats
    assert eng.pending_work() == eng._pending_work_recompute() == 0
    if scenario == "preempt":
        assert eng.preemptions > 0 and eng.resumes > 0
    if scenario == "prefix":
        assert eng.kv.stats["shared_blocks"] > 0
    assert eng.kv.live_blocks == 0


def test_kernel_and_gather_paths_agree(models):
    """attn_kernel=True and the gather path give the same tokens; on CPU
    tensors the kernel wrapper runs its plain version and counts no
    launch."""
    _, _, tcfg, model = models
    prompts = _prompts(7, (3, 6, 9), tcfg.vocab_size)
    before = paged_decode_attention_grouped.launches
    outs = [_drive(ServeEngine, Request, tcfg, model, prompts, 4,
                   lambda t: t.numpy().copy(), attn_kernel=k, batch=2,
                   max_len=32, kv_block_size=4, prefill="batch",
                   device="cpu")[1] for k in (True, False)]
    assert outs[0] == outs[1]
    assert paged_decode_attention_grouped.launches == before


@pytest.mark.parametrize("option,value", [
    ("backend", "pim"), ("partitions", 2), ("weight_dtype", "int8"),
    ("act_dtype", "fp8_e4m3"), ("kv_dtype", "int8"), ("paged", False)])
def test_unported_options_raise_naming_the_roadmap(models, option, value):
    _, _, tcfg, model = models
    opts = dict(paged=True, device="cpu")
    opts[option] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tcfg, model, **opts)


def test_unported_methods_raise(models):
    _, _, tcfg, model = models
    eng = ServeEngine(tcfg, model, paged=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.kv_dequant_errors(eng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.drift_report()
