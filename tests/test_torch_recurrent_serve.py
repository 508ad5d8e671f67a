"""``ServeEngine(paged=False)``, the contiguous lanes (port queue item 5.4,
with the part of item 6 the recurrent families need), against the
reference's contiguous engine (``ServeEngine(paged=False,
backend="jit")``) on xlstm-350m, zamba2-7b and llama3-8b smoke, float32,
the reference's parameters carried across by the bridge:

* token for token with the continuous and the static scheduler, more
  requests than lanes (recycled mid-stream), each request's first and
  last tick, ``kv_bytes_read`` / ``kv_bytes_written`` (0 for the
  recurrent patterns) and the work counter;
* the lane bound: the shared tick stops at ``max_len - 1`` and the same
  requests are starved;
* ``backend="pim"`` (folded, and xlstm's stack expanded) token-identical
  to the jit engine, the head on K1 and the final norm on K3 each tick;
* the paged-only options raise the reference's ``ValueError``s.

The contiguous lanes copy the reference's contract: every lane advances
on every tick at one shared position, an empty lane is fed token 0, and
admission resets a slot's cursor but not its lane (ROADMAP.md §3).
"""

import jax
import numpy as np
import pytest

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.transformer import build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.checkpoint import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref
from repro_torch.serve import Request, ServeEngine

ARCHS = ("xlstm-350m", "zamba2-7b", "llama3-8b")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(reference config, port config, the reference's params, the port's
    model holding them)."""
    rcfg, cfg = ref_smoke_config(request.param), get_smoke_config(
        request.param)
    # jitted: the eager init of zamba2's vmapped groups takes ~10 s
    rparams = jax.jit(build_model(rcfg).init)(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(rparams).items()}
    return rcfg, cfg, rparams, params_from_reference(flat, cfg,
                                                     device="cpu")


def _prompts(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))
            .astype(np.int32) for _ in range(n)]


def _drive(engine_cls, request_cls, cfg, params, prompts, **opts):
    """Tick the engine until it stops: (tokens, first tick, last tick per
    request, kv bytes read / written, ticks, pending rids, the work
    counter left)."""
    device = {"device": "cpu"} if engine_cls is ServeEngine else {}
    eng = engine_cls(cfg, params, **opts, **device)
    reqs = [request_cls(rid=i, prompt=p, max_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    first, done, t = {}, {}, 0
    while eng.tick_once():
        t += 1
        for r in reqs:
            if r.out and r.rid not in first:
                first[r.rid] = t
            if r.done and r.rid not in done:
                done[r.rid] = t
    return dict(tokens=[[int(x) for x in r.out] for r in reqs], first=first,
                done=done, kv=(eng.kv_bytes_read, eng.kv_bytes_written),
                ticks=eng._tick, pending=eng.pending_rids(),
                work=eng.pending_work())


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_lanes_match_the_reference_engine(case, scheduler):
    rcfg, cfg, rparams, model = case
    prompts = _prompts(cfg)
    kw = dict(batch=2, max_len=48, scheduler=scheduler)
    want = _drive(RefEngine, RefRequest, rcfg, rparams, prompts, **kw)
    got = _drive(ServeEngine, Request, cfg, model, prompts, **kw)
    assert got == want
    assert not got["pending"] and len(got["done"]) == len(prompts)
    # the recycled lanes: more requests than lanes, so a late request
    # starts from the state its lane was left in
    assert max(got["first"].values()) > min(got["done"].values())
    if cfg.block_pattern != "attn":
        assert got["kv"] == (0, 0)


def test_the_lane_bound_starves_the_same_requests(case):
    rcfg, cfg, rparams, model = case
    prompts = _prompts(cfg, n=6, seed=1)
    kw = dict(batch=2, max_len=12)
    want = _drive(RefEngine, RefRequest, rcfg, rparams, prompts, **kw)
    got = _drive(ServeEngine, Request, cfg, model, prompts, **kw)
    assert got == want
    assert got["ticks"] == 11 and got["pending"]
    eng = ServeEngine(cfg, model, batch=2, max_len=12, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=4))
    eng.run(on_starvation="return")
    assert eng.starved == got["pending"]
    with pytest.raises(RuntimeError, match="still pending"):
        eng.run()


def test_pim_engine_matches_the_jit_engine(case, monkeypatch):
    _, cfg, _, model = case
    prompts = _prompts(cfg, seed=2)
    kw = dict(batch=2, max_len=32)
    want = _drive(ServeEngine, Request, cfg, model, prompts, **kw)
    heads, waves = [], []
    real_mm, real_mac = ref.pim_matmul_grouped_ref, ref.pim_mac_wave_ref
    monkeypatch.setattr(ref, "pim_matmul_grouped_ref",
                        lambda *a, **k: heads.append(1) or real_mm(*a, **k))
    monkeypatch.setattr(ref, "pim_mac_wave_ref",
                        lambda *a, **k: waves.append(1) or real_mac(*a, **k))
    got = _drive(ServeEngine, Request, cfg, model, prompts, backend="pim",
                 **kw)
    assert got == want
    # the head on K1, the final norm's three waves on K3, each tick; the
    # folded stack native
    assert (len(heads), len(waves)) == (got["ticks"], 3 * got["ticks"])
    if cfg.block_pattern == "xlstm":
        # the stack expanded: the units' products and waves on the kernels
        assert _drive(ServeEngine, Request, cfg, model, prompts,
                      backend="pim", expand_scans=True, **kw) == want


@pytest.mark.parametrize("option,value,match", [
    ("prefill", "batch", "prefill='batch' requires paged=True"),
    ("attn_kernel", True, "attn_kernel=True requires paged=True"),
    ("kv_dtype", "int8", "kv_dtype only applies to paged=True"),
    ("admission", "kv", "admission='kv' requires paged=True")])
def test_paged_only_options_raise_the_reference_errors(case, option, value,
                                                       match):
    rcfg, cfg, rparams, model = case
    with pytest.raises(ValueError, match=match):
        RefEngine(rcfg, rparams, paged=False, **{option: value})
    with pytest.raises(ValueError, match=match):
        ServeEngine(cfg, model, paged=False, device="cpu", **{option: value})


def test_contiguous_defaults(case):
    _, cfg, _, model = case
    eng = ServeEngine(cfg, model, device="cpu")
    assert (eng.paged, eng.admission, eng.preempt, eng.kv) == (
        False, "slot", False, None)
    assert eng.kv_blocks_needed(Request(rid=0, prompt=np.zeros(3, np.int32))
                                ) == 0
    assert eng.params is model.shared_stacked_params()
