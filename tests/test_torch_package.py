"""The port as a package: it imports neither JAX nor the reference, its
entry points default to CUDA with no silent CPU fallback, and the full
llama3-8b model has the published parameter count (built on the meta
device, so nothing is allocated)."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs
from repro.models.transformer import build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import DecoderLM
from repro_torch.serve import PagedKVCache, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                       r"import repro\s*$|from repro\.|from repro import)",
                       re.MULTILINE)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.models,"
            " repro_torch.kernels, repro_torch.checkpoint, repro_torch.obs,"
            " repro_torch.configs, repro_torch.kernels.build\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[p.name for p in PORT_FILES])
def test_no_source_imports_jax_or_reference(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(4, 4, 1, 16)
    model = DecoderLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, model, paged=True)
    with pytest.raises(ValueError, match="model is on"):
        ServeEngine(cfg, DecoderLM(cfg, device="meta"), paged=True,
                    device="cpu")


def test_full_llama3_8b_parameter_count_on_meta():
    cfg = get_config("llama3-8b")
    model = DecoderLM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    # param_count() leaves out the final norm
    assert n == cfg.param_count() + cfg.d_model == 8_030_261_248
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert cfg.param_count() == configs.get_config("llama3-8b").param_count()


def test_smoke_parameter_count_equals_reference_leaves():
    cfg = configs.get_smoke_config("llama3-8b")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    model = DecoderLM(get_smoke_config("llama3-8b"), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want == 106_816


def test_seeded_init_is_reproducible_and_seed_dependent():
    cfg = get_smoke_config("llama3-8b")
    a = DecoderLM(cfg, device="cpu").init(3)
    b = DecoderLM(cfg, device="cpu").init(3)
    c = DecoderLM(cfg, device="cpu").init(4)
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb)
        assert pa.numel() == pa.shape[-1] or not torch.equal(pa, pc)


def test_bridge_rejects_mismatched_leaves():
    from repro.checkpoint.ckpt import _flatten
    from repro_torch.checkpoint import params_from_reference
    cfg = configs.get_smoke_config("llama3-8b")
    flat = _flatten(build_model(cfg).init(jax.random.PRNGKey(0)))
    tcfg = get_smoke_config("llama3-8b")
    bad = dict(flat, **{"lm_head/w": flat["lm_head/w"][:, :8]})
    with pytest.raises(ValueError, match="lm_head"):
        params_from_reference(bad, tcfg, device="cpu")
    extra = dict(flat, **{"layers/block0/moe/w": flat["lm_head/w"]})
    with pytest.raises(ValueError, match="not ported"):
        params_from_reference(extra, tcfg, device="cpu")


def test_bridge_carries_bfloat16_leaves_bit_exactly():
    from repro.checkpoint.ckpt import _flatten
    from repro_torch.checkpoint import params_from_reference
    cfg = configs.get_smoke_config("llama3-8b")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    flat = _flatten(build_model(cfg16).init(jax.random.PRNGKey(1)))
    assert flat["embed/table"].dtype.name == "bfloat16"
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="bfloat16")
    model = params_from_reference(flat, tcfg, device="cpu")
    got = model.layers[1].attn.wq.view(torch.int16).numpy()
    want = flat["layers/block0/attn/wq"][1].view(np.int16)
    assert np.array_equal(got, want)


def test_quantized_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(4, 4, 1, 16, kv_dtype="int8")
    model = DecoderLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, model, kv_dtype="int8", paged=True)
    # kv_dtype raises as the reference does, before any device is chosen
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, model, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        ServeEngine(cfg, model, kv_dtype="int7", paged=True, device="cpu")


def _k6_bad_inputs():
    """(case, kv_dtype, arguments) the K6 wrapper must refuse."""
    q = torch.zeros(2, 4, 16)
    codes = torch.zeros(5, 4, 2, 16, dtype=torch.uint8)
    scale = torch.ones(5, 4, 2, 1)
    table = torch.zeros(2, 3, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    ok = (q, codes, scale, codes, scale, table, pos)
    yield "meta device", "fp8_e4m3", tuple(
        a.to("meta") for a in ok)
    yield "int8 codes for fp8", "fp8_e4m3", (
        q, codes.to(torch.int8), scale, codes.to(torch.int8), scale, table,
        pos)
    yield "uint8 codes for fp16", "fp16", ok        # int16 holds them
    yield "float64 scales", "fp8_e4m3", (
        q, codes, scale.double(), codes, scale.double(), table, pos)
    yield "scale shape", "fp8_e4m3", (
        q, codes, scale[..., 0], codes, scale[..., 0], table, pos)
    yield "fp32 pool", "fp32", ok
    yield "head dim", "fp8_e4m3", (
        q[..., :8].contiguous(), codes, scale, codes, scale, table, pos)


@pytest.mark.parametrize("case", [c for c, _, _ in _k6_bad_inputs()])
def test_k6_wrapper_rejects_what_the_kernel_does_not_take(case):
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped_q)
    _, kv_dtype, args = next(c for c in _k6_bad_inputs() if c[0] == case)
    before = paged_decode_attention_grouped_q.launches
    with pytest.raises((TypeError, ValueError)):
        paged_decode_attention_grouped_q(*args, kv_dtype=kv_dtype)
    assert paged_decode_attention_grouped_q.launches == before
