"""The port's paged decode attention against the reference.

* The plain K4 (``repro_torch.kernels.ref``, which the wrapper runs for CPU
  tensors) against the reference's Pallas kernel
  ``paged_decode_attention_grouped`` in interpret mode.
* The port's ``paged_decode_attention`` / ``paged_prefill_attention``
  against ``repro.models.attention``: outputs, and the pool entries they
  write, for every block that is not the scratch block.

Same numpy-seeded inputs on both sides; rtol = atol = 1e-5 in float32.
"""


import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.kernels.flash_attention import (
    paged_decode_attention_grouped as pallas_k4)
from repro.models import attention as ref_attn
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ref import paged_decode_attention_ref
from repro_torch.models import attention

# the module (``repro_torch.kernels.flash_attention`` the package attribute
# is K7's wrapper, as in the reference)
port_k4 = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = dict(rtol=1e-5, atol=1e-5)
BS, W = 4, 5
# per-slot positions: 0; a partly filled last block; a full last block
# (last position of block 1); a later, partly filled block. Every table
# tail past a slot's position is the scratch block.
POSITIONS = (0, 5, 7, 13)


def _k4_inputs(rep: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    g, d = 2, 16
    b, h = len(POSITIONS), g * rep
    n = 1 + b * W
    pos = np.asarray(POSITIONS, np.int32)
    table = np.zeros((b, W), np.int32)
    for i, p in enumerate(pos):
        nv = p // BS + 1
        table[i, :nv] = rng.choice(n - 1, nv, replace=False) + 1
    k = rng.standard_normal((n, BS, g, d)).astype(np.float32)
    v = rng.standard_normal((n, BS, g, d)).astype(np.float32)
    k[0] = 1e4                           # scratch: garbage, never read
    v[0] = -1e4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, k, v, table, pos


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_k4_matches_pallas_kernel(rep):
    q, k, v, table, pos = _k4_inputs(rep)
    want = pallas_k4(*(jnp.asarray(a) for a in (q, k, v, table, pos)),
                     interpret=True)
    got = paged_decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v, table, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = port_k4.paged_decode_attention_grouped.launches
    via = port_k4.paged_decode_attention_grouped(
        *(torch.from_numpy(a) for a in (q, k, v, table, pos)))
    assert torch.equal(via, got)
    assert port_k4.paged_decode_attention_grouped.launches == before


def test_plain_k4_bfloat16_matches_float32_within_rounding():
    """bf16 inputs: scores and softmax stay float32, p is rounded to
    bf16 before PV — the result tracks the float32 one to bf16 rounding."""
    q, k, v, table, pos = _k4_inputs(4, seed=1)
    k[0], v[0] = 0.0, 0.0
    args32 = [torch.from_numpy(a) for a in (q, k, v, table, pos)]
    args16 = [a.to(torch.bfloat16) if a.is_floating_point() else a
              for a in args32]
    out32 = paged_decode_attention_ref(*args32)
    out16 = paged_decode_attention_ref(*args16)
    assert out16.dtype == torch.bfloat16
    err = float((out16.float() - out32).abs().max())
    assert err <= 2e-2 * float(out32.abs().max())


def _bad_inputs():
    q, k, v, table, pos = (torch.from_numpy(a)
                           for a in _k4_inputs(2, seed=2))
    yield "dtype", (q.double(), k.double(), v.double(), table, pos)
    yield "int32", (q, k, v, table.long(), pos)
    yield "contiguous", (q.transpose(0, 1), k, v, table, pos)
    yield "rows", (q, k, v, table[:2], pos)
    yield "head dim", (q, k[..., :8].contiguous(), v[..., :8].contiguous(),
                       table, pos)
    yield "G | H", (q[:, :3].contiguous(), k, v, table, pos)
    # the split kernel's 16-byte copies: D % 8 == 0, pools on 16 bytes
    yield "head dim % 8", (q[..., :12].contiguous(),
                           k[..., :12].contiguous(),
                           v[..., :12].contiguous(), table, pos)
    k_off = torch.empty(k.numel() + 1)[1:].view(k.shape).copy_(k)
    yield "16-byte aligned", (q, k_off, v, table, pos)


@pytest.mark.parametrize("case", [c for c, _ in _bad_inputs()])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    args = dict(_bad_inputs())[case]
    with pytest.raises((TypeError, ValueError)):
        port_k4._check_split(*args)


# ---------------------------------------------------------------------------
# model-level paged attention against repro.models.attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def site():
    cfg = configs.get_smoke_config("llama3-8b")
    tcfg = get_smoke_config("llama3-8b")
    params = ref_attn.init_attention(
        jax.random.PRNGKey(0), cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim, jnp.float32)
    attn = attention.init_attention(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(attn, name).copy_(torch.from_numpy(
                np.array(params[name])))
    return cfg, tcfg, params, attn


def _pool(cfg, seed):
    rng = np.random.default_rng(seed)
    n = 1 + 4 * W
    shape = (n, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_decode_attention_matches_reference(site, use_kernel):
    cfg, tcfg, params, attn = site
    q, _, _, table, pos = _k4_inputs(2, seed=3)
    k, v = _pool(cfg, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((len(pos), 1, cfg.d_model)).astype(np.float32)
    want, new = ref_attn.paged_decode_attention(
        jnp.asarray(x), params, cfg,
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(table),
        jnp.asarray(pos), use_kernel=use_kernel)
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = attention.paged_decode_attention(
        torch.from_numpy(x), attn, tcfg, kt, vt, torch.from_numpy(table),
        torch.from_numpy(pos), use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    live = slice(1, None)                  # every block but the scratch
    np.testing.assert_allclose(kt[live].numpy(), np.asarray(new["k"])[live],
                               **TOL)
    np.testing.assert_allclose(vt[live].numpy(), np.asarray(new["v"])[live],
                               **TOL)
    # the new token landed at each slot's tail position
    for b, p in enumerate(pos):
        blk = table[b, p // BS]
        assert not np.array_equal(kt[blk, p % BS].numpy(), k[blk, p % BS])


@pytest.mark.parametrize("p0,n_new", [(0, 7), (4, 9), (8, 1)])
def test_paged_prefill_attention_matches_reference(site, p0, n_new):
    cfg, tcfg, params, attn = site
    k, v = _pool(cfg, 6)
    rng = np.random.default_rng(7)
    t = -(-n_new // BS) * BS                 # padded to whole blocks
    x = rng.standard_normal((1, t, cfg.d_model)).astype(np.float32)
    table_row = rng.choice(k.shape[0] - 1, W, replace=False).astype(
        np.int32) + 1
    table_row[(p0 + n_new - 1) // BS + 1:] = 0        # scratch tail
    want, new = ref_attn.paged_prefill_attention(
        jnp.asarray(x), params, cfg,
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(table_row),
        jnp.int32(p0), jnp.int32(n_new))
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = attention.paged_prefill_attention(
        torch.from_numpy(x), attn, tcfg, kt, vt, torch.from_numpy(table_row),
        p0, n_new)
    # rows past n_new are padding: don't-cares on both sides
    np.testing.assert_allclose(got[:, :n_new].numpy(),
                               np.asarray(want)[:, :n_new], **TOL)
    live = slice(1, None)
    np.testing.assert_allclose(kt[live].numpy(), np.asarray(new["k"])[live],
                               **TOL)
    np.testing.assert_allclose(vt[live].numpy(), np.asarray(new["v"])[live],
                               **TOL)
