"""K4's and K6's split-KV schedule ("flash-decoding"), emulated in torch on
the CPU.

The CUDA kernel cuts each slot's block table into splits of
``split_policy(W, bs)`` entries (32 keys): each split takes its own max
over its keys at positions <= pos, sums exp(s - m) unrounded into l, and
sums the probabilities rounded to v's dtype times v into an unnormalised
acc; a second pass combines the splits in split order. The emulation
below writes that mathematics down step by step and is held against the
plain K4 (``ref.paged_decode_attention_ref``) and the reference's Pallas
``paged_decode_attention_grouped`` in interpret mode, at
``test_torch_paged_attention.py``'s positions with 4-key blocks and
splits of 2 blocks: several splits per slot, splits wholly past a slot's
position, and a slot at position 0. Tolerances: rtol = atol = 1e-5 in
float32; in bfloat16, 2e-2 x the max |out| of each (slot, head) row.

K6 (the quantized pool) runs the same splits and combine over rows of
codes: its twin ``split_decode_q`` dequantizes each element as
``quant.dequantize_kv`` does (the decoded code times its row's scale, one
float32 rounding) and does not round the probabilities before the PV
product (v is float32 once dequantized). It is held against the plain K6
(``ref.paged_decode_attention_q_ref``) and the reference's Pallas
``paged_decode_attention_grouped_q`` in interpret mode, for the four grids
(int8, fp8_e4m3, fp8_e5m2, fp16) with float32 and bfloat16 q, at the same
positions, blocks and splits, with the same tolerances.

What this file cannot see: on the CPU the wrapper returns the plain
version, so no line of the CUDA split or combine kernel runs here (the
live splits as a prefix, query rows padded from rep up to a power of two,
the key count clamped at pos and at the table's end, K6's codes decoded
in registers). ``chip_smoke.py`` holds both kernels on the card, each
(slot, head) row against the plain version, a call against its rerun, at
the serve shapes and at a small shape with a rep of 6 and several splits
a slot.
"""

import importlib
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (
    paged_decode_attention_grouped as pallas_k4)
from repro.kernels.flash_attention import (
    paged_decode_attention_grouped_q as pallas_k6)
from repro_torch.core import quant
from repro_torch.kernels.ref import (paged_decode_attention_q_ref,
                                     paged_decode_attention_ref)

port_k4 = importlib.import_module("repro_torch.kernels.flash_attention")

BS, W = 4, 5
POSITIONS = (0, 5, 7, 13)       # test_torch_paged_attention.py's
NEG_INF = -1e30
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rep: int, seed: int = 0):
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


def _split_decode(q, rows, block_table, pos, *, bs, per, p_dtype):
    """The split pass and ordered combine over splits of ``per`` table
    entries, one (slot, kv head, split) at a time: ``rows(blocks, g)``
    gives the float32 K and V rows of kv head ``g`` in ``blocks``, and
    the probabilities are rounded to ``p_dtype`` before the PV product.
    Returns the output and the number of live splits per slot."""
    b, h, d = q.shape
    g = len(rows.heads)
    rep = h // g
    n_split = -(-block_table.shape[1] // per)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    live = []
    for ib in range(b):
        p = int(pos[ib])
        live.append(sum(j * per * bs <= p for j in range(n_split)))
        for ig in range(g):
            qg = q[ib, ig * rep:(ig + 1) * rep].float()          # [rep, D]
            ms, ls, accs = [], [], []
            for j in range(n_split):
                key0 = j * per * bs
                if key0 > p:                  # wholly past pos: m, l only
                    ms.append(torch.full((rep,), NEG_INF))
                    ls.append(torch.zeros(rep))
                    accs.append(None)
                    continue
                blocks = block_table[ib, j * per:(j + 1) * per].long()
                keys, vals = (x[:p - key0 + 1] for x in rows(blocks, ig))
                s = (qg @ keys.T) * scale                        # [rep, n]
                m = s.max(-1).values
                e = torch.exp(s - m[:, None])
                ms.append(m)
                ls.append(e.sum(-1))
                accs.append(e.to(p_dtype).float() @ vals)
            m_all = torch.stack(ms).max(0).values
            num = torch.zeros(rep, d)
            den = torch.zeros(rep)
            for m, l, acc in zip(ms, ls, accs):          # in split order
                if acc is None:
                    continue
                w = torch.exp(m - m_all)
                num = num + w[:, None] * acc
                den = den + w * l
            out[ib, ig * rep:(ig + 1) * rep] = (
                num / den.clamp_min(1e-20)[:, None]).to(q.dtype)
    return out, live


class _Rows:
    """K/V rows of the blocks a split names, as float32 [n, D]: values
    as they are (K4), or codes dequantized element by element (K6)."""

    def __init__(self, k, v, k_scale=None, v_scale=None, kv_dtype=None):
        self.k, self.v = k, v
        self.scales, self.kv_dtype = (k_scale, v_scale), kv_dtype
        self.heads = range(k.shape[2])

    def __call__(self, blocks, g):
        d = self.k.shape[-1]
        out = []
        for x, sc in zip((self.k, self.v), self.scales):
            x = x[blocks, :, g].reshape(-1, d)
            if sc is None:
                out.append(x.float())
                continue
            spec = quant.spec(self.kv_dtype)
            decoded = (x.float() if spec.kind == "int"
                       else quant.decode_float(x, spec))
            out.append(decoded * sc[blocks, :, g].reshape(-1, 1))
        return out


def split_decode(q, k_store, v_store, block_table, pos, *, per):
    """K4's split pass and ordered combine: p rounded to v's dtype."""
    return _split_decode(q, _Rows(k_store, v_store), block_table, pos,
                         bs=k_store.shape[1], per=per,
                         p_dtype=v_store.dtype)


def split_decode_q(q, k_codes, k_scale, v_codes, v_scale, block_table, pos,
                   *, kv_dtype, per):
    """K6's: each element dequantized, p not rounded (float32)."""
    rows = _Rows(k_codes, v_codes, k_scale, v_scale, kv_dtype)
    return _split_decode(q, rows, block_table, pos, bs=k_codes.shape[1],
                         per=per, p_dtype=torch.float32)


def _close(got, want, dtype):
    got = got.float()
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.from_numpy(np.array(want, np.float32)))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        err = (got - want).abs().amax(-1)
        assert bool((err <= 2e-2 * want.abs().amax(-1)).all()), float(
            (err / want.abs().amax(-1)).max())


PER = 2                          # table entries per split: 3 splits a slot


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_schedule_matches_plain_and_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(rep=4)
    q, k, v, table, pos = (torch.from_numpy(a) for a in arrays)
    q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
    got, live = split_decode(q, k, v, table, pos, per=PER)
    assert got.dtype == tdt
    _close(got, paged_decode_attention_ref(q, k, v, table, pos), dtype)
    want = pallas_k4(*(jnp.asarray(a, jdt) if a.dtype == np.float32
                       else jnp.asarray(a) for a in arrays), interpret=True)
    _close(got, want, dtype)
    # several splits in a slot, and splits wholly past position 0's
    assert max(live) > 1 and live[0] == 1 < -(-W // PER)


GRIDS = ("int8", "fp8_e4m3", "fp8_e5m2", "fp16")


def _quantized(rep: int, kv_dtype: str, seed: int = 0):
    """``_inputs`` with K/V quantized by the port's quantizer: codes (the
    fp16 grid's as int16) and float32 scales; scratch block 0 holds the
    grid's largest codes and scales of 3e4, garbage never read."""
    q, k, v, table, pos = _inputs(rep, seed)
    spec = quant.spec(kv_dtype)
    top = ((1 << spec.n_mant) - 1 if spec.kind == "int" else
           (((1 << spec.n_exp) - 1) << spec.n_mant) | ((1 << spec.n_mant) - 1))
    pool = []
    for x in (k, v):
        codes, scale = quant.quantize_kv(torch.from_numpy(x), kv_dtype)
        codes[0] = top
        scale[0] = 3.0e4
        pool += [codes, scale]
    return torch.from_numpy(q), pool, torch.from_numpy(table), \
        torch.from_numpy(pos)


def _reference_view(t: torch.Tensor):
    a = t.numpy()
    return jnp.asarray(a.view(np.uint16) if a.dtype == np.int16 else a)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv_dtype", GRIDS)
def test_quantized_split_schedule_matches_plain_and_pallas(kv_dtype, dtype):
    jdt, tdt = DTYPES[dtype]
    q, pool, table, pos = _quantized(rep=4, kv_dtype=kv_dtype)
    q = q.to(tdt)
    got, live = split_decode_q(q, *pool, table, pos, kv_dtype=kv_dtype,
                               per=PER)
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    _close(got, paged_decode_attention_q_ref(q, *pool, table, pos,
                                             kv_dtype), dtype)
    want = pallas_k6(jnp.asarray(q.float().numpy()).astype(jdt),
                     *(_reference_view(t) for t in pool),
                     jnp.asarray(table.numpy()), jnp.asarray(pos.numpy()),
                     kv_dtype=kv_dtype, interpret=True)
    _close(got, want, dtype)
    assert max(live) > 1 and live[0] == 1 < -(-W // PER)


def test_quantized_split_keeps_probabilities_unrounded():
    """Under bf16 q, K6's p stays float32: rounding it to bf16 before PV,
    as K4 does for a bf16 pool, gives another function whose outputs
    differ from the unrounded schedule's."""
    q, pool, table, pos = _quantized(rep=4, kv_dtype="int8", seed=3)
    q = q.to(torch.bfloat16)
    rows = _Rows(pool[0], pool[2], pool[1], pool[3], "int8")
    kept, _ = _split_decode(q.float(), rows, table, pos, bs=BS, per=PER,
                            p_dtype=torch.float32)
    rounded, _ = _split_decode(q.float(), rows, table, pos, bs=BS, per=PER,
                               p_dtype=torch.bfloat16)
    plain = paged_decode_attention_q_ref(q.float(), *pool, table, pos,
                                         "int8")
    np.testing.assert_allclose(kept.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float((rounded - plain).abs().max()) > 1e-4


@pytest.mark.parametrize("kv_dtype, d, ok", [
    ("int8", 16, True), ("fp8_e4m3", 8, False), ("fp16", 8, True),
    ("fp16", 4, False)])
def test_k6_split_contract_counts_the_bytes_of_a_code(kv_dtype, d, ok):
    """On the card K6 copies rows of codes 16 bytes at a time: D times the
    bytes of a code must be a multiple of 16 (the CPU path takes any D)."""
    q, (kc, ks, vc, vs), table, pos = _quantized(rep=2, kv_dtype=kv_dtype)
    args = (q[..., :d].contiguous(), kc[..., :d].contiguous(), ks,
            vc[..., :d].contiguous(), vs, table, pos)
    port_k4._check_q(*args, kv_dtype)
    if ok:
        port_k4._check_split_q(*args, kv_dtype)
    else:
        with pytest.raises(ValueError, match="16 bytes"):
            port_k4._check_split_q(*args, kv_dtype)


def test_k6_split_contract_wants_pools_on_16_bytes():
    q, (kc, ks, vc, vs), table, pos = _quantized(rep=2, kv_dtype="int8")
    k_off = torch.empty(kc.numel() + 1, dtype=kc.dtype)[1:].view(
        kc.shape).copy_(kc)
    with pytest.raises(ValueError, match="16-byte"):
        port_k4._check_split_q(q, k_off, ks, vc, vs, table, pos, "int8")


def test_split_policy_reads_no_positions():
    assert port_k4.split_policy(4, 16) == (2, 2)       # parity's pool
    assert port_k4.split_policy(64, 16) == (2, 32)     # the serve shapes
    assert port_k4.split_policy(5, 4) == (8, 1)
    assert port_k4.split_policy(3, 64) == (1, 3)       # a block a split
    params = list(inspect.signature(port_k4.split_policy).parameters)
    assert params == ["w", "bs"]
