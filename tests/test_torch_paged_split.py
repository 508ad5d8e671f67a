"""K4's split-KV schedule ("flash-decoding"), emulated in torch on the CPU.

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

What this file cannot see: on the CPU the wrapper returns the plain
version, so no line of the CUDA split or combine kernel runs here (the
live splits as a prefix, query rows padded from rep up to a power of two,
the key count clamped at pos and at the table's end). ``chip_smoke.py``
holds the kernel itself on the card, each (slot, head) row against the
plain version, a call against its rerun, at the serve shapes and at a
small shape with a rep of 6 and several splits a slot.
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
from repro_torch.kernels.ref import paged_decode_attention_ref

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


def split_decode(q, k_store, v_store, block_table, pos, *, per):
    """K4's split pass and ordered combine over splits of ``per`` table
    entries, one (slot, kv head, split) at a time. Returns the output
    and the number of live splits per slot."""
    b, h, d = q.shape
    _, bs, g, _ = k_store.shape
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
                keys = k_store[blocks, :, ig].reshape(-1, d)[:p - key0 + 1]
                vals = v_store[blocks, :, ig].reshape(-1, d)[:p - key0 + 1]
                s = (qg @ keys.float().T) * scale                # [rep, n]
                m = s.max(-1).values
                e = torch.exp(s - m[:, None])
                ms.append(m)
                ls.append(e.sum(-1))
                accs.append(e.to(v_store.dtype).float() @ vals.float())
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


def test_split_policy_reads_no_positions():
    assert port_k4.split_policy(4, 16) == (2, 2)       # parity's pool
    assert port_k4.split_policy(64, 16) == (2, 32)     # the serve shapes
    assert port_k4.split_policy(5, 4) == (8, 1)
    assert port_k4.split_policy(3, 64) == (1, 3)       # a block a split
    params = list(inspect.signature(port_k4.split_policy).parameters)
    assert params == ["w", "bs"]
