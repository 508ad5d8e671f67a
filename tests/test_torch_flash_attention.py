"""The port's causal GQA flash attention (K7) against the reference.

Twins of ``tests/test_kernels.py``'s flash-attention sweep: the port's
``flash_attention`` and ``ops.attention`` (on CPU tensors, their plain
version ``flash_attention_ref``) against the reference's
``ops.attention`` (the Pallas kernel in interpret mode), at the same
shapes, dtypes and tolerances (2e-5 float32, 2e-2 bfloat16), on the same
numpy-seeded inputs; the wrapper's contract (chunks, shapes, dtypes,
forward only) raises where the reference's asserts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro_torch.kernels import flash_attention, flash_attention_ref, ops
from repro_torch.kernels.flash_attention import flash_head_dim

SHAPES = [(1, 128, 4, 2, 64), (2, 128, 8, 8, 32), (1, 64, 6, 3, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(bshgd, seed=0):
    b, s, h, g, d = bshgd
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, g, d)).astype(np.float32),
            rng.standard_normal((b, s, g, d)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bshgd", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_matches_pallas_kernel(bshgd, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(bshgd)
    want = ref_ops.attention(*(jnp.asarray(a, jdt) for a in arrays),
                             q_chunk=64, kv_chunk=64)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = ops.attention(q, k, v, q_chunk=64, kv_chunk=64)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want, tol)
    _close(flash_attention(q, k, v), want, tol)   # default chunks clamp


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_sequence_matches_pallas_kernel(dtype):
    """S = 200 is no multiple of the kernel's 64-row tiles: the default
    chunks (256) clamp to S on both sides, and the last tile is ragged."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs((1, 200, 8, 2, 64), seed=2)
    want = ref_ops.attention(*(jnp.asarray(a, jdt) for a in arrays))
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = ops.attention(q, k, v)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_matches_reference_oracle(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(SHAPES[0], seed=1)
    want = ref_kernels.flash_attention_ref(
        *(jnp.asarray(a, jdt) for a in arrays))
    got = flash_attention_ref(*(torch.from_numpy(a).to(tdt)
                                for a in arrays))
    _close(got, want, tol)


def test_causal_and_gqa_heads():
    """Row 0 attends to key 0 only; query heads sharing a kv head see the
    same keys: a query head's output is unchanged when the other group's
    kv head changes."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 64, 6, 3, 16)))
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out[:, 0], v[:, 0].repeat_interleave(2, 1),
                               rtol=1e-6, atol=1e-6)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 2] += 1.0
    v2[:, :, 2] -= 1.0
    out2 = flash_attention(q, k2, v2)
    assert torch.equal(out2[:, :, :4], out[:, :, :4])
    assert not torch.equal(out2[:, :, 4:], out[:, :, 4:])


@pytest.mark.parametrize("kwargs", [dict(q_chunk=48), dict(kv_chunk=96),
                                    dict(q_chunk=0)])
def test_chunks_must_divide_the_sequence(kwargs):
    q, k, v = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v, **kwargs)


def test_contract_raises():
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 64, 6, 3, 16)))
    kv4 = torch.zeros(1, 64, 4, 16)           # 4 kv heads for 6 query heads
    with pytest.raises(ValueError, match=r"G \| H"):
        flash_attention(q, kv4, kv4)
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="forward only"):
        flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():       # no gradient is expected there
        flash_attention(q, k, v)


@pytest.mark.parametrize("d", [112, 80])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_head_dims_the_kernel_pads_match_pallas_kernel(d, dtype):
    """zamba2_7b's head dim 112 and 80: on the card the kernel zero-pads
    them to 128 (``flash_head_dim``); the plain version takes them as
    they are, and both sides hold to the reference's kernel."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs((1, 128, 4, 2, d), seed=3)
    want = ref_ops.attention(*(jnp.asarray(a, jdt) for a in arrays),
                             q_chunk=64, kv_chunk=64)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = ops.attention(q, k, v, q_chunk=64, kv_chunk=64)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want, tol)
    assert flash_head_dim(d) == 128


def test_head_dim_policy_and_its_limit():
    """Each head dim runs on the least compiled size at or above it, up
    to 256; a head dim above 256 raises."""
    assert [flash_head_dim(d) for d in (1, 16, 17, 32, 33, 64, 65, 128,
                                        129, 160, 256)] \
        == [16, 16, 32, 32, 64, 64, 128, 128, 256, 256, 256]
    with pytest.raises(ValueError, match="above the kernel's largest"):
        flash_head_dim(257)


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_head_dims_above_128_match_pallas_kernel(d, dtype):
    """Head dims above 128: on the card 160 is zero-padded to 256 and 256
    runs as it is (``flash_head_dim``); the plain version takes them as
    they are, and both sides hold to the reference's kernel."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs((1, 128, 4, 2, d), seed=4)
    want = ref_ops.attention(*(jnp.asarray(a, jdt) for a in arrays),
                             q_chunk=64, kv_chunk=64)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = ops.attention(q, k, v, q_chunk=64, kv_chunk=64)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want, tol)
    assert flash_head_dim(d) == 256
