"""The port's plain K1, K2 and K3 against the reference's Pallas kernels.

The wrappers ``pim_matmul_grouped`` (K1), ``pim_matmul`` (K2), ``pim_mac``
and ``pim_mac_grouped`` (K3) run their plain versions for CPU tensors;
the reference's Pallas kernels run in interpret mode. Same numpy-seeded
inputs on both sides.

* K1 and K2: rtol = atol = 1e-5, because the two sides sum each product
  in another order (torch's CPU matmul against XLA's dot).
* K1 equals K2 on each group, bit for bit — the port's plain K1 runs the
  plain K2 on every group, as its CUDA K1 and K2 share one kernel body.
* K3: the port rounds twice (``acc + a*b`` as two ops, the paper's MAC
  unit and the precision contract). The reference's interpret mode on
  the CPU **contracts** the multiply-add into one fused multiply-add
  (observed with this repository's jax: XLA's CPU backend fuses the
  kernel body), so the two differ by the product's rounding. That error
  is at most half an ulp of ``a*b``, plus the sum's half ulp: where
  ``acc`` cancels the product it is many ulps of the *result*. So K3 is
  held to 1 ulp of max(|a*b|, |out|), and the port's plain K3 is held bit
  for bit to numpy's two-rounding float32 ``acc + a*b``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.pim_mac import (pim_mac, pim_mac_grouped, pim_matmul,
                                         pim_matmul_grouped)

# the reference module (``repro.kernels.pim_mac`` the attribute is the
# function of that name)
pallas = importlib.import_module("repro.kernels.pim_mac")
TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (G, col_groups, M, K, N)
K1_CASES = [(1, 1, 128, 128, 128), (2, 2, 256, 128, 128),
            (4, 2, 128, 256, 128), (3, 1, 128, 256, 256),
            (3, 3, 256, 384, 128)]


@pytest.mark.parametrize("case", K1_CASES, ids=str)
def test_plain_k1_matches_pallas_kernel(case):
    g, cg, m, k, n = case
    rng = np.random.default_rng(sum(case))
    a, b = _normal(rng, g // cg, m, k), _normal(rng, g, k, n)
    want = pallas.pim_matmul_grouped(jnp.asarray(a), jnp.asarray(b),
                                     col_groups=cg, interpret=True)
    got = pim_matmul_grouped(torch.from_numpy(a), torch.from_numpy(b),
                             col_groups=cg)
    assert got.shape == (g, m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", K1_CASES, ids=str)
def test_plain_k1_equals_stacked_k2_bit_for_bit(case):
    g, cg, m, k, n = case
    rng = np.random.default_rng(100 + sum(case))
    a = torch.from_numpy(_normal(rng, g // cg, m, k))
    b = torch.from_numpy(_normal(rng, g, k, n))
    got = pim_matmul_grouped(a, b, col_groups=cg)
    for i in range(g):
        assert torch.equal(got[i], pim_matmul(a[i // cg], b[i]))


# (M, K, N, bm, bn, bk)
K2_CASES = [(128, 128, 128, 128, 128, 128), (256, 384, 128, 128, 128, 128),
            (128, 256, 256, 128, 128, 128), (128, 256, 128, 64, 64, 64)]


@pytest.mark.parametrize("case", K2_CASES, ids=str)
def test_plain_k2_matches_pallas_kernel(case):
    m, k, n, bm, bn, bk = case
    rng = np.random.default_rng(sum(case))
    a, b = _normal(rng, m, k), _normal(rng, k, n)
    want = pallas.pim_matmul(jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bn,
                             bk=bk, interpret=True)
    got = pim_matmul(torch.from_numpy(a), torch.from_numpy(b), bm=bm,
                     bn=bn, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                                  bm=bm, bn=bn, bk=bk), got)


def _within_one_ulp(got: np.ndarray, want: np.ndarray, a, b) -> None:
    """|got - want| <= 1 ulp of max(|a*b|, |want|) (module docstring)."""
    scale = np.maximum(np.abs(a * b), np.abs(want))
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= ulp), float((err / ulp).max())


@pytest.mark.parametrize("shape", [(1024,), (7, 33), (3, 5, 1031)], ids=str)
def test_plain_k3_matches_pallas_kernel_to_one_ulp(shape):
    rng = np.random.default_rng(len(shape))
    a, b, acc = (_normal(rng, *shape) for _ in range(3))
    want = np.asarray(pallas.pim_mac(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(acc), interpret=True))
    got = pim_mac(*(torch.from_numpy(x) for x in (a, b, acc))).numpy()
    _within_one_ulp(got, want, a, b)
    # two roundings, bit for bit: numpy rounds the float32 product, then
    # the float32 sum
    assert np.array_equal(got, acc + a * b)
    assert torch.equal(ops.mac(*(torch.from_numpy(x) for x in (a, b, acc))),
                       torch.from_numpy(got))


# ragged waves of (a, b, acc) shapes
WAVES = [[(5, 7), (64,), (2, 3, 4)], [(1024,), (1,), (33, 31)],
         [(256, 6), (256, 6)]]


@pytest.mark.parametrize("wave", WAVES, ids=str)
def test_plain_k3_grouped_wave_matches_pallas_and_per_triple(wave):
    rng = np.random.default_rng(sum(len(s) for s in wave))
    triples = [tuple(_normal(rng, *s) for _ in range(3)) for s in wave]
    want = pallas.pim_mac_grouped(
        [tuple(jnp.asarray(x) for x in t) for t in triples], interpret=True)
    got = pim_mac_grouped(
        [tuple(torch.from_numpy(x) for x in t) for t in triples])
    assert len(got) == len(wave)
    for (a, b, acc), g, w in zip(triples, got, want):
        assert tuple(g.shape) == a.shape
        _within_one_ulp(g.numpy(), np.asarray(w), a, b)
        one = pim_mac(*(torch.from_numpy(x) for x in (a, b, acc)))
        assert torch.equal(g, one)


def _wrapper_calls():
    a3, b3 = torch.zeros(2, 128, 128), torch.zeros(2, 128, 128)
    a2, b2 = torch.zeros(128, 128), torch.zeros(128, 128)
    x = torch.zeros(4, 5)
    return {
        "pim_matmul_grouped": (pim_matmul_grouped, (a3, b3)),
        "pim_matmul": (pim_matmul, (a2, b2)),
        "pim_mac": (pim_mac, (x, x, x)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_wrapper_refuses_inputs_that_require_grad(name):
    fn, args = _wrapper_calls()[name]
    for i in range(len(args)):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="backward"):
            fn(*bad)
    fn(*args)                                 # the same call without grad
    with pytest.raises(NotImplementedError, match="backward"):
        pim_mac_grouped([tuple(torch.zeros(3, requires_grad=i == 0)
                               for i in range(3)),
                         (torch.zeros(2), torch.zeros(2), torch.zeros(2))])


def test_wrappers_reject_what_the_contract_does_not_take():
    before = (pim_matmul.launches, pim_matmul_grouped.launches,
              pim_mac.launches)
    with pytest.raises(ValueError, match="multiples"):
        pim_matmul(torch.zeros(100, 128), torch.zeros(128, 128))
    with pytest.raises(ValueError, match="col_groups"):
        pim_matmul_grouped(torch.zeros(2, 128, 128),
                           torch.zeros(3, 128, 128), col_groups=2)
    with pytest.raises(TypeError, match="float32"):
        pim_matmul(torch.zeros(128, 128, dtype=torch.float64),
                   torch.zeros(128, 128, dtype=torch.float64))
    with pytest.raises(ValueError, match="differ"):
        pim_mac(torch.zeros(3), torch.zeros(4), torch.zeros(3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        pim_mac(*(torch.zeros(3, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="at least one"):
        pim_mac_grouped([])
    # CPU tensors run the plain versions: nothing is launched
    pim_matmul(torch.zeros(128, 128), torch.zeros(128, 128))
    pim_mac(torch.zeros(3), torch.zeros(3), torch.zeros(3))
    assert before == (pim_matmul.launches,
                      pim_matmul_grouped.launches, pim_mac.launches)
