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
* The backward passes (the wrappers' ``torch.autograd.Function``s) against
  the reference's custom VJPs under ``jax.grad`` in interpret mode, on the
  same cotangent: K1 and K2 each output row to 1e-5 of that row's largest
  value, K3 to the same 1 ulp; and against torch autograd of the unfused
  float32 expression. A cotangent nobody asks for runs nothing.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
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


def _rows_close(got: torch.Tensor, want, rel: float = 1e-5) -> None:
    """Each row (last dim) of ``got`` within ``rel`` of that row's largest
    |value| in ``want``."""
    want = torch.from_numpy(np.array(want))
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp_min(1e-30)
    assert bool((err <= rel * scale).all()), float((err / scale).max())


def _grads(fn, args, cotangent):
    """torch autograd of ``fn(*args)`` against ``cotangent``, every
    argument requiring grad."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    fn(*leaves).backward(torch.from_numpy(cotangent))
    return [x.grad for x in leaves]


def _ref_grads(fn, args, cotangent):
    """The reference's custom VJP under ``jax.grad``, on the same
    cotangent."""
    return jax.grad(lambda *xs: jnp.sum(fn(*xs) * cotangent),
                    argnums=tuple(range(len(args))))(
        *(jnp.asarray(x) for x in args))


@pytest.mark.parametrize("case", [(2, 1, 128, 256, 128),
                                  (4, 2, 256, 128, 128)], ids=str)
def test_k1_backward_matches_reference_vjp(case):
    g, cg, m, k, n = case
    rng = np.random.default_rng(200 + sum(case))
    a, b = _normal(rng, g // cg, m, k), _normal(rng, g, k, n)
    cot = _normal(rng, g, m, n)
    got = _grads(lambda x, y: pim_matmul_grouped(x, y, col_groups=cg),
                 (a, b), cot)
    want = _ref_grads(lambda x, y: pallas.pim_matmul_grouped(
        x, y, col_groups=cg, interpret=True), (a, b), cot)
    for gg, w in zip(got, want, strict=True):
        assert gg.shape == w.shape
        _rows_close(gg, w)


def test_k2_backward_matches_reference_vjp():
    rng = np.random.default_rng(7)
    a, b, cot = _normal(rng, 256, 128), _normal(rng, 128, 384), \
        _normal(rng, 256, 384)
    got = _grads(pim_matmul, (a, b), cot)
    want = _ref_grads(lambda x, y: pallas.pim_matmul(x, y, interpret=True),
                      (a, b), cot)
    for gg, w in zip(got, want, strict=True):
        _rows_close(gg, w)


def test_k3_backward_matches_reference_vjp_to_one_ulp():
    rng = np.random.default_rng(8)
    a, b, acc, cot = (_normal(rng, 3, 1031) for _ in range(4))
    got = _grads(pim_mac, (a, b, acc), cot)
    want = _ref_grads(lambda x, y, z: pallas.pim_mac(x, y, z,
                                                     interpret=True),
                      (a, b, acc), cot)
    for gg, w, other in zip(got, want, (b, a, np.ones_like(a))):
        _within_one_ulp(gg.numpy(), np.asarray(w), cot, other)
    assert torch.equal(got[2], torch.from_numpy(cot))     # dacc = g


@pytest.mark.parametrize("wave", WAVES, ids=str)
def test_k3_grouped_wave_backward_matches_reference_vjp(wave):
    rng = np.random.default_rng(300 + sum(len(s) for s in wave))
    triples = [tuple(_normal(rng, *s) for _ in range(3)) for s in wave]
    cots = [_normal(rng, *s) for s in wave]
    flat = [x for t in triples for x in t]

    def port(*xs):
        outs = pim_mac_grouped([xs[i:i + 3] for i in range(0, len(xs), 3)])
        return sum((o * torch.from_numpy(c)).sum()
                   for o, c in zip(outs, cots))

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in flat]
    port(*leaves).backward()
    want = jax.grad(lambda *xs: sum(
        jnp.sum(o * c) for o, c in zip(pallas.pim_mac_grouped(
            [xs[i:i + 3] for i in range(0, len(xs), 3)], interpret=True),
            cots)), argnums=tuple(range(len(flat))))(
        *(jnp.asarray(x) for x in flat))
    for i, (leaf, w) in enumerate(zip(leaves, want, strict=True)):
        a, b, _ = triples[i // 3]
        other = (b, a, np.ones_like(a))[i % 3]
        _within_one_ulp(leaf.grad.numpy(), np.asarray(w), cots[i // 3],
                        other)


def _wrapper_calls():
    rng = np.random.default_rng(9)
    a3, b3 = _normal(rng, 2, 128, 256), _normal(rng, 4, 256, 128)
    a2, b2 = _normal(rng, 128, 256), _normal(rng, 256, 128)
    x = [_normal(rng, 4, 5) for _ in range(3)]
    mm = lambda p, q: torch.matmul(p, q)                     # noqa: E731
    return {
        "pim_matmul_grouped": (
            lambda p, q: pim_matmul_grouped(p, q, col_groups=2),
            lambda p, q: mm(p.repeat_interleave(2, 0), q), (a3, b3),
            "pim_matmul_grouped_ref"),
        "pim_matmul": (pim_matmul, mm, (a2, b2), "pim_matmul_ref"),
        "pim_mac": (pim_mac, lambda p, q, r: r + p * q, tuple(x),
                    "pim_mac_wave_ref"),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_wrapper_gradients_match_unfused_autograd(name, monkeypatch):
    """Each wrapper's gradients equal torch autograd of the unfused
    float32 expression (full float32 on the CPU), each row to 1e-5 of its
    largest value (K3 bit for bit); a cotangent nobody asks for runs
    nothing."""
    fn, plain, args, ref_name = _wrapper_calls()[name]
    calls = []
    real = getattr(ref, ref_name)
    monkeypatch.setattr(ref, ref_name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out_shape = fn(*(torch.from_numpy(x) for x in args)).shape
    cot = _normal(np.random.default_rng(10), *out_shape)
    calls.clear()
    got = _grads(fn, args, cot)
    want = _grads(plain, args, cot)
    for gg, w in zip(got, want, strict=True):
        if name == "pim_mac":
            assert torch.equal(gg, w)
        else:
            _rows_close(gg, w.numpy())
    # the forward's launch and one per cotangent (K3's dacc is g itself)
    assert len(calls) == 3
    for i in range(len(args)):
        calls.clear()
        leaves = [torch.from_numpy(x).requires_grad_(j == i)
                  for j, x in enumerate(args)]
        fn(*leaves).backward(torch.from_numpy(cot))
        assert len(calls) == 1 + (0 if (name == "pim_mac" and i == 2)
                                  else 1)
        assert all((x.grad is None) == (j != i)
                   for j, x in enumerate(leaves))
    calls.clear()
    with torch.no_grad():                 # no graph: the plain launch only
        out = fn(*(torch.from_numpy(x).requires_grad_(True) for x in args))
    assert len(calls) == 1 and out.grad_fn is None


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
