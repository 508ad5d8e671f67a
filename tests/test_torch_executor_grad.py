"""Autograd through the port's per-block executor, against the reference.

The twin of ``tests/test_grouped.py``'s ragged-MLP checks: ``tanh(x @ w1)
@ w2`` with w1 2000×40 placed as 3×2 ragged blocks. The gradients of
``sum(f(...)²)`` through ``ScheduleExecutor.run`` (one K2 per placed
block, its VJP per block), through the compiled program (one K1 per
placed node) and by ``torch.func.grad`` of the plain function agree with
each other and with ``jax.grad`` of the reference's plain ``mlp`` on the
same numpy-seeded arrays, at rtol 1e-4, atol 1e-5 (the reference test's
own). The reference's executor cannot be the oracle: its lowering raises
on this jax (no ``jax.util``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import mapper
from repro_torch.kernels import ref as kernel_ref

TOL = dict(rtol=1e-4, atol=1e-5)


def _ref_mlp(w1, w2, x):
    return jnp.tanh(x @ w1) @ w2


def _mlp(w1, w2, x):
    return torch.tanh(x @ w1) @ w2


def _arrays(seed: int = 0):
    rng = np.random.default_rng(seed)
    w1 = (rng.standard_normal((2000, 40)) * 0.02).astype(np.float32)
    w2 = (rng.standard_normal((40, 24)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8, 2000)).astype(np.float32)
    return w1, w2, x


def _loss(fn):
    return lambda *a: (fn(*a) ** 2).sum()


@pytest.fixture(scope="module")
def ragged():
    arrays = _arrays()
    args = tuple(torch.from_numpy(a) for a in arrays)
    sched = mapper.build_schedule(_mlp, *mapper.abstract_like(args))
    want = jax.grad(_loss(_ref_mlp), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    return sched, args, [np.asarray(w) for w in want]


def _grads(run, args):
    leaves = [a.clone().requires_grad_(True) for a in args]
    loss = _loss(run)(*leaves)
    return loss, torch.autograd.grad(loss, leaves)


def test_placement_is_ragged_both_ways(ragged):
    sched, _, _ = ragged
    np1 = sched.placement.node_placements[sched.graph.matmul_like()[0].idx]
    assert (np1.row_blocks, np1.col_blocks) == (3, 2)


def test_executor_grad_matches_program_plain_and_reference(ragged):
    sched, args, want = ragged
    ex = mapper.ScheduleExecutor(sched, device="cpu")
    prog = mapper.compile_schedule(sched, use_cache=False, device="cpu")
    _, got_ex = _grads(ex.run, args)
    _, got_prog = _grads(prog, args)
    got_plain = torch.func.grad(_loss(_mlp), argnums=(0, 1, 2))(*args)
    for ge, gp, gl, w in zip(got_ex, got_prog, got_plain, want):
        for got in (ge, gp, gl):
            np.testing.assert_allclose(got.numpy(), w, **TOL)
        np.testing.assert_allclose(ge.numpy(), gp.numpy(), **TOL)
        np.testing.assert_allclose(ge.numpy(), gl.numpy(), **TOL)


def test_executor_backward_runs_k2_vjp_per_block(ragged, monkeypatch):
    """Every placed block's product is a K2 ``_Matmul`` node, and its
    cotangents come from K2 launches (its plain version on the CPU): w1's
    6 blocks and w2's one want dA and dB each, except that x wants
    none — 6 dB for w1's blocks, 1 dA + 1 dB for w2's. No native product
    of a placed node is differentiated."""
    sched, args, _ = ragged
    ex = mapper.ScheduleExecutor(sched, device="cpu")
    calls = [0]
    real = kernel_ref.pim_matmul_ref
    monkeypatch.setattr(kernel_ref, "pim_matmul_ref",
                        lambda *a, **k: calls.__setitem__(0, calls[0] + 1)
                        or real(*a, **k))
    w1, w2, x = (a.clone().requires_grad_(r)
                 for a, r in zip(args, (True, True, False)))
    loss = _loss(ex.run)(w1, w2, x)
    assert calls[0] == ex.placed_blocks == 7
    names, seen, stack = [], set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    assert names.count("_MatmulBackward") == 7
    assert not {"MmBackward0", "AddmmBackward0"} & set(names)
    torch.autograd.grad(loss, [w1, w2])
    assert calls[0] - 7 == 6 + 2


def test_executor_without_grad_records_nothing(ragged):
    sched, args, _ = ragged
    leaves = [a.clone().requires_grad_(True) for a in args]
    ex = mapper.ScheduleExecutor(sched, device="cpu")
    with torch.no_grad():
        out = ex.run(*leaves)
    assert out.grad_fn is None and not out.requires_grad
    assert ex.run(*args).grad_fn is None
