"""Scan expansion in the port against the reference.

A folded layer stack is one top-level unit, so no partition cut lands
inside it. ``expand_graph`` folds it per chunk instead: a chunk length of
1 leaves every layer's nodes at top level (resident copies, placed and
run on the kernels), ``g > 1`` makes ``ceil(R / g)`` folded loops. Held
here against the reference's ``expand_scans`` on its own test cases (the
scanned MLP stack of ``tests/test_expand.py``: the full unroll, the
bucketed g = 2 at 4 copies, the refusal that returns the graph itself)
and on llama3-8b's smoke decode step: node lists (kinds, shapes, op
counts, edges, repeats), the plan, totals, ``reconcile()`` and the
pipeline speedup the expansion buys. The port's expanded program runs
the same aten graph; it is held against the plain function.

The ``_shims`` fixture sets three names the reference's planning reads
back into ``jax.core`` for this module only (see
``tests/test_torch_partition.py``).
"""

import dataclasses

import jax
import jax._src.core as jax_core
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import mapper as ref_mapper
from repro.mapper import graph as ref_graph
from repro_torch import mapper
from repro_torch.core import estimator
from repro_torch.mapper import graph


@pytest.fixture(scope="module", autouse=True)
def _shims():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.core, "Literal", jax.extend.core.Literal, raising=False)
    mp.setattr(jax.core, "DropVar", jax_core.DropVar, raising=False)
    mp.setattr(jax.core, "jaxpr_as_fun", jax_core.jaxpr_as_fun,
               raising=False)
    yield
    mp.undo()


def _ref_stack(n_layers, d=16):
    def fn(ws, x):
        def body(h, w):
            return jnp.tanh(h @ w), ()
        h, _ = jax.lax.scan(body, x, ws)
        return h

    ws = np.random.default_rng(0).standard_normal(
        (n_layers, d, d)).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((8, d)).astype(np.float32)
    return fn, ws, x


def _port_stack(ws, x):
    """The reference's scanned MLP stack: one ``"scan"`` region an
    iteration."""
    h = x
    for i in range(ws.shape[0]):
        with estimator.region("scan", "layers"):
            h = torch.tanh(h @ ws[i])
    return h


def _graphs(n_layers, d=16):
    fn, ws, x = _ref_stack(n_layers, d)
    ref = ref_mapper.build_graph(fn, ws, x)
    port = mapper.build_graph(_port_stack, torch.from_numpy(ws),
                              torch.from_numpy(x))
    return ref, port, (ws, x)


def _rows(g):
    return [(nd.kind, tuple(nd.out_shape), nd.macs, nd.adds, nd.muls,
             nd.weight_shape, tuple(nd.deps), nd.repeat)
            for nd in g.nodes]


# (weight_rows, weight_cols, budget) -> the reference's plan value
PLANS = [((1000, 32, 10**9), 1),         # the full unroll fits
         ((8, 8, 16), 2),                # 4 copies: chunks of 2
         ((8, 8, 12), 3)]                # 3 copies: chunks of 3, 3, 2


@pytest.mark.parametrize("knobs,g", PLANS)
def test_plan_and_expansion_equal_reference(knobs, g):
    rows, cols, budget = knobs
    kw = dict(weight_rows=rows, weight_cols=cols, budget=budget)
    ref, port, _ = _graphs(8)
    assert _rows(port) == _rows(ref)
    assert list(graph.scan_lengths(port).values()) == list(
        ref_graph.scan_lengths(ref.closed_jaxpr).values()) == [8]
    assert list(graph.plan_scan_expansion(port, **kw).values()) == list(
        ref_graph.plan_scan_expansion(ref, **kw).values()) == [g]
    ex, ref_ex = mapper.expand_graph(port, **kw), ref_mapper.expand_graph(
        ref, **kw)
    assert ex is not port and _rows(ex) == _rows(ref_ex)
    assert ex.totals() == port.totals()
    assert ex.weight_values() == ref_ex.weight_values()
    assert [nd.scanned for nd in ex.nodes] == [g > 1] * len(ex.nodes)
    assert sorted(graph.scan_lengths(ex).values()) == sorted(
        ref_graph.scan_lengths(ref_ex.closed_jaxpr).values())


def test_full_unroll_makes_resident_copies():
    ref, port, (ws, x) = _graphs(4)
    kw = dict(weight_rows=1000, weight_cols=32, budget=10**9)
    ex = mapper.expand_graph(port, **kw)
    assert not graph.scan_lengths(ex)
    assert ex.totals() == port.totals()
    assert estimator.count_ops_graph(ex.gm) == estimator.count_ops_graph(
        port.gm)
    # resident weight footprint grows R-fold, one matmul node a layer
    assert ex.weight_values() == 4 * port.weight_values()
    assert len(ex.matmul_like()) == 4 * len(port.matmul_like())
    assert all(nd.repeat == 1 and not nd.scanned for nd in ex.matmul_like())
    # the layers chain: layer i reads layer i - 1 (the reference's edges)
    assert [nd.deps for nd in ex.nodes] == [[], [0], [1], [2]]
    # cuts land between the copies: balanced, not monolithic
    total = sum(p.work for p in mapper.partition(port, 4))
    assert max(p.work for p in mapper.partition(port, 4)) == total
    parts = mapper.partition(ex, 4)
    assert len(parts) == 4 and max(p.work for p in parts) < total
    assert [p.nodes for p in parts] == [(0,), (1,), (2,), (3,)]


def test_bucketed_expansion_respects_budget_and_refusal_returns_graph():
    _, port, _ = _graphs(8)
    copy_blocks = 4                      # one 16 x 16 layer on 8 x 8 blocks
    ex = mapper.expand_graph(port, weight_rows=8, weight_cols=8,
                             budget=copy_blocks * 4)
    assert ex.groups == {"layers": 2}
    assert len(ex.matmul_like()) == 4
    assert all(nd.repeat == 2 and nd.scanned for nd in ex.matmul_like())
    assert [u.length for u in ex.units if u.loop] == [2, 2, 2, 2]
    assert ex.totals() == port.totals()
    assert graph.plan_scan_expansion(port, weight_rows=8, weight_cols=8,
                                     budget=copy_blocks) == {}
    assert mapper.expand_graph(port, weight_rows=8, weight_cols=8,
                               budget=copy_blocks) is port


@pytest.mark.parametrize("g", (1, 3))
def test_expanded_program_runs_the_same_function(g):
    """The expanded schedule compiles and runs: layers on the kernels
    (g = 1) or as folded loops (g = 3), within 1e-5 of the plain stack."""
    _, _, (ws, x) = _graphs(8)
    ws, x = torch.from_numpy(ws), torch.from_numpy(x)
    port = mapper.build_graph(_port_stack, ws, x)
    ex = mapper.expand_graph(port, weight_rows=1000 if g == 1 else 8,
                             weight_cols=32 if g == 1 else 8,
                             budget=10**9 if g == 1 else 4 * 3)
    assert ex.groups == {"layers": g}
    sched = mapper.build_schedule_from_graph(ex)
    prog = mapper.compile_schedule(sched, use_cache=False, device="cpu")
    got = prog(ws, x)
    torch.testing.assert_close(got, _port_stack(ws, x), rtol=1e-5,
                               atol=1e-5)
    assert prog.matmul_launches == (8 if g == 1 else 0)


def test_llama_smoke_expanded_equals_reference():
    kw = dict(smoke=True, seq_len=32, batch=1, expand_scans=True)
    port = mapper.map_arch("llama3-8b", "serve", **kw)
    ref = ref_mapper.map_arch("llama3-8b", "serve", **kw)
    assert port.graph.groups == {"layers": 1}
    assert _rows(port.graph) == _rows(ref.graph)
    assert len(port.graph.nodes) == 91
    assert dataclasses.astuple(port.report) == dataclasses.astuple(
        ref.report)
    got = port.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"]
    assert got == ref.reconcile()
    folded = mapper.map_arch("llama3-8b", "serve", smoke=True, seq_len=32,
                             batch=1)
    assert port.graph.totals() == folded.graph.totals()
    # the cuts inside the stack lift the modeled speedup past the
    # monolith's ~1.1x
    tl, ref_tl = port.pipeline(8, partitions=4), ref.pipeline(
        8, partitions=4)
    assert tl.speedup == pytest.approx(ref_tl.speedup, rel=1e-9)
    assert round(tl.speedup, 2) == 2.19
    assert folded.pipeline(8, partitions=4).speedup < 1.2


def test_lenet_has_no_stack_to_expand():
    sched = mapper.map_lenet("train", expand_scans=True)
    assert sched.graph.groups == {}
    got = sched.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"]
    assert not graph.scan_lengths(sched.graph)
