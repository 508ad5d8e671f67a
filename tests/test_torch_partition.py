"""The port's pipeline partitions against the reference's planning.

``placement.partition`` cuts the port's graph on its top-level units
(``mapper.graph.Unit``), the reference's on its top-level jaxpr
equations; the two index their units each their own way, so what is
compared is what the cut does: each partition's node indices (empty
partitions included), its MAC/add/mul totals, the activation bits
crossing each boundary, the placement's subarrays (tile-aligned stages)
and ``Schedule.pipeline``'s timeline (within 1e-9 relative). The cases:
LeNet-5's forward and SGD step at batch 8 and llama3-8b's decode step
(the smoke config, its stack folded and expanded; the published width
at two of the cuts below), each at 2, 3 and 4 partitions.

Under jax 0.9.0 the reference's planning reads ``jax.core.Literal``,
``jax.core.DropVar`` and ``jax.core.jaxpr_as_fun``, which moved; the
``_shims`` fixture sets the three names back for this module only
(``pytest.MonkeyPatch``), leaving the reference package untouched.
"""

import dataclasses
import math

import jax
import jax._src.core as jax_core
import jax.extend
import pytest
import torch

from repro import mapper as ref_mapper
from repro_torch import mapper
from repro_torch.core import estimator
from repro_torch.mapper import GraphPartition, default_hierarchy, place

KS = (2, 3, 4)


@pytest.fixture(scope="module", autouse=True)
def _shims():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.core, "Literal", jax.extend.core.Literal, raising=False)
    mp.setattr(jax.core, "DropVar", jax_core.DropVar, raising=False)
    mp.setattr(jax.core, "jaxpr_as_fun", jax_core.jaxpr_as_fun,
               raising=False)
    yield
    mp.undo()


CASES = {
    "lenet_serve": lambda m, k: m.map_lenet("serve", batch=8, partitions=k),
    "lenet_train": lambda m, k: m.map_lenet("train", batch=8, partitions=k),
    "llama_smoke": lambda m, k: m.map_arch(
        "llama3-8b", "serve", smoke=True, seq_len=32, batch=1,
        partitions=k),
    "llama_smoke_expanded": lambda m, k: m.map_arch(
        "llama3-8b", "serve", smoke=True, seq_len=32, batch=1,
        partitions=k, expand_scans=True),
}


def _rows(sched):
    return [(p.nodes, p.macs, p.adds, p.muls, p.in_bits, p.out_bits)
            for p in sched.partitions]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_partitions_equal_reference(case, k):
    ref, port = CASES[case](ref_mapper, k), CASES[case](mapper, k)
    assert _rows(port) == _rows(ref)
    assert port.report.n_subarrays == ref.report.n_subarrays
    assert len(port.graph.nodes) == len(ref.graph.nodes)
    assert [nd.repeat for nd in port.graph.nodes] == [
        nd.repeat for nd in ref.graph.nodes]


# the reference's numbers at these cuts: each partition's first and last
# node (None: empty), the boundary bits, the subarrays
TABLE = [
    ("lenet_serve", 2, [(0, 1), (2, 11)], [221_184], 21),
    ("lenet_serve", 3, [(0, 1), (2, 10), (11, 11)], [221_184, 2_560], 21),
    ("lenet_serve", 4, [(0, 1), (2, 10), None, (11, 11)],
     [221_184, 2_560, 2_880], 21),
    ("lenet_train", 2, [(0, 31), (32, 56)], [2_719_616], 39),
    ("lenet_train", 3, [(0, 31), (32, 36), (37, 56)],
     [2_719_616, 692_992], 39),
    ("lenet_train", 4, [(0, 0), (1, 31), (32, 35), (36, 56)],
     [884_736, 2_719_616, 1_572_736], 70),
]


@pytest.mark.parametrize("case,k,ranges,bits,subarrays", TABLE)
def test_partitions_equal_reference_numbers(case, k, ranges, bits,
                                            subarrays):
    sched = CASES[case](mapper, k)
    got = [(p.nodes[0], p.nodes[-1]) if p.nodes else None
           for p in sched.partitions]
    assert got == ranges
    assert [p.out_bits for p in sched.partitions[:-1]] == bits
    assert sched.report.n_subarrays == subarrays


@pytest.mark.parametrize("k,expand,sizes,bits,subarrays", [
    (2, False, [0, 48], [32], 28_169),
    (4, True, [0, 43, 86, 91], [32, 14_811_136, 44_171_264], 60_713)])
def test_full_width_llama_equals_reference(k, expand, sizes, bits,
                                           subarrays):
    """The published config at batch 1 and a 32-token cache, traced on
    meta tensors: with expansion the stack becomes 5 resident chunks of
    at most 7 layers and the cuts land between them."""
    kw = dict(seq_len=32, batch=1, partitions=k, expand_scans=expand)
    port = mapper.map_arch("llama3-8b", "serve", **kw)
    ref = ref_mapper.map_arch("llama3-8b", "serve", **kw)
    assert _rows(port) == _rows(ref)
    assert [len(p.nodes) for p in port.partitions] == sizes
    assert [p.out_bits for p in port.partitions[:-1]] == bits
    assert port.report.n_subarrays == ref.report.n_subarrays == subarrays
    if expand:
        assert port.graph.groups == {"layers": 7}
        assert [u.length for u in port.graph.units if u.loop] == [
            7, 7, 7, 7, 4]
        got, want = port.pipeline(8), ref.pipeline(8)
        assert math.isclose(got.speedup, want.speedup, rel_tol=1e-9)
        assert round(got.speedup, 2) == 1.97


def _timeline_close(got, want):
    for f in ("interval_s", "fill_s", "makespan_s", "sequential_s",
              "link_busy_s"):
        assert math.isclose(getattr(got, f), getattr(want, f),
                            rel_tol=1e-9, abs_tol=0.0), f
    assert math.isclose(got.speedup, want.speedup, rel_tol=1e-9)
    assert got.bottleneck == want.bottleneck
    assert [(p.n_stages, p.macs, p.adds, p.muls, p.out_bits)
            for p in got.partitions] == [
        (p.n_stages, p.macs, p.adds, p.muls, p.out_bits)
        for p in want.partitions]
    for a, b in zip(got.partitions, want.partitions):
        assert math.isclose(a.t_compute_s, b.t_compute_s, rel_tol=1e-9)
        assert math.isclose(a.t_boundary_s, b.t_boundary_s, rel_tol=1e-9)


@pytest.mark.parametrize("m", (2, 8, 64))
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_timeline_equals_reference(case, m):
    ref, port = CASES[case](ref_mapper, 4), CASES[case](mapper, 4)
    _timeline_close(port.pipeline(m), ref.pipeline(m))


def test_lenet_train_pipeline_speedup_is_the_benchmarks():
    """The reference's ``BENCH_pipeline.json`` ``lenet5_train_modeled``:
    4 partitions x 8 microbatches, 1.99x."""
    tl = mapper.map_lenet("train", batch=8, partitions=4).pipeline(8)
    assert tl.n_partitions == 4 and tl.bottleneck == "partition:2"
    assert round(tl.speedup, 2) == 1.99
    assert math.isclose(tl.interval_s, 1.2387055500000002e-2, rel_tol=1e-9)
    assert math.isclose(tl.fill_s, 2.870049850e-2, rel_tol=1e-9)
    assert tl.makespan_s == pytest.approx(tl.fill_s + 7 * tl.interval_s)
    assert tl.sequential_s == pytest.approx(8 * tl.fill_s)
    assert tl.interval_s >= max(p.t_compute_s for p in tl.partitions)
    assert tl.interval_s >= tl.link_busy_s
    assert "partition:" in tl.summary()


def test_recut_on_the_fly_and_degenerate_timelines():
    sched = mapper.map_lenet("serve", batch=4)
    assert sched.partitions is None
    tl = sched.pipeline(8, partitions=1)
    assert tl.n_partitions == 1 and tl.speedup == pytest.approx(1.0)
    train = mapper.map_lenet("train", batch=8, partitions=4)
    s2, s8, s64 = (train.pipeline(m).speedup for m in (2, 8, 64))
    assert s2 < s8 < s64
    with pytest.raises(ValueError, match="microbatches"):
        train.pipeline(0)
    with pytest.raises(ValueError, match="k >= 1"):
        mapper.partition(train.graph, 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_totals_sum_to_count_ops(case):
    sched = CASES[case](mapper, 4)
    counts = estimator.count_ops_graph(sched.graph.gm)
    parts = sched.partitions
    assert sum(p.macs for p in parts) == counts.macs
    assert sum(p.adds for p in parts) == counts.adds
    assert sum(p.muls for p in parts) == counts.muls
    assert sorted(n for p in parts for n in p.nodes) == list(
        range(len(sched.graph.nodes)))
    units = len(sched.graph.units)
    assert parts[0].unit_start == 0 and parts[-1].unit_end == units
    for a, b in zip(parts, parts[1:]):
        assert a.unit_end == b.unit_start
        assert a.out_bits == b.in_bits
    # every stage's schedule cost is filed under its partition
    where = {n: p.idx for p in parts for n in p.nodes}
    assert [s.partition for s in sched.stages] == [
        where[s.node] for s in sched.stages]


@pytest.mark.parametrize("case", sorted(CASES))
def test_reconcile_holds_with_partitions(case):
    sched = CASES[case](mapper, 4)
    got = sched.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"], got
    assert got == CASES[case](ref_mapper, 4).reconcile()


def test_partition_clamps_to_units():
    def f(x, w):
        return x @ w

    g = mapper.build_graph(f, torch.empty((4, 8), device="meta"),
                           torch.empty((8, 8), device="meta"))
    parts = mapper.partition(g, 5)
    assert len(parts) == len(g.units) == 1
    assert parts[0].nodes == (0,)


def test_partition_alignment_when_first_node_is_eltwise():
    """A partition whose first graph node is eltwise (no placement) still
    aligns its first *placed* node to a tile boundary (the reference's
    regression test)."""
    def f(x, w1, w2):
        h = x @ w1
        h = h + 1.0
        return h @ w2

    meta = dict(device="meta")
    g = mapper.build_graph(f, torch.empty((4, 64), **meta),
                           torch.empty((64, 32), **meta),
                           torch.empty((32, 32), **meta))
    assert [nd.kind for nd in g.nodes] == ["matmul", "eltwise", "matmul"]
    parts = [GraphPartition(idx=0, unit_start=0, unit_end=1, nodes=(0,),
                            macs=g.nodes[0].macs, adds=0, muls=0,
                            in_bits=0, out_bits=1),
             GraphPartition(idx=1, unit_start=1, unit_end=len(g.units),
                            nodes=(1, 2), macs=g.nodes[2].macs,
                            adds=g.nodes[1].adds, muls=0, in_bits=1,
                            out_bits=0)]
    h = default_hierarchy("proposed")
    p = place(g, h, partitions=parts)
    assert p.node_placements[2].first_subarray % h.tile.subarrays == 0
    assert p.node_placements[2].first_subarray > 0
    assert not p.node_placements[2].shared
    flat = place(g, h)
    assert flat.node_placements[2].first_subarray == 0


def test_partition_aligned_placement_separates_stage_tiles():
    sched = mapper.map_lenet("train", batch=8, partitions=2)
    p = sched.placement
    per_tile = sched.hierarchy.tile.subarrays
    tiles = [{p.coords(p.node_placements[n].first_subarray)[1]
              for n in gp.nodes if n in p.node_placements}
             for gp in sched.partitions]
    assert not (tiles[0] & tiles[1])
    unaligned = mapper.map_lenet("train", batch=8)
    assert sched.report.n_subarrays <= (unaligned.report.n_subarrays
                                        + per_tile)
    ref = ref_mapper.map_lenet("train", batch=8, partitions=2).placement
    assert {i: dataclasses.astuple(np_)
            for i, np_ in p.node_placements.items()} == {
        i: dataclasses.astuple(np_)
        for i, np_ in ref.node_placements.items()}


def test_quantized_grid_keeps_its_replicas_under_a_cut():
    """``_fp32_area_budget`` and ``_grant_extra_replicas`` see the
    partitions: an int8 grid cut in two keeps the reference's replica
    counts."""
    kw = dict(batch=8, partitions=2, weight_dtype="int8")
    port = mapper.map_lenet("train", **kw)
    ref = ref_mapper.map_lenet("train", **kw)
    assert {i: np_.replicas for i, np_ in
            port.placement.node_placements.items()} == {
        i: np_.replicas for i, np_ in ref.placement.node_placements.items()}
    assert port.report.n_subarrays == ref.report.n_subarrays


def test_units_follow_the_references_spelling():
    """A layout view joins the next op's unit (the reference reads it
    through dimension numbers); a rank promotion is a unit of its own
    with a value (jnp's ``broadcast_in_dim``); function inputs are no
    value."""
    g = mapper.map_lenet("serve", batch=8).graph
    first = g.units[0]
    assert first.fx == ("permute", "permute_1", "convolution")
    assert g.units[1].fx == ()                   # the bias's promotion
    assert (1, 2, 6) in g.values                 # (1, 1, 1, 6): 6 values
    produced = {p for p, _, _ in g.values}
    assert 0 in produced                         # the convolution's output
    assert all(0 <= p <= last <= len(g.units) for p, last, _ in g.values)
