"""The port's mapping of llama3-8b's decode step against the reference's.

``map_arch("llama3-8b", "serve")`` on both sides: the smoke config at
batch 2 and a 32-token cache, on the fp32 grid and the int8 grid — the
operator graph node by node (48 nodes, the 43 of the layer stack with
``repeat`` 2, named as the reference's ``dot_general.N`` with products
``mm.N``), the op counts, the placement block by block, the report, the
stage costs and ``reconcile()``; then the published config at batch 1,
traced on meta tensors (nothing allocated): its subarrays, replicas and
report. The reference scans the layer stack; the port unrolls it and
folds it back (``mapper.graph``), which a stack of differing layers
refuses. ``partitions`` and ``expand_scans`` map
(``tests/test_torch_partition.py`` and ``test_torch_expand.py`` hold them
to the reference).
"""

import dataclasses

import pytest
import torch

from repro import mapper as ref_mapper
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import estimator as ref_est
from repro.launch import steps as ref_steps
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro_torch import mapper
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.core import estimator
from repro_torch.launch import steps

GRIDS = ("fp32", "int8")
N_NODES = 48
N_SCANNED = 43


def _node_row(nd):
    return (nd.kind, tuple(nd.out_shape), nd.macs, nd.adds, nd.muls,
            nd.weight_shape, tuple(nd.deps), nd.repeat, nd.out_elems)


@pytest.fixture(scope="module", params=GRIDS)
def smoke_pair(request):
    kw = dict(smoke=True, batch=2, seq_len=32, weight_dtype=request.param)
    return (request.param, ref_mapper.map_arch("llama3-8b", "serve", **kw),
            mapper.map_arch("llama3-8b", "serve", **kw))


def test_node_lists_equal(smoke_pair):
    _, ref, port = smoke_pair
    assert [_node_row(nd) for nd in port.graph.nodes] == [
        _node_row(nd) for nd in ref.graph.nodes]
    assert [nd.name for nd in port.graph.nodes] == [
        nd.name.replace("dot_general", "mm") for nd in ref.graph.nodes]
    assert len(port.graph.nodes) == N_NODES
    assert [nd.repeat for nd in port.graph.nodes] == [2] * N_SCANNED + [1] * 5
    assert [nd.scanned for nd in port.graph.nodes] == (
        [True] * N_SCANNED + [False] * 5)
    assert [nd.kind for nd in port.graph.nodes].count("matmul") == 10


def test_op_counts_equal(smoke_pair):
    _, ref, port = smoke_pair
    rcfg, cfg = ref_smoke_config("llama3-8b"), get_smoke_config("llama3-8b")
    rshape = RefShapeSpec("map_serve", 32, 2, "serve")
    shape = ShapeSpec("map_serve", 32, 2, "serve")
    want = ref_est.count_ops(ref_steps.make_serve_step(rcfg),
                             ref_steps.abstract_params(rcfg),
                             ref_steps.abstract_cache(rcfg, rshape),
                             *ref_steps.decode_input_specs(rcfg, rshape))
    got = estimator.count_ops(steps.make_serve_step(cfg),
                              steps.abstract_params(cfg),
                              steps.abstract_cache(cfg, shape),
                              *steps.decode_input_specs(cfg, shape))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert dataclasses.astuple(port.graph.totals()) == dataclasses.astuple(
        ref.graph.totals()) == dataclasses.astuple(want)


def test_placement_equal_block_by_block(smoke_pair):
    grid, ref, port = smoke_pair
    rp, pp = ref.placement, port.placement
    assert sorted(pp.node_placements) == sorted(rp.node_placements)
    assert (pp.n_subarrays, pp.n_tiles, pp.n_chips, pp.curve) == (
        rp.n_subarrays, rp.n_tiles, rp.n_chips, rp.curve)
    for idx, want in rp.node_placements.items():
        got = pp.node_placements[idx]
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert [dataclasses.astuple(b) for b in pp.iter_blocks(idx, 0)] == [
            dataclasses.astuple(b) for b in rp.iter_blocks(idx, 0)]
    assert pp.signature() == rp.signature()
    # the reference's numbers (BENCH_quant.json's llama3-8b smoke rows)
    assert (pp.n_subarrays, sum(np_.replicas for np_ in
                                pp.node_placements.values())) == (
        {"fp32": (23, 10), "int8": (20, 21)}[grid])


def test_report_stages_and_reconcile_equal(smoke_pair):
    _, ref, port = smoke_pair
    assert dataclasses.astuple(port.report) == dataclasses.astuple(
        ref.report)
    for s_port, s_ref in zip(port.stages, ref.stages, strict=True):
        got = dataclasses.replace(s_port, name=s_ref.name)
        assert dataclasses.astuple(got) == dataclasses.astuple(s_ref)
    got, want = port.reconcile(), ref.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"]
    assert got == want
    assert mapper.total_transfer_hops(port.graph, port.placement) == \
        ref_mapper.total_transfer_hops(ref.graph, ref.placement)


@pytest.mark.parametrize("grid,subarrays,replicas",
                         [("fp32", 28_169, 10), ("int8", 26_292, 74)])
def test_full_width_placement_equals_reference(grid, subarrays, replicas):
    """The published config (32 layers, 4096 wide, a 128,256 vocab) at
    batch 1 and a 32-token cache, traced on meta tensors."""
    kw = dict(batch=1, seq_len=32, weight_dtype=grid)
    ref = ref_mapper.map_arch("llama3-8b", "serve", **kw)
    port = mapper.map_arch("llama3-8b", "serve", **kw)
    assert [_node_row(nd) for nd in port.graph.nodes] == [
        _node_row(nd) for nd in ref.graph.nodes]
    assert [nd.repeat for nd in port.graph.nodes] == [32] * N_SCANNED + [
        1] * 5
    pp = port.placement
    assert pp.n_subarrays == ref.placement.n_subarrays == subarrays
    assert sum(np_.replicas for np_ in pp.node_placements.values()) == \
        replicas
    assert {i: dataclasses.astuple(np_)
            for i, np_ in pp.node_placements.items()} == {
        i: dataclasses.astuple(np_)
        for i, np_ in ref.placement.node_placements.items()}
    assert dataclasses.astuple(port.report) == dataclasses.astuple(
        ref.report)
    got = port.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"]
    assert got == ref.reconcile()
    # the LM head: outside the stack, 4096 x 128,256
    head = port.graph.nodes[-1]
    assert (head.repeat, head.weight_shape) == (1, (4096, 128_256))


def test_a_stack_of_differing_layers_refuses_to_fold():
    def step(x, ws):
        for i, w in enumerate(ws):
            with estimator.region("scan", "layers"):
                x = x @ w
                if i == 1:               # the second layer adds a MAC
                    x = x + x
        return x

    x = torch.empty((2, 8), device="meta")
    ws = [torch.empty((8, 8), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="iteration 1 does not repeat"):
        mapper.build_graph(step, x, ws)

    def same(x, ws):
        for w in ws:
            with estimator.region("scan", "layers"):
                x = x @ w + x
        return x

    g = mapper.build_graph(same, x, ws)
    assert [(nd.name, nd.repeat, nd.deps, nd.macs, nd.adds)
            for nd in g.nodes] == [("mm.0", 3, [], 3 * 2 * 8 * 8, 0),
                                   ("add.1", 3, [0], 0, 3 * 16)]


def test_train_kind_and_unported_options_raise():
    """``kind="train"`` maps (``tests/test_torch_arch_train.py`` holds it
    to the reference); so do partitions and scan expansion, on both
    kinds; other kinds raise."""
    assert mapper.map_arch("llama3-8b", "train", smoke=True,
                           seq_len=8).reconcile()["counts_match"]
    cut = mapper.map_arch("llama3-8b", "serve", smoke=True, partitions=2)
    assert len(cut.partitions) == 2
    assert sum(len(p.nodes) for p in cut.partitions) == N_NODES
    expanded = mapper.map_arch("llama3-8b", "serve", smoke=True,
                               expand_scans=True)
    assert expanded.graph.groups == {"layers": 1}
    assert expanded.reconcile()["counts_match"]
    train = mapper.map_arch("llama3-8b", "train", smoke=True, seq_len=8,
                            partitions=3, expand_scans=True)
    assert len(train.partitions) == 3
    assert train.reconcile()["counts_match"]
    with pytest.raises(ValueError, match="kind"):
        mapper.map_arch("llama3-8b", "prefill", smoke=True)


def test_a_config_cut_in_depth_maps_in_its_place():
    """``config`` maps a registered architecture's config changed, here
    cut to 3 layers: the stack folds into ``repeat`` 3, the rest as the
    smoke config's."""
    cut = dataclasses.replace(get_smoke_config("llama3-8b"), n_layers=3)
    sched = mapper.map_arch("llama3-8b", "serve", batch=2, seq_len=32,
                            config=cut)
    smoke = mapper.map_arch("llama3-8b", "serve", smoke=True, batch=2,
                            seq_len=32)
    assert [nd.repeat for nd in sched.graph.nodes] == [3] * N_SCANNED + [
        1] * 5
    assert [(nd.name, nd.out_shape, nd.deps) for nd in sched.graph.nodes] \
        == [(nd.name, nd.out_shape, nd.deps) for nd in smoke.graph.nodes]
    assert sched.reconcile()["counts_match"]
