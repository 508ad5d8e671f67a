"""The port's mapper planning against the reference's, on the paper's LeNet.

``map_lenet("serve")`` at batch 4 and 256 on both sides: the operator
graph node by node, the op counts, the placement block by block, the
transfer hops, the stage costs and the report, and ``reconcile()``. The
port's cost model (``repro_torch.core``, ``mapper.hardware``) is a copy of
the reference's pure-Python modules and the schedule does the same float
arithmetic in the same order, so every number is expected equal to the
bit: the report is held to 1e-12 relative as asked, and is in fact
asserted bit-equal as well.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import mapper as ref_mapper
from repro.configs.lenet5 import CONFIG as REF_CONFIG
from repro.core import accelerator as ref_acc
from repro.core import cell as ref_cell
from repro.core import cost as ref_cost
from repro.core import estimator as ref_est
from repro.models import lenet as ref_lenet
from repro_torch import mapper
from repro_torch.configs import LENET5
from repro_torch.core import accelerator, cell, cost, estimator
from repro_torch.models import lenet

BATCHES = (4, 256)


@pytest.fixture(scope="module", params=BATCHES, ids=lambda b: f"batch{b}")
def pair(request):
    b = request.param
    return b, ref_mapper.map_lenet("serve", batch=b), mapper.map_lenet(
        "serve", batch=b)


def _node_row(nd):
    return (nd.kind, tuple(nd.out_shape), nd.macs, nd.adds, nd.muls,
            nd.weight_shape, tuple(nd.deps), nd.repeat, nd.out_elems)


def test_node_lists_equal(pair):
    _, ref, port = pair
    assert [_node_row(nd) for nd in port.graph.nodes] == [
        _node_row(nd) for nd in ref.graph.nodes]
    assert len(port.graph.nodes) == 12
    assert [nd.kind for nd in port.graph.matmul_like()] == [
        "conv", "conv", "matmul", "matmul", "matmul"]


def test_op_counts_equal(pair):
    b, ref, port = pair
    images = jax.ShapeDtypeStruct((b, 28, 28, 1), jnp.float32)
    params = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          ref_lenet.init_lenet(jax.random.PRNGKey(0),
                                               REF_CONFIG))
    want = ref_est.count_ops(ref_lenet.lenet_apply, params, images)
    got = estimator.count_ops(lenet.lenet_apply,
                              lenet.init_lenet(0, LENET5, device="meta"),
                              torch.empty((b, 28, 28, 1), device="meta"))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert dataclasses.astuple(port.graph.totals()) == dataclasses.astuple(
        ref.graph.totals())


def test_placement_equal_block_by_block(pair):
    _, ref, port = pair
    rp, pp = ref.placement, port.placement
    assert sorted(pp.node_placements) == sorted(rp.node_placements)
    assert (pp.n_subarrays, pp.n_tiles, pp.n_chips, pp.curve) == (
        rp.n_subarrays, rp.n_tiles, rp.n_chips, rp.curve)
    n_blocks = 0
    for idx, want in rp.node_placements.items():
        got = pp.node_placements[idx]
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.replicas == want.replicas
        assert got.blocks_per_replica == want.blocks_per_replica
        blocks = [dataclasses.astuple(b) for b in pp.iter_blocks(idx, 0)]
        assert blocks == [dataclasses.astuple(b)
                          for b in rp.iter_blocks(idx, 0)]
        n_blocks += len(blocks)
    assert n_blocks == 7                     # fc1 and fc2 split in two
    assert pp.signature() == rp.signature()


def test_transfer_hops_equal(pair):
    _, ref, port = pair
    assert mapper.total_transfer_hops(port.graph, port.placement) == \
        ref_mapper.total_transfer_hops(ref.graph, ref.placement)
    assert mapper.node_homes(port.graph, port.placement) == \
        ref_mapper.node_homes(ref.graph, ref.placement)


def test_report_and_stages_equal(pair):
    b, ref, port = pair
    rr, pr = ref.report, port.report
    assert pr.latency_s == pytest.approx(rr.latency_s, rel=1e-12, abs=0)
    assert pr.energy_j == pytest.approx(rr.energy_j, rel=1e-12, abs=0)
    # the same arithmetic in the same order: bit-equal, every field
    assert dataclasses.astuple(pr) == dataclasses.astuple(rr)
    for s_port, s_ref in zip(port.stages, ref.stages, strict=True):
        got = dataclasses.replace(s_port, name=s_ref.name)
        assert dataclasses.astuple(got) == dataclasses.astuple(s_ref)
    if b == 4:
        assert pr.latency_s == 0.0046591955
        assert pr.energy_j == 5.3233890820000004e-05
    else:
        assert pr.latency_s == pytest.approx(0.296901274, rel=1e-12)
        assert pr.energy_j == pytest.approx(3.40696901248e-03, rel=1e-12)


def test_reconcile_holds_and_equals_reference(pair):
    _, ref, port = pair
    got, want = port.reconcile(), ref.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"]
    assert got == want


@pytest.mark.parametrize("tech", ["ultrafast", "floatpim"])
def test_other_techs_price_equal(tech):
    ref = ref_mapper.map_lenet("serve", batch=4, tech=tech)
    port = mapper.map_lenet("serve", batch=4, tech=tech)
    assert dataclasses.astuple(port.report) == dataclasses.astuple(ref.report)


def test_cost_model_constants_equal():
    for tech in ("proposed", "ultrafast", "floatpim"):
        assert dataclasses.astuple(mapper.make_subarray(tech)) == \
            dataclasses.astuple(ref_mapper.make_subarray(tech))
        assert mapper.default_hierarchy(tech).fingerprint() == \
            ref_mapper.default_hierarchy(tech).fingerprint()
        a, r = accelerator.PIMAccelerator(tech), ref_acc.PIMAccelerator(tech)
        assert (dataclasses.astuple(a.mac), a.e_write_bit, a.t_write_bit,
                a.workspace, a.cell_area, a.periph_factor) == (
            dataclasses.astuple(r.mac), r.e_write_bit, r.t_write_bit,
            r.workspace, r.cell_area, r.periph_factor)
        counts = estimator.OpCounts(1035896, 18356, 4480)
        want = ref_est.pim_estimate(ref_est.OpCounts(1035896, 18356, 4480),
                                    tech=tech, weight_bits=21655 * 32)
        got = estimator.pim_estimate(counts, tech=tech,
                                     weight_bits=21655 * 32)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for derive in ("derive_sot_mram_costs", "derive_ultrafast_costs"):
        assert dataclasses.astuple(getattr(cell, derive)()) == \
            dataclasses.astuple(getattr(ref_cell, derive)())
    assert cost.mac_comparison() == ref_cost.mac_comparison()
    assert cost.proposed_mac_breakdown() == ref_cost.proposed_mac_breakdown()
    assert accelerator.training_comparison(batch=4) == \
        ref_acc.training_comparison(batch=4)
    assert (accelerator.SUBARRAY_ROWS, accelerator.SUBARRAY_COLS,
            accelerator.WORKSPACE_PROPOSED, accelerator.WORKSPACE_FLOATPIM) \
        == (ref_acc.SUBARRAY_ROWS, ref_acc.SUBARRAY_COLS,
            ref_acc.WORKSPACE_PROPOSED, ref_acc.WORKSPACE_FLOATPIM)


def test_estimator_declines_what_it_cannot_price():
    def linear(x, w, b):
        return torch.nn.functional.linear(x, w, b)     # -> addmm

    with pytest.raises(NotImplementedError, match="x @ w"):
        estimator.count_ops(linear, torch.empty(4, 8, device="meta"),
                            torch.empty(3, 8, device="meta"),
                            torch.empty(3, device="meta"))
