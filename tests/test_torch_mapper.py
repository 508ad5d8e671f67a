"""The port's mapper planning against the reference's, on the paper's LeNet.

On both sides: ``map_lenet("serve")`` at batch 4 and 256,
``map_lenet("train")`` (one SGD step on the loss) at batch 4 and 32, and
the schedule of the AdamW trainer step (``build_schedule(train_step,
params, opt_state, batch)``, as the reference's pim trainer builds it) at
batch 32: the operator graph node by node, the op counts, the placement
block by block, the transfer hops, the stage costs and the report, and
``reconcile()``. The port's cost model (``repro_torch.core``,
``mapper.hardware``) is a copy of the reference's pure-Python modules and
the schedule does the same float arithmetic in the same order, so every
number is expected equal to the bit: the report is held to 1e-12
relative as asked, and is in fact asserted bit-equal as well.

The backward graph is torch's autograd graph respelled as the reference's
transposed jaxpr (``repro_torch.core.estimator.capture``): every row
equals the reference's, the eltwise rows included, with no difference
left to pin.
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
from repro.data import DigitsDataset as RefDigits
from repro.models import lenet as ref_lenet
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import mapper
from repro_torch.configs import LENET5
from repro_torch.core import accelerator, cell, cost, estimator
from repro_torch.models import lenet
from repro_torch.optim import make_optimizer

# (kind, batch): the serve and SGD train steps of map_lenet, and the
# AdamW trainer step
CASES = [("serve", 4), ("serve", 256), ("train", 4), ("train", 32),
         ("adamw", 32)]
# nodes of each kind's graph
N_NODES = {"serve": 12, "train": 57, "adamw": 180}
# placed blocks of each case (BENCH_fusion.json: 7 for the forward, fc1
# and fc2 split in two; the backward's products place their stationary
# activations, whose rows grow with the batch)
N_BLOCKS = {("serve", 4): 7, ("serve", 256): 7, ("train", 4): 36,
            ("train", 32): 56, ("adamw", 32): 56}


def _case_id(case):
    kind, b = case
    return f"batch{b}" if kind == "serve" else f"{kind}-batch{b}"


def _ref_adamw_step():
    opt = ref_make_optimizer("adamw", lr=2e-3)

    def train_step(params, opt_state, batch):
        imgs, labels = batch
        loss, grads = jax.value_and_grad(ref_lenet.lenet_loss)(
            params, jnp.asarray(imgs), jnp.asarray(labels))
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return opt, train_step


def _port_adamw_step():
    opt = make_optimizer("adamw", lr=2e-3)

    def train_step(params, opt_state, batch):
        imgs, labels = batch
        grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
            params, imgs, labels)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return opt, train_step


def _adamw_args(b):
    """(reference fn, its args, port fn, its meta-device args)."""
    ref_opt, ref_step = _ref_adamw_step()
    opt, step = _port_adamw_step()
    ref_params = ref_lenet.init_lenet(jax.random.PRNGKey(0), REF_CONFIG)
    batch = RefDigits(batch_size=b, seed=0).batch(0)
    params = lenet.init_lenet(0, LENET5, device="meta")
    meta_batch = tuple(torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                                   device="meta") for x in batch)
    return (ref_step, (ref_params, ref_opt.init(ref_params), batch),
            step, (params, opt.init(params), meta_batch))


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def pair(request):
    kind, b = request.param
    if kind == "adamw":
        ref_fn, ref_args, fn, args = _adamw_args(b)
        return (kind, b, ref_mapper.build_schedule(ref_fn, *ref_args),
                mapper.build_schedule(fn, *args))
    return kind, b, ref_mapper.map_lenet(kind, batch=b), mapper.map_lenet(
        kind, batch=b)


def _node_row(nd):
    return (nd.kind, tuple(nd.out_shape), nd.macs, nd.adds, nd.muls,
            nd.weight_shape, tuple(nd.deps), nd.repeat, nd.out_elems)


def test_node_lists_equal(pair):
    kind, _, ref, port = pair
    assert [_node_row(nd) for nd in port.graph.nodes] == [
        _node_row(nd) for nd in ref.graph.nodes]
    assert [nd.name for nd in port.graph.nodes] == [
        nd.name.replace("dot_general", "mm") for nd in ref.graph.nodes]
    assert len(port.graph.nodes) == N_NODES[kind]
    kinds = [nd.kind for nd in port.graph.matmul_like()]
    if kind == "serve":
        assert kinds == ["conv", "conv", "matmul", "matmul", "matmul"]
    else:
        # forward 2 convs and 3 products; per fc layer its weight's and
        # input's cotangent products; conv2's weight and input cotangents
        # and conv1's weight cotangent
        assert kinds == ["conv", "conv"] + ["matmul"] * 9 + ["conv"] * 3
        halves = [nd.half for nd in port.graph.matmul_like()
                  if nd.kind == "conv"]
        assert halves == ["", "", "weight", "input", "weight"]
        assert [nd.transposed for nd in port.graph.matmul_like()
                if nd.kind == "matmul"] == [False] * 3 + [True, False] * 3


def _count_args(kind, b):
    """(reference fn, args, port fn, args) whose op counts are compared."""
    if kind == "adamw":
        return _adamw_args(b)
    params = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          ref_lenet.init_lenet(jax.random.PRNGKey(0),
                                               REF_CONFIG))
    images = jax.ShapeDtypeStruct((b, 28, 28, 1), jnp.float32)
    port_args = (lenet.init_lenet(0, LENET5, device="meta"),
                 torch.empty((b, 28, 28, 1), device="meta"))
    if kind == "serve":
        return (ref_lenet.lenet_apply, (params, images), lenet.lenet_apply,
                port_args)
    labels = jax.ShapeDtypeStruct((b,), jnp.int32)
    return (jax.grad(ref_lenet.lenet_loss), (params, images, labels),
            torch.func.grad(lenet.lenet_loss),
            (*port_args, torch.empty((b,), dtype=torch.int32,
                                     device="meta")))


def test_op_counts_equal(pair):
    kind, b, ref, port = pair
    ref_fn, ref_args, fn, args = _count_args(kind, b)
    want = ref_est.count_ops(ref_fn, *ref_args)
    got = estimator.count_ops(fn, *args)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert dataclasses.astuple(port.graph.totals()) == dataclasses.astuple(
        ref.graph.totals())


def test_placement_equal_block_by_block(pair):
    kind, b, ref, port = pair
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
    assert n_blocks == N_BLOCKS[kind, b]
    assert pp.signature() == rp.signature()


def test_transfer_hops_equal(pair):
    *_, ref, port = pair
    assert mapper.total_transfer_hops(port.graph, port.placement) == \
        ref_mapper.total_transfer_hops(ref.graph, ref.placement)
    assert mapper.node_homes(port.graph, port.placement) == \
        ref_mapper.node_homes(ref.graph, ref.placement)


def test_report_and_stages_equal(pair):
    kind, b, ref, port = pair
    rr, pr = ref.report, port.report
    assert pr.latency_s == pytest.approx(rr.latency_s, rel=1e-12, abs=0)
    assert pr.energy_j == pytest.approx(rr.energy_j, rel=1e-12, abs=0)
    # the same arithmetic in the same order: bit-equal, every field
    assert dataclasses.astuple(pr) == dataclasses.astuple(rr)
    for s_port, s_ref in zip(port.stages, ref.stages, strict=True):
        got = dataclasses.replace(s_port, name=s_ref.name)
        assert dataclasses.astuple(got) == dataclasses.astuple(s_ref)
    if kind != "serve":
        return
    if b == 4:
        assert pr.latency_s == 0.0046591955
        assert pr.energy_j == 5.3233890820000004e-05
    else:
        assert pr.latency_s == pytest.approx(0.296901274, rel=1e-12)
        assert pr.energy_j == pytest.approx(3.40696901248e-03, rel=1e-12)


def test_reconcile_holds_and_equals_reference(pair):
    *_, ref, port = pair
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
