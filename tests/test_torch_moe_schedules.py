"""The schedules of the mixture-of-experts configs (port queue item 5.3,
the serve half) in the port against the reference's planning, node for
node (kind, shape, MACs, edges, ``repeat``, names), with the subarrays,
the placement node by node, the report, ``reconcile()`` and the stages:

* the decode step (``map_arch(kind="serve")``, seq 128, batch 1) of
  granite-moe-1b-a400m and llama4-maverick-400b-a17b, smoke and
  published (the published traced on meta tensors once and placed on
  both grids), on the fp32 and int8 grids: granite 63 nodes (13 / 5
  subarrays smoke, 3,309 / 2,806 published), maverick 111 (37 / 20 and
  52,220 / 47,636); maverick's smoke stack is one unit, so every node has
  repeat 1;
* the expanded smoke steps (``expand_scans``, chunk 1) at batch 8, with
  the pipeline's modeled speedup within 1e-9 relative, and the
  two-stage partitioned steps;
* the paged tick ``ServeEngine(backend="pim")`` maps
  (``serve.map_paged_tick``) at both smoke configs, gather and kernel
  path, fp32 and int8 pools, with its ``KVPlacement`` (one site per
  block of every unit) and ``KVTraffic``;
* one ``moe_block``'s priced nodes: 19 for granite, 24 for maverick (its
  shared expert's four and their add), in the reference's order, ops and
  shapes — the int32 ``sub``/``mul``/``add`` of the positions and slots
  and the two scatters' index normalizations among them;
* ``count_ops`` of the decode step on both sides.
"""

import dataclasses
import functools

import jax
import jax._src.core as jax_core
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import mapper as ref_mapper
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.core import estimator as ref_est
from repro.launch import steps as ref_steps
from repro.models import moe as ref_moe
from repro.models.transformer import build_model
from repro.serve import kv as ref_kv
from repro_torch import mapper
from repro_torch.configs import ShapeSpec, get_config, get_smoke_config
from repro_torch.core import estimator
from repro_torch.launch import steps
from repro_torch.mapper import schedule as schedule_mod
from repro_torch.mapper.hardware import default_hierarchy
from repro_torch.models import moe
from repro_torch.serve import map_paged_tick
from test_torch_arch_train import _assert_schedules_equal, _row
from test_torch_serve_pim import _assert_plans_equal

ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")
# arch -> (decode step nodes, those of the folded stack, priced nodes
# of one moe_block); subarrays smoke and published, fp32 and int8
NODES = {"granite-moe-1b-a400m": (63, 58, 19),
         "llama4-maverick-400b-a17b": (111, 106, 24)}
SUBARRAYS = {"granite-moe-1b-a400m": ((13, 5), (3_309, 2_806)),
             "llama4-maverick-400b-a17b": ((37, 20), (52_220, 47_636))}


@pytest.fixture(scope="module", autouse=True)
def _shims():
    """Names the reference's planning reads from ``jax.core`` (see
    ``tests/test_torch_partition.py``)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.core, "Literal", jax.extend.core.Literal, raising=False)
    mp.setattr(jax.core, "DropVar", jax_core.DropVar, raising=False)
    mp.setattr(jax.core, "jaxpr_as_fun", jax_core.jaxpr_as_fun,
               raising=False)
    yield
    mp.undo()


def _stages_equal(port, want):
    assert [dataclasses.astuple(s) for s in port.stages] == [
        dataclasses.astuple(dataclasses.replace(s, name=p.name))
        for s, p in zip(want.stages, port.stages, strict=True)]


@pytest.mark.parametrize("grid", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_schedule_equals_reference(arch, grid):
    kw = dict(smoke=True, batch=1, seq_len=128, weight_dtype=grid)
    want = ref_mapper.map_arch(arch, "serve", **kw)
    port = mapper.map_arch(arch, "serve", **kw)
    n_nodes, n_folded, _ = NODES[arch]
    _assert_schedules_equal(port, want, n_nodes,
                            SUBARRAYS[arch][0][grid == "int8"])
    assert port.placement.signature() == want.placement.signature()
    _stages_equal(port, want)
    units = get_smoke_config(arch).n_layers // (2 if "maverick" in arch
                                                else 1)
    assert [nd.repeat for nd in port.graph.nodes] == (
        [units] * n_folded + [1] * (n_nodes - n_folded))
    assert sum(nd.scanned for nd in port.graph.nodes) == n_folded


@pytest.mark.parametrize("arch", ARCHS)
def test_published_decode_schedule_equals_reference(arch):
    cfg = get_config(arch)
    shape = ShapeSpec("map_serve", 128, 1, "serve")
    graph = mapper.build_graph(steps.make_serve_step(cfg),
                               steps.abstract_params(cfg),
                               steps.abstract_cache(cfg, shape),
                               *steps.decode_input_specs(cfg, shape))
    n_nodes, n_folded, _ = NODES[arch]
    for grid, subarrays in zip(("fp32", "int8"), SUBARRAYS[arch][1]):
        port = schedule_mod.build_schedule_from_graph(
            graph, hierarchy=default_hierarchy("proposed", grid))
        want = ref_mapper.map_arch(arch, "serve", batch=1, seq_len=128,
                                   weight_dtype=grid)
        _assert_schedules_equal(port, want, n_nodes, subarrays)
        assert [nd.repeat for nd in port.graph.nodes] == (
            [24] * n_folded + [1] * (n_nodes - n_folded))
    # the LM head, outside the stack: granite's the tied table read
    # transposed
    head = port.graph.nodes[-1]
    assert head.weight_shape == (cfg.d_model, cfg.vocab_size)
    assert not head.transposed


@pytest.mark.parametrize("arch", ARCHS)
def test_expanded_and_partitioned_steps_equal_reference(arch):
    kw = dict(smoke=True, seq_len=32, batch=8)
    port = mapper.map_arch(arch, "serve", expand_scans=True, **kw)
    want = ref_mapper.map_arch(arch, "serve", expand_scans=True, **kw)
    assert [_row(nd) for nd in port.graph.nodes] == [
        _row(nd) for nd in want.graph.nodes]
    # granite's two units unroll into resident copies; maverick's one
    # unit has nothing to expand
    assert port.graph.groups == ({"layers": 1} if "granite" in arch
                                 else {})
    assert len(port.graph.nodes) == (121 if "granite" in arch else 111)
    assert port.placement.n_subarrays == want.placement.n_subarrays
    assert dataclasses.astuple(port.report) == dataclasses.astuple(
        want.report)
    assert port.reconcile() == want.reconcile()
    for k in (2, 4):
        assert port.pipeline(8, partitions=k).speedup == pytest.approx(
            want.pipeline(8, partitions=k).speedup, rel=1e-9)
    port = mapper.map_arch(arch, "serve", partitions=2, **kw)
    want = ref_mapper.map_arch(arch, "serve", partitions=2, **kw)
    _stages_equal(port, want)


def _ref_tick(arch, *, batch, max_len, bs, kernel, kv_dtype):
    """The reference's ``ServeEngine._build_pim`` planning on
    ShapeDtypeStructs (its engine needs real parameters): the KV sites
    are its units times their blocks."""
    cfg = ref_configs.get_smoke_config(arch)
    model = build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    w = -(-max_len // bs)
    nb = 1 + batch * w
    cache = jax.eval_shape(lambda: model.init_paged_cache(
        nb, bs, kv_dtype=kv_dtype))
    step = functools.partial(model.decode_step_paged, kernel=kernel,
                             kv_dtype=kv_dtype)
    ints = [jax.ShapeDtypeStruct(s, jnp.int32)
            for s in ((batch,), (batch, w), (batch,))]
    sched = ref_mapper.build_schedule(step, params, cache, *ints)
    n = len(cache["layers"])
    spec = ref_mapper.KVBlockSpec(
        sites=model.layout.n_units * n, num_blocks=nb, block_size=bs,
        token_bits=ref_kv.kv_token_bits(cfg.n_kv_heads,
                                        cfg.resolved_head_dim, kv_dtype))
    sched.attach_kv(ref_mapper.place_kv(sched.graph, sched.placement, spec),
                    resident_tokens=max(1, max_len // 2), batch=batch)
    return sched


@pytest.mark.parametrize("kernel,pool", [(False, "fp32"), (True, "fp32"),
                                         (False, "int8"), (True, "int8")])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_tick_equals_reference(arch, kernel, pool):
    kw = dict(batch=4, max_len=16, kernel=kernel, kv_dtype=pool)
    want = _ref_tick(arch, bs=4, **kw)
    port = map_paged_tick(get_smoke_config(arch), batch=4, max_len=16,
                          kv_block_size=4, attn_kernel=kernel,
                          kv_dtype=pool)
    _assert_plans_equal(want, port)
    assert port.kv_placement.spec.sites == get_smoke_config(arch).n_layers


def _ref_priced(cfg, x, p):
    closed = jax.make_jaxpr(lambda x, p: ref_moe.moe_block(x, p, cfg))(x, p)
    rows = []
    for eqn, _ in ref_est.iter_eqns(closed.jaxpr):
        kind = ref_est.node_kind(eqn.primitive.name)
        if kind == "matmul":
            rows.append(("matmul", ref_est.dot_general_dims(eqn)))
        elif kind:
            rows.append((eqn.primitive.name,
                         tuple(eqn.outvars[0].aval.shape)))
    return rows


def _port_priced(cfg, x, p):
    cap = estimator.capture(lambda x, p: moe.moe_block(x, p, cfg), x, p)
    rows = []
    for node, _ in estimator.iter_nodes(cap.gm):
        kind = estimator.node_kind(node.target)
        if kind == "matmul":
            rows.append(("matmul", estimator.mm_dims(node)))
        elif kind:
            rows.append((estimator.op_name(node.target),
                         estimator.shape_of(node)))
    return rows


@pytest.mark.parametrize("shape", [(8, 1), (2, 128)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_priced_nodes_equal_reference(arch, shape):
    rcfg, cfg = ref_configs.get_smoke_config(arch), get_smoke_config(arch)
    rp = ref_moe.init_moe(jax.random.PRNGKey(0), cfg.d_model,
                          cfg.n_experts, cfg.moe_d_ff, jnp.float32,
                          shared_expert=cfg.shared_expert,
                          shared_d_ff=cfg.d_ff)
    x = np.zeros((*shape, cfg.d_model), np.float32)
    want = _ref_priced(rcfg, jnp.asarray(x), rp)
    tp = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), rp)
    got = _port_priced(cfg, torch.empty(x.shape, device="meta"), tp)
    assert got == want
    assert len(got) == NODES[arch][2]
    # the expert products are (batch E, m F, n G·C, k D): the dispatch
    # buffer stationary
    grp = moe._n_groups(cfg, shape[0] * shape[1])
    c = moe.capacity(shape[0] * shape[1] // grp, cfg.n_experts, cfg.top_k,
                     cfg.capacity_factor)
    assert got[12] == ("matmul", (cfg.n_experts, cfg.moe_d_ff, grp * c,
                                  cfg.d_model))


@pytest.mark.parametrize("arch", ARCHS)
def test_op_counts_equal_reference(arch):
    rcfg, cfg = ref_configs.get_smoke_config(arch), get_smoke_config(arch)
    rshape = RefShapeSpec("map_serve", 32, 8, "serve")
    shape = ShapeSpec("map_serve", 32, 8, "serve")
    want = ref_est.count_ops(ref_steps.make_serve_step(rcfg),
                             ref_steps.abstract_params(rcfg),
                             ref_steps.abstract_cache(rcfg, rshape),
                             *ref_steps.decode_input_specs(rcfg, rshape))
    got = estimator.count_ops(steps.make_serve_step(cfg),
                              steps.abstract_params(cfg),
                              steps.abstract_cache(cfg, shape),
                              *steps.decode_input_specs(cfg, shape))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
