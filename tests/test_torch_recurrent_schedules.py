"""The decode-step schedules of the recurrent families (port queue item
5.4, the serve half) against the reference's planning, node for node
(kind, shape, MACs, edges, ``repeat``, names), with the subarrays, the
placement node by node, the report and ``reconcile()``:

* the decode steps, ``map_arch(kind="serve")`` at seq 128, batch 1, on
  the fp32 and int8 grids: xlstm-350m smoke (4 layers: 2 units of 67
  nodes, 72 in all; 35 / 30 subarrays) and published (24 layers, traced
  on meta tensors; 4,049 / 3,444), zamba2-7b smoke (5 layers: 2 groups of
  2 and a tail layer; 55 / 48) and published (81 layers: 13 groups of 6
  and 3 tail layers; 17,089 / 17,088); the Mamba2 scan inside each group
  at repeat units × every, the weight-tied shared site at units, the
  tail at its own;
* ``count_ops`` of the step on both sides, at batch 8;
* the expanded smoke steps (``expand_scans``, chunk 1) at batch 8 and
  the two-stage partitioned steps; on the CPU the compiled expanded step
  bit for bit the per-block executor, with the launches the chip's holds
  take as their plan (``chip_smoke.REC_DECODE_PLAN``: the cut configs'
  structure at the smoke width).
"""

import dataclasses

import jax
import jax._src.core as jax_core
import jax.extend
import pytest
import torch

from repro import configs as ref_configs
from repro import mapper as ref_mapper
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.core import estimator as ref_est
from repro.launch import steps as ref_steps
from repro_torch import mapper
from repro_torch.configs import ShapeSpec, get_config, get_smoke_config
from repro_torch.core import estimator
from repro_torch.launch import steps
from repro_torch.mapper import schedule as schedule_mod
from repro_torch.mapper.hardware import default_hierarchy
from repro_torch.models import transformer
from test_torch_arch_train import _assert_schedules_equal, _row

ARCHS = ("xlstm-350m", "zamba2-7b")
# arch -> subarrays (fp32, int8), smoke and published
SUBARRAYS = {"xlstm-350m": ((35, 30), (4_049, 3_444)),
             "zamba2-7b": ((55, 48), (17_089, 17_088))}


def _repeats(arch: str, cfg) -> list[int]:
    """Each node's ``repeat``: xlstm's 67 unit nodes at the units, zamba2's
    21 Mamba2 nodes at units × every, its 25 shared-site nodes at units,
    the tail's 21 at its layers; then the final norm and the head."""
    units = transformer.n_units(cfg)
    if arch == "xlstm-350m":
        body = [units] * 67
    else:
        body = ([units * cfg.shared_attn_every] * 21 + [units] * 25
                + [transformer.tail_units(cfg)] * 21)
    return body + [1] * 5


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
    _assert_schedules_equal(port, want, 72,
                            SUBARRAYS[arch][0][grid == "int8"])
    assert port.placement.signature() == want.placement.signature()
    _stages_equal(port, want)
    assert [nd.repeat for nd in port.graph.nodes] == _repeats(
        arch, get_smoke_config(arch))
    assert sum(nd.scanned for nd in port.graph.nodes) == 67


@pytest.mark.parametrize("arch", ARCHS)
def test_published_decode_schedule_equals_reference(arch):
    cfg = get_config(arch)
    shape = ShapeSpec("map_serve", 128, 1, "serve")
    graph = mapper.build_graph(steps.make_serve_step(cfg),
                               steps.abstract_params(cfg),
                               steps.abstract_cache(cfg, shape),
                               *steps.decode_input_specs(cfg, shape))
    for grid, subarrays in zip(("fp32", "int8"), SUBARRAYS[arch][1]):
        port = schedule_mod.build_schedule_from_graph(
            graph, hierarchy=default_hierarchy("proposed", grid))
        want = ref_mapper.map_arch(arch, "serve", batch=1, seq_len=128,
                                   weight_dtype=grid)
        _assert_schedules_equal(port, want, 72, subarrays)
    assert [nd.repeat for nd in port.graph.nodes] == _repeats(arch, cfg)
    head = port.graph.nodes[-1]
    assert head.weight_shape == (cfg.d_model, cfg.vocab_size)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_expanded_and_partitioned_steps_equal_reference(arch):
    kw = dict(smoke=True, seq_len=32, batch=8)
    port = mapper.map_arch(arch, "serve", expand_scans=True, **kw)
    want = ref_mapper.map_arch(arch, "serve", expand_scans=True, **kw)
    assert [_row(nd) for nd in port.graph.nodes] == [
        _row(nd) for nd in want.graph.nodes]
    assert [nd.name for nd in port.graph.nodes] == [
        nd.name.replace("dot_general", "mm") for nd in want.graph.nodes]
    # the units unroll into resident copies; zamba2's Mamba2 layers stay a
    # folded loop of their own inside each unrolled group
    assert port.graph.groups == {"layers": 1}
    assert len(port.graph.nodes) == {"xlstm-350m": 139,
                                     "zamba2-7b": 118}[arch]
    assert port.placement.n_subarrays == want.placement.n_subarrays
    assert dataclasses.astuple(port.report) == dataclasses.astuple(
        want.report)
    assert port.reconcile() == want.reconcile()
    port = mapper.map_arch(arch, "serve", partitions=2, **kw)
    want = ref_mapper.map_arch(arch, "serve", partitions=2, **kw)
    _stages_equal(port, want)


# the chip's holds' cut structure (chip_smoke.REC_LAYERS): xlstm's 2 units,
# zamba2's 2 groups of 6 and the tail's 1 — at the smoke width
CUTS = {"xlstm-350m": dict(n_layers=4),
        "zamba2-7b": dict(n_layers=13, shared_attn_every=6)}
# (K1 / K5 launches, K3 launches, the executor's K3) of one compiled step:
# chip_smoke.REC_DECODE_PLAN
PLAN = {"xlstm-350m": (29, 81, 95), "zamba2-7b": (15, 23, 23)}


@pytest.mark.parametrize("grid", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expanded_step_equals_executor_with_the_chip_plan(arch, grid):
    cfg = dataclasses.replace(get_smoke_config(arch), **CUTS[arch])
    prog = mapper.compile_arch(arch, "serve", batch=8, seq_len=16,
                               config=cfg, expand_scans=True,
                               weight_dtype=grid, device="cpu")
    model = transformer.DecoderLM(cfg, device="cpu").init(3)
    params, cache = model.stacked_params(), model.init_cache(8, 16)
    tok = torch.arange(8, dtype=torch.int32) * 7
    pos = torch.tensor(2, dtype=torch.int32)
    got = prog(params, cache, tok, pos)
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    want = ex.run(params, cache, tok, pos)
    leaves = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b)
               for a, b in zip(leaves(got), leaves(want), strict=True))
    assert (prog.matmul_launches, prog.eltwise_launches,
            prog.eltwise_calls) == PLAN[arch]
    assert prog.schedule.graph.groups == {"layers": 1}
    if grid == "fp32":
        plain = transformer.decode_step(cfg, params, cache, tok, pos)
        for a, b in zip(leaves(got), leaves(plain), strict=True):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
