"""The schedules of the model's inputs and outputs (port queue item 5.2:
musicgen-medium's embedding inputs, qwen2-vl-2b's tied head and M-RoPE)
in the port against the reference's planning, node for node (kind,
shape, MACs, edges, ``repeat``, names), with the subarrays, the
placement node by node, the report and ``reconcile()``:

* the decode step (``map_arch(kind="serve")``): the smoke configs at
  batch 2 and a 32-token cache on the fp32 and int8 grids, against the
  reference's own ``map_arch``, with the placement's signature and the
  stages; the published configs at batch 1 (traced on meta tensors once,
  placed on both grids), the LM head last (qwen2-vl's the tied table's
  transpose, (1536, 151936));
* the train step (``map_arch(kind="train")``): the smoke configs at seq
  8, the published width cut to 2 layers in float32 at seq 128 (remat)
  and the published depth at seq 8, against the reference's planning over
  its jaxpr less the equations with no outputs
  (``test_torch_long_schedules._oracle``: the reference's own train
  mapping stops on them under jax 0.9.0);
* ``count_ops`` of the decode step on both sides.

qwen2-vl's decode step has 4 nodes more than llama3-8b's 48: M-RoPE's
section products, 3 angle products a rotation where the full rotation
has 1, for q and for k.
"""

import dataclasses

import pytest

from repro import mapper as ref_mapper
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.core import estimator as ref_est
from repro.launch import steps as ref_steps
from repro_torch import mapper
from repro_torch.configs import ShapeSpec, get_config, get_smoke_config
from repro_torch.core import estimator
from repro_torch.launch import steps
from repro_torch.mapper import schedule as schedule_mod
from repro_torch.mapper.hardware import default_hierarchy
from test_torch_arch_train import _assert_schedules_equal
from test_torch_long_schedules import _oracle

ARCHS = ("musicgen-medium", "qwen2-vl-2b")
# arch -> decode step nodes, those of the folded stack; subarrays of the
# smoke step (batch 2, cache 32) on the fp32 and int8 grids
SERVE_SMOKE = {"musicgen-medium": ((48, 43), (21, 19)),
               "qwen2-vl-2b": ((52, 47), (23, 20))}
# arch -> (published decode step subarrays, fp32 and int8)
SERVE_FULL = {"musicgen-medium": (1_617, 1_617),
              "qwen2-vl-2b": (11_321, 10_786)}


@pytest.mark.parametrize("grid", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_schedule_equals_reference(arch, grid):
    kw = dict(smoke=True, batch=2, seq_len=32, weight_dtype=grid)
    want = ref_mapper.map_arch(arch, "serve", **kw)
    port = mapper.map_arch(arch, "serve", **kw)
    (n_nodes, n_folded), subarrays = SERVE_SMOKE[arch]
    _assert_schedules_equal(port, want, n_nodes,
                            subarrays[grid == "int8"])
    assert sum(nd.scanned for nd in port.graph.nodes) == n_folded
    assert port.placement.signature() == want.placement.signature()
    assert [dataclasses.astuple(s) for s in port.stages] == [
        dataclasses.astuple(dataclasses.replace(s, name=p.name))
        for s, p in zip(want.stages, port.stages, strict=True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_published_decode_schedule_equals_reference(arch):
    cfg = get_config(arch)
    shape = ShapeSpec("map_serve", 32, 1, "serve")
    graph = mapper.build_graph(steps.make_serve_step(cfg),
                               steps.abstract_params(cfg),
                               steps.abstract_cache(cfg, shape),
                               *steps.decode_input_specs(cfg, shape))
    (n_nodes, n_folded), _ = SERVE_SMOKE[arch]
    for grid, subarrays in zip(("fp32", "int8"), SERVE_FULL[arch]):
        port = schedule_mod.build_schedule_from_graph(
            graph, hierarchy=default_hierarchy("proposed", grid))
        want = ref_mapper.map_arch(arch, "serve", batch=1, seq_len=32,
                                   weight_dtype=grid)
        _assert_schedules_equal(port, want, n_nodes, subarrays)
        assert [nd.repeat for nd in port.graph.nodes] == (
            [cfg.n_layers] * n_folded + [1] * (n_nodes - n_folded))
    # the LM head, outside the stack: the tied table read transposed
    head = port.graph.nodes[-1]
    assert head.weight_shape == (cfg.d_model, cfg.vocab_size)
    assert not head.transposed


# (arch, name, config changes, seq, nodes, subarrays)
TRAIN = [("musicgen-medium", "smoke", {}, 8, 296, 63),
         ("qwen2-vl-2b", "smoke", {}, 8, 286, 73),
         ("musicgen-medium", "full_width_2_layers",
          dict(n_layers=2, dtype="float32"), 128, 335, 5_696),
         ("qwen2-vl-2b", "full_width_2_layers",
          dict(n_layers=2, dtype="float32"), 128, 329, 37_428),
         ("musicgen-medium", "published", {}, 8, 335, 5_156),
         ("qwen2-vl-2b", "published", {}, 8, 329, 37_233)]


@pytest.mark.parametrize("arch,name,changes,seq,n_nodes,subarrays", TRAIN,
                         ids=[f"{r[0]}-{r[1]}" for r in TRAIN])
def test_train_schedule_equals_reference(arch, name, changes, seq, n_nodes,
                                         subarrays):
    base_ref, base = ((ref_smoke_config, get_smoke_config)
                      if name == "smoke" else (ref_config, get_config))
    rcfg = dataclasses.replace(base_ref(arch), **changes)
    cfg = dataclasses.replace(base(arch), **changes)
    port = mapper.map_arch(arch, "train", batch=1, seq_len=seq, config=cfg)
    _assert_schedules_equal(port, _oracle(rcfg, 1, seq), n_nodes, subarrays)
    assert all(nd.scanned for nd in port.graph.nodes
               if nd.kind == "matmul")


@pytest.mark.parametrize("arch", ARCHS)
def test_op_counts_equal_reference(arch):
    """The decode step's op counts (``count_ops``) on both sides, M-RoPE's
    section products and the tied head's MACs included."""
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
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
