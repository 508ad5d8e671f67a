"""The schedules of llama3-8b's steps above seq 2048 and with
``grad_accum > 1`` in the port against the reference's planning, node for
node (kind, shape, MACs, edges, ``repeat``, names), with the placement,
the report and ``reconcile()``:

* ``map_arch("llama3-8b", "train")`` at seq 2560 and 4096, with remat,
  with ``grad_accum=2`` (seq 8 and 2560) and at llama3-8b's full width cut
  to 2 layers (seq 4096; ``grad_accum=2`` at seq 128). The pair scan of
  the chunked attention folds inside the layer stack and its transpose,
  the layer stack inside the microbatch scan: the repeats multiply, as in
  the reference's ``iter_eqn``;
* ``make_prefill_step`` (the reference's ``map_arch`` has no prefill
  kind: its ``build_graph`` on the step) at seq 2560, the chunked branch,
  and 2048, the full one;
* the capture that traces a pair scan's first pair and copies its nodes
  for the others (``attention.COPY_TRACED_PAIRS``) against tracing every
  pair: the same aten graph, node for node.

The reference's own ``map_arch(kind="train")`` raises under jax 0.9.0
(``tests/test_torch_arch_train.py``); these train steps also hold
equations with no outputs inside sub-jaxprs (``grad_accum``: a ``jit`` in
the microbatch scan; remat: a ``jit`` in a ``jit`` and one in a
``scan``), so the oracle here drops them recursively (``_live``), leaving
the reference package untouched. The published config's train step at
seq 4096 and its prefill at 8192 and 32768 trace about 10^5 aten ops
each, minutes on the CPU: ``scripts/check_long_schedules.py`` checks them.
"""

import collections
import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.launch import steps as ref_steps
from repro.mapper import graph as ref_graph
from repro.mapper import schedule as ref_schedule
from repro.mapper.hardware import default_hierarchy as ref_hierarchy
from repro_torch import mapper
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import estimator
from repro_torch.launch import steps
from repro_torch.mapper import schedule as schedule_mod
from repro_torch.models import attention
from test_torch_arch_train import _assert_schedules_equal


def _live(jaxpr):
    """``jaxpr`` without its equations that have no outputs, in it and in
    every sub-jaxpr (module docstring): each equation with a sub-jaxpr is
    rebuilt with ``eqn.replace``."""
    def live(v):
        if isinstance(v, jax.extend.core.ClosedJaxpr):
            return v.replace(jaxpr=_live(v.jaxpr))
        if isinstance(v, jax.extend.core.Jaxpr):
            return _live(v)
        if isinstance(v, tuple) and v and all(
                isinstance(b, jax.extend.core.ClosedJaxpr) for b in v):
            return tuple(live(b) for b in v)
        return v

    eqns = []
    for e in jaxpr.eqns:
        if e.outvars:
            params = {k: live(v) for k, v in e.params.items()}
            changed = any(params[k] is not v for k, v in e.params.items())
            eqns.append(e.replace(params=params) if changed else e)
    return jaxpr.replace(eqns=eqns)


def _oracle(rcfg, batch: int, seq: int):
    """The reference's schedule of ``make_train_step(rcfg)``, built as its
    ``map_arch`` builds it (the batch rounded up to a multiple of
    ``grad_accum``), less the equations with no outputs."""
    if rcfg.grad_accum > 1:
        batch = max(1, -(-batch // rcfg.grad_accum)) * rcfg.grad_accum
    p = ref_steps.abstract_params(rcfg)
    closed = jax.make_jaxpr(ref_steps.make_train_step(rcfg))(
        p, ref_steps.abstract_opt_state(rcfg, p),
        ref_steps.input_specs(rcfg, RefShapeSpec("map_train", seq, batch,
                                                 "train")))
    g = ref_graph.build_graph_from_jaxpr(
        closed.replace(jaxpr=_live(closed.jaxpr)))
    return ref_schedule.build_schedule_from_graph(
        g, hierarchy=ref_hierarchy("proposed", "fp32"))


# (name, config changes, batch, seq, nodes, subarrays, nodes by repeat)
ROWS = [
    ("smoke_2560", dict(), 1, 2560, 347, 817,
     {1: 193, 2: 79, 5: 13, 30: 62}),
    ("smoke_2560_remat", dict(remat=True), 1, 2560, 405, 901,
     {1: 193, 2: 114, 5: 13, 30: 85}),
    ("smoke_4096", dict(), 1, 4096, 347, 1049,
     {1: 193, 2: 79, 8: 13, 72: 62}),
    ("smoke_accum_8", dict(grad_accum=2), 1, 8, 322, 73,
     {1: 184, 2: 48, 4: 90}),
    ("smoke_accum_2560", dict(grad_accum=2), 2, 2560, 373, 825,
     {1: 184, 2: 35, 4: 79, 10: 13, 60: 62}),
    ("full_width_2_layers_4096", dict(n_layers=2, dtype="float32"), 1, 4096,
     405, 98_360, {1: 193, 2: 114, 8: 13, 72: 85}),
    ("full_width_2_layers_accum", dict(n_layers=2, dtype="float32",
                                       grad_accum=2), 2, 128, 361, 86_200,
     {1: 184, 2: 48, 4: 129}),
]


@pytest.mark.parametrize("name,changes,batch,seq,n_nodes,subarrays,repeats",
                         ROWS, ids=[r[0] for r in ROWS])
def test_long_train_schedule_equals_reference(name, changes, batch, seq,
                                              n_nodes, subarrays, repeats):
    base_ref, base = ((ref_smoke_config, get_smoke_config)
                      if name.startswith("smoke")
                      else (ref_config, get_config))
    rcfg = dataclasses.replace(base_ref("llama3-8b"), **changes)
    cfg = dataclasses.replace(base("llama3-8b"), **changes)
    port = mapper.map_arch("llama3-8b", "train", batch=batch, seq_len=seq,
                           config=cfg)
    _assert_schedules_equal(port, _oracle(rcfg, batch, seq), n_nodes,
                            subarrays)
    nodes = port.graph.nodes
    assert dict(collections.Counter(nd.repeat for nd in nodes)) == repeats
    # every product lies in a folded loop; the eltwise nodes outside them
    # are the compiled step's K3 work
    assert all(nd.scanned for nd in nodes if nd.kind == "matmul")
    outside = sum(nd.kind == "eltwise" and not nd.scanned for nd in nodes)
    assert outside == (184 if cfg.grad_accum > 1 else 193)


def _prefill_oracle(rcfg, batch: int, seq: int):
    """The reference's planning of ``make_prefill_step`` (its ``map_arch``
    has no prefill kind): ``build_graph`` of the traced step, then its
    schedule on the proposed fp32 hierarchy."""
    p = ref_steps.abstract_params(rcfg)
    g = ref_graph.build_graph(
        ref_steps.make_prefill_step(rcfg), p,
        ref_steps.input_specs(rcfg, RefShapeSpec("prefill", seq, batch,
                                                 "prefill")))
    return ref_schedule.build_schedule_from_graph(
        g, hierarchy=ref_hierarchy("proposed", "fp32"))


# (seq, nodes, subarrays, nodes by repeat)
PREFILL = [(2560, 67, 95, {1: 6, 2: 38, 30: 23}),
           (2048, 47, 1047, {1: 6, 2: 41})]


@pytest.mark.parametrize("seq,n_nodes,subarrays,repeats", PREFILL,
                         ids=[str(p[0]) for p in PREFILL])
def test_prefill_schedule_equals_reference(seq, n_nodes, subarrays,
                                           repeats):
    rcfg, cfg = ref_smoke_config("llama3-8b"), get_smoke_config("llama3-8b")
    shape = steps.ShapeSpec("prefill", seq, 1, "prefill")
    port = schedule_mod.build_schedule(
        steps.make_prefill_step(cfg), steps.abstract_params(cfg),
        steps.input_specs(cfg, shape))
    _assert_schedules_equal(port, _prefill_oracle(rcfg, 1, seq), n_nodes,
                            subarrays)
    assert dict(collections.Counter(
        nd.repeat for nd in port.graph.nodes)) == repeats
    # the pair scan's nodes fold inside the layer stack's
    assert all(nd.scanned for nd in port.graph.nodes if nd.repeat > 1)


def _graph_rows(gm) -> list:
    """Each fx node's op, target, arguments (other nodes by position),
    value's shape and dtype, and regions (ids by order of first use)."""
    at: dict = {}
    ids: dict = {}
    rows = []
    for i, nd in enumerate(gm.graph.nodes):
        at[nd] = i
        val = nd.meta.get("val")
        rows.append((nd.op, str(nd.target), repr(torch.fx.node.map_arg(
            (nd.args, nd.kwargs), lambda a: ("node", at[a]))),
            tuple(getattr(val, "shape", ())), getattr(val, "dtype", None),
            tuple((kind, name, ids.setdefault(rid, len(ids)))
                  for kind, name, rid in estimator.scope_of(nd))))
    return rows


@pytest.mark.parametrize("kind", ["train_remat", "prefill"])
def test_copied_pairs_are_the_traced_graph(monkeypatch, kind):
    """A pair scan traced once and copied (``attention.COPY_TRACED_PAIRS``)
    gives the graph that tracing every pair gives, node for node: ops,
    arguments, values and regions."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), remat=True)
    shape = steps.ShapeSpec("m", 2560, 1, kind)
    p = steps.abstract_params(cfg)
    args = ((steps.make_train_step(cfg), p, steps.abstract_opt_state(cfg, p))
            if kind == "train_remat" else (steps.make_prefill_step(cfg), p))
    args += (steps.input_specs(cfg, shape),)
    copied = estimator.capture(*args).gm
    monkeypatch.setattr(attention, "COPY_TRACED_PAIRS", False)
    traced = estimator.capture(*args).gm
    assert _graph_rows(copied) == _graph_rows(traced)
    assert sum(nd.target is torch.ops.aten.bmm.default
               for nd in copied.graph.nodes) > 15 * 2
