"""llama3-8b's train step in the port against the reference's.

The slice's modules one by one, then the step, its mapping and its
compiled program:

* ``layers.fused_xent_head`` (value and both gradients, 1 and 4 chunks)
  and ``layers.rms_norm``'s VJP against the reference's custom VJPs;
  ``transformer.hidden_states`` / ``apply``,
  ``attention.full_causal_attention`` / ``attention_block`` and
  ``steps.token_xent`` against the reference's at the smoke config;
* the plain train step (``steps.make_train_step``) against the
  reference's jitted one over 3 ``TokenStream`` steps, with and without
  remat, from the reference's seeded parameters: losses within 1e-4,
  the first step's gradients within 1e-5 of each leaf's largest, and the
  parameters after 3 steps within the reference's rtol = atol = 1e-4.
  The gradients are float32 sums taken in other orders (the grouped GQA
  products, the fused head's chunks), so the two frameworks' parameters
  are not held to the last ulp, as the optimizer alone is
  (``test_torch_pim_train.py``);
* ``map_arch("llama3-8b", "train")`` node for node (kind, shape, MACs,
  edges, ``repeat``, names), placement, report and ``reconcile()``
  against the reference's mapping of the same step. The reference's own
  ``map_arch(kind="train")`` raises under jax 0.9.0: its traced step has
  top-level equations with no outputs (dead ``custom_vjp_call`` and
  ``jit`` equations) and ``graph.py:145`` reads ``eqn.outvars[0]``. The
  oracle drops those equations and hands the rest to the reference's own
  ``build_graph_from_jaxpr`` and ``build_schedule_from_graph``;
* ``compile_arch(kind="train")`` on the CPU: the program equals the
  per-block executor bit for bit and the plain step within 1e-4; K3 (its
  plain version here) is the only PIM kernel it launches;
* ``Trainer(backend="pim")`` against ``backend="jit"`` over 3 steps;
* ``checkpoint.opt_state_from_reference``: both frameworks take a step
  from the same parameters and AdamW state (float32 and int8 grids).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.data.pipeline import TokenStream as RefTokenStream
from repro.launch import steps as ref_steps
from repro.mapper import graph as ref_graph
from repro.mapper import schedule as ref_schedule
from repro.mapper.hardware import default_hierarchy as ref_hierarchy
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models.transformer import build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import mapper
from repro_torch._tree import leaves_with_path
from repro_torch.checkpoint import (opt_state_from_reference,
                                    stacked_from_reference)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.mapper import schedule as schedule_mod
from repro_torch.mapper.hardware import default_hierarchy
from repro_torch.models import attention, layers, transformer
from repro_torch.optim import make_optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig

BATCH, SEQ, STEPS = 2, 16, 3
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(remat: bool):
    return (dataclasses.replace(ref_smoke_config("llama3-8b"), remat=remat),
            dataclasses.replace(get_smoke_config("llama3-8b"), remat=remat))


def _flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def _tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_params():
    return build_model(ref_smoke_config("llama3-8b")).init(
        jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_fused_xent_head_value_and_gradients_match_reference(n_chunks):
    rng = np.random.default_rng(n_chunks)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 96)) * 0.2).astype(np.float32)
    labels = rng.integers(0, 96, (2, 16)).astype(np.int32)
    want, (wdx, wdw) = jax.value_and_grad(
        lambda a, b: ref_layers.fused_xent_head(a, b, labels, n_chunks),
        argnums=(0, 1))(x, w)
    (dx, dw), got = torch.func.grad_and_value(
        lambda a, b: layers.fused_xent_head(a, b, torch.from_numpy(labels),
                                            n_chunks),
        argnums=(0, 1))(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(wdx), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(dw.numpy(), np.asarray(wdw), rtol=1e-5,
                               atol=1e-7)


def test_rms_norm_vjp_is_the_reference_custom_vjp():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((2, 8, 64)).astype(np.float32)
    want_dx, want_ds = ref_layers._rms_bwd(1e-5, (x, scale), g)
    got_dx, got_ds = layers.rms_norm_bwd(*map(torch.from_numpy,
                                              (x, scale, g)), 1e-5)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_ds.numpy(), np.asarray(want_ds),
                               rtol=1e-6, atol=1e-6)
    # autograd through rms_norm takes that VJP
    _, vjp = torch.func.vjp(lambda a, s: layers.rms_norm(a, s, 1e-5),
                            torch.from_numpy(x), torch.from_numpy(scale))
    dx, ds = vjp(torch.from_numpy(g))
    assert torch.equal(dx, got_dx) and torch.equal(ds, got_ds)
    y = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(ref_layers.rms_norm(x, {"scale": scale})),
        rtol=1e-6, atol=1e-6)


def test_hidden_states_apply_and_token_xent_match_reference(ref_params):
    rcfg, cfg = _cfgs(False)
    model = build_model(rcfg)
    tree = stacked_from_reference(_flat_np(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    want_h = model.hidden_states(ref_params, tokens=jnp.asarray(tokens))
    want = model.apply(ref_params, tokens=jnp.asarray(tokens))
    lm = transformer.DecoderLM(cfg, device="meta")
    got_h = lm.hidden_states(tree, torch.from_numpy(tokens))
    got = lm.apply(tree, torch.from_numpy(tokens))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # full_causal_attention and attention_block's full branch
    rng = np.random.default_rng(3)
    q = rng.standard_normal((BATCH, SEQ, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((BATCH, SEQ, 2, 16)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        attention.full_causal_attention(*map(torch.from_numpy,
                                             (q, k, v))).numpy(),
        np.asarray(ref_attention.full_causal_attention(q, k, v)),
        rtol=1e-5, atol=1e-6)
    x = rng.standard_normal((BATCH, SEQ, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (BATCH, SEQ))
    attn = {k: v[0] for k, v in ref_params["layers"]["block0"][
        "attn"].items()}
    np.testing.assert_allclose(
        attention.attention_block(
            torch.from_numpy(x), {k: torch.from_numpy(np.array(v))
                                  for k, v in attn.items()}, cfg,
            torch.from_numpy(pos.copy())).numpy(),
        np.asarray(ref_attention.attention_block(x, attn, rcfg, pos,
                                                 chunked=False)),
        rtol=1e-5, atol=1e-5)
    # token_xent, one chunk and (S 4096) two chunks of 2048
    for s in (SEQ, 4096):
        rng = np.random.default_rng(s)
        lg = rng.standard_normal((1, s, 8)).astype(np.float32)
        lb = rng.integers(0, 8, (1, s)).astype(np.int32)
        np.testing.assert_allclose(
            float(steps.token_xent(torch.from_numpy(lg),
                                   torch.from_numpy(lb))),
            float(ref_steps.token_xent(lg, lb)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the plain train step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_plain_train_step_tracks_reference(ref_params, remat):
    rcfg, cfg = _cfgs(remat)
    stream = RefTokenStream(rcfg.vocab_size, SEQ, BATCH, seed=0)
    port_stream = TokenStream(cfg.vocab_size, SEQ, BATCH, seed=0)
    # the first step's gradients
    b0 = stream.batch(0)
    _, want_g = jax.value_and_grad(ref_steps.make_loss_fn(build_model(
        rcfg)))(ref_params, b0)
    params = stacked_from_reference(_flat_np(ref_params), cfg,
                                    device="cpu")
    got_g, _ = torch.func.grad_and_value(steps.make_loss_fn(cfg))(
        params, _tensors(port_stream.batch(0)))
    want_g = _flat_np(want_g)
    for key, g in leaves_with_path(got_g):
        w = want_g[key]
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), key
    # three steps
    rstep = jax.jit(ref_steps.make_train_step(rcfg))
    rp, ropt = ref_params, ref_make_optimizer("adamw", lr=3e-4).init(
        ref_params)
    opt = make_optimizer("adamw", lr=3e-4).init(params)
    step = steps.make_train_step(cfg)
    for i in range(STEPS):
        rp, ropt, want = rstep(rp, ropt, stream.batch(i))
        params, opt, got = step(params, opt, _tensors(port_stream.batch(i)))
        assert abs(float(got) - float(want)) <= 1e-4
    want_p = _flat_np(rp)
    for key, p in leaves_with_path(params):
        np.testing.assert_allclose(p.numpy(), want_p[key], err_msg=key,
                                   **TOL)
    assert int(opt["step"]) == int(ropt["step"]) == STEPS


# ---------------------------------------------------------------------------
# the mapping against the reference's
# ---------------------------------------------------------------------------


def _oracle(rcfg, batch: int, seq: int, grid: str = "fp32"):
    """The reference's schedule of ``make_train_step(rcfg)``, built as its
    ``map_arch`` builds it, less the top-level equations with no outputs
    (module docstring)."""
    p = ref_steps.abstract_params(rcfg)
    closed = jax.make_jaxpr(ref_steps.make_train_step(rcfg))(
        p, ref_steps.abstract_opt_state(rcfg, p),
        ref_steps.input_specs(rcfg, RefShapeSpec("map_train", seq, batch,
                                                 "train")))
    live = closed.jaxpr.replace(
        eqns=[e for e in closed.jaxpr.eqns if e.outvars])
    g = ref_graph.build_graph_from_jaxpr(closed.replace(jaxpr=live))
    return ref_schedule.build_schedule_from_graph(
        g, hierarchy=ref_hierarchy("proposed", grid))


def _row(nd):
    return (nd.kind, tuple(nd.out_shape), nd.macs, nd.adds, nd.muls,
            nd.weight_shape, tuple(nd.deps), nd.repeat, nd.out_elems)


def _assert_schedules_equal(port, want, n_nodes: int, subarrays: int):
    assert [_row(nd) for nd in port.graph.nodes] == [
        _row(nd) for nd in want.graph.nodes]
    assert [nd.name for nd in port.graph.nodes] == [
        nd.name.replace("dot_general", "mm") for nd in want.graph.nodes]
    assert len(port.graph.nodes) == n_nodes
    pp, rp = port.placement, want.placement
    assert pp.n_subarrays == rp.n_subarrays == subarrays
    assert {i: dataclasses.astuple(n) for i, n in
            pp.node_placements.items()} == {
        i: dataclasses.astuple(n) for i, n in rp.node_placements.items()}
    assert dataclasses.astuple(port.report) == dataclasses.astuple(
        want.report)
    got = port.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"]
    assert got == want.reconcile()


# (name, config changes, seq, nodes, subarrays, unscanned eltwise)
MAPS = [("smoke", dict(), 8, 296, 73, 193),
        ("smoke_remat", dict(remat=True), 8, 335, 85, 193),
        ("full_width_2_layers", dict(n_layers=2, dtype="float32"), 128,
         335, 86_200, 193)]


@pytest.mark.parametrize("name,changes,seq,n_nodes,subarrays,k3", MAPS,
                         ids=[m[0] for m in MAPS])
def test_train_schedule_equals_reference_node_for_node(name, changes, seq,
                                                       n_nodes, subarrays,
                                                       k3):
    base_ref, base = ((ref_smoke_config, get_smoke_config)
                      if name.startswith("smoke")
                      else (ref_config, get_config))
    rcfg = dataclasses.replace(base_ref("llama3-8b"), **changes)
    cfg = dataclasses.replace(base("llama3-8b"), **changes)
    port = mapper.map_arch("llama3-8b", "train", batch=1, seq_len=seq,
                           config=cfg)
    _assert_schedules_equal(port, _oracle(rcfg, 1, seq), n_nodes,
                            subarrays)
    # every product lies in a folded loop: the layer stack, its transpose
    # or one of the cross-entropy's two chunk loops
    nodes = port.graph.nodes
    assert all(nd.scanned for nd in nodes if nd.kind == "matmul")
    assert sum(nd.kind == "eltwise" and not nd.scanned
               for nd in nodes) == k3


@pytest.fixture(scope="module")
def full_depth_graph():
    """The published config (32 layers, bf16) at batch 1, seq 8, traced
    once on meta tensors."""
    cfg = get_config("llama3-8b")
    shape = steps.ShapeSpec("map_train", 8, 1, "train")
    p = steps.abstract_params(cfg)
    return mapper.build_graph(steps.make_train_step(cfg), p,
                              steps.abstract_opt_state(cfg, p),
                              steps.input_specs(cfg, shape))


@pytest.mark.parametrize("grid,subarrays", [("fp32", 85_660),
                                            ("int8", 84_328)])
def test_full_depth_train_schedule_equals_reference(full_depth_graph, grid,
                                                    subarrays):
    port = schedule_mod.build_schedule_from_graph(
        full_depth_graph, hierarchy=default_hierarchy("proposed", grid))
    _assert_schedules_equal(port, _oracle(ref_config("llama3-8b"), 1, 8,
                                          grid), 335, subarrays)
    assert [nd.repeat for nd in port.graph.nodes].count(32) == 129


# ---------------------------------------------------------------------------
# the compiled step, the trainer, the optimizer state
# ---------------------------------------------------------------------------


def _counting(monkeypatch, name: str) -> list:
    calls = []
    real = getattr(ref, name)
    monkeypatch.setattr(ref, name, lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_compiled_train_step_equals_executor_and_plain_step(
        ref_params, monkeypatch, remat):
    _, cfg = _cfgs(remat)
    prog = mapper.compile_arch("llama3-8b", "train", batch=BATCH,
                               seq_len=SEQ, config=cfg, device="cpu")
    params = stacked_from_reference(_flat_np(ref_params), cfg,
                                    device="cpu")
    opt = make_optimizer("adamw", lr=3e-4).init(params)
    batch = _tensors(TokenStream(cfg.vocab_size, SEQ, BATCH).batch(0))
    waves = _counting(monkeypatch, "pim_mac_wave_ref")
    products = [_counting(monkeypatch, name) for name in (
        "pim_matmul_ref", "pim_matmul_grouped_ref",
        "pim_matmul_grouped_q_ref")]
    got = prog(params, opt, batch)
    # K3 alone: 148 of the 193 eltwise nodes outside the loops (the 45
    # others are divisions and the step counter's integer add) in 84
    # waves; no product is placed outside a loop
    assert (len(waves), prog.eltwise_launches, prog.eltwise_calls,
            prog.matmul_launches) == (84, 84, 148, 0)
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    interp = ex.run(params, opt, batch)
    assert (ex.eltwise_launches, ex.matmul_launches) == (148, 0)
    assert len(waves) == 84 + 148
    assert not any(products)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(interp),
                    strict=True):
        assert torch.equal(a, b)
    want = steps.make_train_step(cfg)(params, opt, batch)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want),
                    strict=True):
        torch.testing.assert_close(a, b, **TOL)


def test_pim_trainer_matches_jit_trainer(tmp_path):
    cfg = get_smoke_config("llama3-8b")
    stream = TokenStream(cfg.vocab_size, SEQ, BATCH, seed=0)

    def init_state():
        p = transformer.DecoderLM(cfg, device="cpu").init(0).stacked_params()
        return p, make_optimizer("adamw", lr=3e-4).init(p)

    losses = {}
    for backend in ("pim", "jit"):
        tr = Trainer(TrainerConfig(total_steps=STEPS,
                                   ckpt_dir=str(tmp_path / backend)),
                     train_step=steps.make_train_step(cfg),
                     init_state=init_state, batch_fn=stream.batch,
                     backend=backend, device="cpu")
        losses[backend] = tr.run()["losses"]
        if backend == "pim":
            assert tr.pim_program.eltwise_launches == 84
    np.testing.assert_allclose(losses["pim"], losses["jit"], rtol=0,
                               atol=1e-4)
    assert len(losses["pim"]) == STEPS


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_one_step_from_the_reference_state(ref_params, state_dtype):
    rcfg, cfg = (dataclasses.replace(c, opt_state_dtype=state_dtype)
                 for c in _cfgs(False))
    stream = RefTokenStream(rcfg.vocab_size, SEQ, BATCH, seed=1)
    ropt = ref_make_optimizer("adamw", lr=3e-4,
                              state_dtype=state_dtype).init(ref_params)
    rstep = jax.jit(ref_steps.make_train_step(rcfg))
    rp, ropt, _ = rstep(ref_params, ropt, stream.batch(0))
    params = stacked_from_reference(_flat_np(rp), cfg, device="cpu")
    opt = opt_state_from_reference(_flat_np(ropt), cfg, device="cpu")
    assert pytree.tree_structure(opt) == pytree.tree_structure(
        steps.abstract_opt_state(cfg, steps.abstract_params(cfg)))
    for key, leaf in leaves_with_path(opt):
        np.testing.assert_array_equal(leaf.numpy(), _flat_np(ropt)[key])
    rp, ropt, want = rstep(rp, ropt, stream.batch(1))
    params, opt, got = steps.make_train_step(cfg)(
        params, opt, _tensors(stream.batch(1)))
    assert abs(float(got) - float(want)) <= 1e-4
    # on the int8 grid a moment whose block's absmax dwarfs it is stored
    # as 0, and an update divided by a √v̂ near 0 turns the gradients'
    # float32 rounding into large differences: there a few parameters in
    # 10^3 may leave the tolerance
    off, total = 0, 0
    for key, p in leaves_with_path(params):
        close = np.isclose(p.numpy(), _flat_np(rp)[key], **TOL)
        off, total = off + int((~close).sum()), total + close.size
        if state_dtype == "float32":
            assert close.all(), key
    assert off <= total // 1000
    bad = dict(_flat_np(ropt))
    bad.pop("step")
    with pytest.raises(ValueError, match="step"):
        opt_state_from_reference(bad, cfg, device="cpu")


def test_unported_train_options_raise():
    cfg = get_smoke_config("llama3-8b")
    # grad_accum > 1 steps (port queue item 3.8; held against the
    # reference in tests/test_torch_long_train.py)
    accum = dataclasses.replace(cfg, grad_accum=2)
    params = transformer.DecoderLM(accum, device="cpu").init(
        0).stacked_params()
    _, opt, loss = steps.make_train_step(accum)(
        params, make_optimizer("adamw", lr=3e-4).init(params),
        _tensors(TokenStream(cfg.vocab_size, 8, 2).batch(0)))
    assert torch.isfinite(loss) and int(opt["step"]) == 1
    # the recurrent block patterns train since item 5.4b (the MoE configs
    # since 5.3b; tests/test_torch_recurrent_train*.py, _moe_train*.py)
    xl = dataclasses.replace(cfg, block_pattern="xlstm")
    tree = transformer.DecoderLM(xl, device="cpu").init(0).stacked_params()
    _, opt, loss = steps.make_train_step(xl)(
        tree, make_optimizer("adamw", lr=3e-4).init(tree),
        _tensors(TokenStream(cfg.vocab_size, 8, 2).batch(0)))
    assert torch.isfinite(loss) and int(opt["step"]) == 1
    # a sequence above 2048 maps (item 3.7): the chunked attention's pair
    # scan folds inside the stack and its transpose
    sched = mapper.map_arch("llama3-8b", "train", smoke=True, seq_len=4096)
    assert len(sched.graph.nodes) == 347
    assert max(nd.repeat for nd in sched.graph.nodes) == 72
