"""The port's PIM-mapped LeNet-5 serve path end to end, on the CPU.

The reference's parameters (``init_lenet`` at PRNGKey 0, with seeded
non-zero biases in place of its zeros, so that the bias adds the mapper
lowers to K3 carry values) cross over through the bridge; images come
from the port's digits pipeline. The
reference's own lowering cannot be the oracle here (it calls
``jax.util.safe_map``, which this environment's jax lacks), so:

* ``compile_lenet("serve", device="cpu")`` is held to
  ``jax.jit(lenet_apply)`` within rtol = atol = 1e-4, the reference's
  ``verify`` tolerance;
* the compiled program equals the per-block executor bit for bit;
* the launch counts equal ``BENCH_fusion.json``'s ``lenet5_forward``
  (grouped: 5 matmul launches of 10; per-block: 7 of 12; 7 placed blocks)
  and the reference schedule's block count.

On the CPU the wrappers run their plain versions, so these are the
plain kernels' numbers; ``chip_smoke.py`` runs the same path on the card.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import mapper as ref_mapper
from repro.configs.lenet5 import CONFIG as REF_CONFIG
from repro.data.pipeline import make_digits as ref_make_digits
from repro.models import lenet as ref_lenet
from repro_torch import mapper, obs
from repro_torch.checkpoint import lenet_params_from_reference
from repro_torch.configs import LENET5, get_smoke_config
from repro_torch.data import make_digits
from repro_torch.models import lenet

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ref_params():
    params = jax.tree.map(np.asarray, ref_lenet.init_lenet(
        jax.random.PRNGKey(0), REF_CONFIG))
    rng = np.random.default_rng(11)
    for leaves in params.values():
        leaves["b"] = rng.standard_normal(leaves["b"].shape).astype(
            np.float32)
    return params


@pytest.fixture(scope="module")
def params(ref_params):
    return lenet_params_from_reference(ref_params, device="cpu")


def test_bridge_and_pipeline_carry_the_reference_bit_for_bit(ref_params,
                                                             params):
    for layer, leaves in ref_params.items():
        for name, arr in leaves.items():
            assert np.array_equal(params[layer][name].numpy(), arr)
    assert lenet.n_params(params) == ref_lenet.n_params(ref_params) == 21655
    imgs, labels = make_digits(16, seed=3)
    want_imgs, want_labels = ref_make_digits(16, seed=3)
    assert np.array_equal(imgs, want_imgs)
    assert np.array_equal(labels, want_labels)
    bad = dict(ref_params, fc3={"w": ref_params["fc3"]["w"][:, :4],
                                "b": ref_params["fc3"]["b"]})
    with pytest.raises(ValueError, match="fc3"):
        lenet_params_from_reference(bad, device="cpu")


@pytest.mark.parametrize("batch", [4, 256])
def test_plain_lenet_apply_matches_reference(ref_params, params, batch):
    imgs, _ = make_digits(batch, seed=batch)
    want = np.asarray(jax.jit(ref_lenet.lenet_apply)(ref_params, imgs))
    got = lenet.lenet_apply(params, torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("batch", [4, 256])
def test_compiled_lenet_matches_jit_and_executor(ref_params, params, batch):
    imgs, _ = make_digits(batch, seed=batch + 1)
    x = torch.from_numpy(imgs)
    prog = mapper.compile_lenet("serve", batch=batch, device="cpu")
    got = prog(params, x)
    assert got.shape == (batch, LENET5.n_classes)
    assert bool(torch.isfinite(got).all())
    want = np.asarray(jax.jit(ref_lenet.lenet_apply)(ref_params, imgs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    assert torch.equal(ex.run(params, x), got)
    assert prog.verify(params, x) <= 1e-4


def test_launch_counts_equal_the_reference_record(params):
    bench = json.loads((ROOT / "BENCH_fusion.json").read_text())[
        "lenet5_forward"]
    x = torch.from_numpy(make_digits(4, seed=0)[0])
    prog = mapper.compile_lenet("serve", batch=4, device="cpu")
    for _ in range(2):                     # the counters are per call
        prog(params, x)
        assert prog.matmul_launches == bench["grouped_matmul_launches"] == 5
        assert prog.kernel_launches == bench["grouped_total_launches"] == 10
        assert prog.eltwise_launches == 5 and prog.eltwise_calls == 5
        assert prog.placed_blocks == bench["placed_blocks"] == 7
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    ex.run(params, x)
    assert ex.matmul_launches == bench["per_block_matmul_launches"] == 7
    assert ex.kernel_launches == bench["per_block_total_launches"] == 12
    assert ex.placed_blocks == 7
    ref = ref_mapper.map_lenet("serve", batch=4)
    assert ex.placed_blocks == sum(
        np_.blocks_per_replica
        for np_ in ref.placement.node_placements.values())
    ex.run(params, x)                      # the executor's add up
    assert ex.kernel_launches == 24


def test_second_compile_hits_the_program_cache():
    mapper.clear_program_cache()
    sched = mapper.map_lenet("serve", batch=4)
    a = mapper.compile_schedule(sched, device="cpu")
    b = mapper.compile_schedule(sched, device="cpu")
    assert a is b
    assert mapper.program_cache_stats() == {"hits": 1, "misses": 1,
                                            "size": 1}
    # a schedule of the same fn and shapes on the same placement hits too
    again = mapper.compile_schedule(mapper.map_lenet("serve", batch=4),
                                    device="cpu")
    assert again is a
    # another machine (its placement signature) or other shapes do not
    assert mapper.compile_schedule(
        mapper.map_lenet("serve", batch=4, tech="ultrafast"),
        device="cpu") is not a
    assert mapper.compile_lenet("serve", batch=8, device="cpu") is not a
    assert mapper.program_cache_stats()["misses"] == 3


def test_unported_options_raise_not_implemented():
    # partitions and scan expansion map (tests/test_torch_partition.py)
    assert len(mapper.map_lenet("serve", partitions=2).partitions) == 2
    assert mapper.map_lenet("serve", expand_scans=True).graph.groups == {}
    # the train step maps with grad_accum > 1 and above seq 2048
    # (tests/test_torch_long_train.py holds both against the reference);
    # what it leaves out raises
    prog = mapper.compile_arch("llama3-8b", config=dataclasses.replace(
        get_smoke_config("llama3-8b"), grad_accum=2), batch=1, seq_len=8,
        device="cpu")
    assert sum(nd.kind == "eltwise" and not nd.scanned
               for nd in prog.schedule.graph.nodes) == 184
    # MoE blocks map since item 5.3b (tests/test_torch_moe_train*.py), the
    # recurrent block patterns since item 5.4b (test_torch_recurrent_train*)
    moe_sched = mapper.map_arch("llama3-8b", config=dataclasses.replace(
        get_smoke_config("llama3-8b"), n_experts=4, top_k=2, moe_d_ff=32),
        batch=1, seq_len=8)
    assert any(nd.kind == "matmul" and nd.out_shape[0] == 4
               for nd in moe_sched.graph.nodes)     # the experts' products
    rec = mapper.compile_arch("llama3-8b", config=dataclasses.replace(
        get_smoke_config("llama3-8b"), block_pattern="xlstm"), device="cpu")
    assert all(nd.scanned for nd in rec.schedule.graph.nodes
               if nd.kind == "matmul")
    with pytest.raises(ValueError, match="kind"):
        mapper.map_lenet("decode")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           ref_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = mapper.map_lenet("serve", batch=4)     # planning needs no device
    for call in (lambda: mapper.compile_lenet("serve"),
                 lambda: mapper.compile_schedule(sched),
                 lambda: mapper.ScheduleExecutor(sched),
                 lambda: mapper.run_schedule(sched),
                 lambda: lenet.init_lenet(0),
                 lambda: lenet_params_from_reference(ref_params)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_program_checks_its_arguments(params):
    prog = mapper.compile_lenet("serve", batch=4, device="cpu")
    x = torch.from_numpy(make_digits(4, seed=0)[0])
    with pytest.raises(TypeError, match="structure"):
        prog(params, x, x)
    with pytest.raises(ValueError, match="runs on cpu"):
        prog(params, x.to("meta"))


def _plan_and_compare(fn, args, rtol=1e-5, atol=1e-5):
    """Schedule ``fn`` on meta stand-ins; run it compiled and per-block
    on ``args``; hold both against ``fn`` and each other."""
    sched = mapper.build_schedule(fn, *mapper.abstract_like(args))
    prog = mapper.compile_schedule(sched, device="cpu", use_cache=False)
    ex = mapper.ScheduleExecutor(sched, device="cpu")
    got, oracle = prog(*args), ex.run(*args)
    for g, o, w in zip(torch.utils._pytree.tree_leaves(got),
                       torch.utils._pytree.tree_leaves(oracle),
                       torch.utils._pytree.tree_leaves(fn(*args))):
        assert torch.equal(g, o)
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
    return prog, ex


def test_fusion_coalesces_independent_nodes():
    rng = np.random.default_rng(7)
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in (("w1", (24, 40)), ("w2", (24, 40)), ("b1", (40,)),
                      ("b2", (40,)), ("c", (6, 40)))}
    x = torch.from_numpy(rng.standard_normal((6, 24)).astype(np.float32))

    def two_heads(p, x):
        y1 = x @ p["w1"] + p["b1"]
        y2 = x @ p["w2"] - p["b2"]
        return {"y1": y1, "y2": y2 * p["c"]}

    prog, ex = _plan_and_compare(two_heads, (p, x))
    # both projections ride one grouped launch (2 blocks each: 40 > 32
    # columns); the add and the sub ride one K3 wave; the mul waits for
    # the sub
    assert (prog.matmul_launches, prog.eltwise_launches) == (1, 2)
    assert prog.placed_blocks == 4 and prog.eltwise_calls == 3
    assert (ex.matmul_launches, ex.eltwise_launches) == (4, 3)


def test_row_blocks_fold_in_order_and_conv_padding_stride():
    rng = np.random.default_rng(8)
    # k = 2000 > 921 weight rows: three row blocks, folded in order
    w = torch.from_numpy(rng.standard_normal((2000, 40)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 2000)).astype(np.float32))
    prog, ex = _plan_and_compare(lambda w, x: x @ w, (w, x), rtol=1e-4,
                                 atol=1e-4)
    np_ = prog.schedule.placement.node_placements[0]
    assert (np_.row_blocks, np_.col_blocks) == (3, 2)
    assert prog.matmul_launches == 1 and ex.matmul_launches == 6
    # a strided, padded NCHW convolution through im2col
    k = torch.from_numpy(rng.standard_normal((8, 3, 3, 3)).astype(np.float32))
    img = torch.from_numpy(rng.standard_normal((2, 3, 11, 9)).astype(
        np.float32))
    prog, _ = _plan_and_compare(
        lambda k, img: F.conv2d(img, k, stride=2, padding=1), (k, img))
    assert prog.matmul_launches == 1 and prog.eltwise_launches == 0


def test_spans_and_launch_counter(params):
    x = torch.from_numpy(make_digits(4, seed=0)[0])
    prog = mapper.compile_lenet("serve", batch=4, device="cpu")
    counter = obs.metrics().counter("pim.kernel_launches")
    before = counter.value
    with obs.scoped() as tr:
        prog(params, x)
        mapper.ScheduleExecutor(prog.schedule, device="cpu").run(params, x)
    assert len(tr.spans(name="program:call")) == 1
    assert len(tr.spans(name="run:schedule")) == 1
    node_spans = [e for e in tr.events if e.lane == "execute"
                  and e.name.split(":")[0] in ("matmul", "conv", "eltwise")]
    # one span per lowered node in each run: 5 placed nodes + 5 adds
    assert len(node_spans) == 20
    assert counter.value - before == 10 + 12
    obs.validate_chrome_trace(tr.to_chrome())
