"""Partitioned programs and the GPipe drivers of the port on the CPU.

``compile_partitioned`` lowers each pipeline partition into a stage
program over the values crossing its boundaries; run in order, the
stages equal the unpartitioned ``CompiledProgram`` bit for bit (the same
kernels on the same blocks in the same order — on the CPU their plain
versions) and the per-block executor. Held against the reference:
LeNet-5's partitioned forward against ``jax.jit(lenet_apply)``, the
per-stage GPipe backward against ``jax.value_and_grad(lenet_loss)`` and
``Trainer(backend="pim", microbatches=8, partitions=2)`` against the
reference's ``Trainer(backend="jit")``, within rtol 1e-4, atol 1e-5.
The reference's own partitioned programs cannot run under jax 0.9.0
(``jax.util``), so its jit paths are the oracles. On the CPU there are
no streams: the asynchronous driver is the synchronous one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs.lenet5 import CONFIG as REF_CONFIG
from repro.data import DigitsDataset as RefDigits
from repro.models import lenet as ref_lenet
from repro.optim import make_optimizer as ref_make_optimizer
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch import mapper, obs
from repro_torch.checkpoint import lenet_params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.data import DigitsDataset
from repro_torch.models import lenet
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import make_optimizer
from repro_torch.parallel import pipeline as pipe
from repro_torch.train import Trainer, TrainerConfig

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, ref_lenet.init_lenet(
        jax.random.PRNGKey(0), REF_CONFIG))


@pytest.fixture(scope="module")
def params(ref_params):
    return lenet_params_from_reference(ref_params, device="cpu")


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 28, 28, 1)).astype(np.float32)


def _equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("k", (2, 3))
def test_partitioned_lenet_equals_unpartitioned_and_jit(params, ref_params,
                                                        k):
    imgs = _images(4, 1)
    x = torch.from_numpy(imgs)
    prog = mapper.compile_lenet("serve", batch=4, partitions=k,
                                device="cpu")
    base = mapper.compile_lenet("serve", batch=4, device="cpu")
    assert isinstance(prog, mapper.PartitionedProgram)
    assert prog.n_partitions == k and prog.stage_trace_count == k
    got = prog(params, x)
    assert torch.equal(got, base(params, x))
    assert torch.equal(got, mapper.ScheduleExecutor(
        prog.schedule, device="cpu").run(params, x))
    want = jax.jit(ref_lenet.lenet_apply)(ref_params, imgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert prog.verify(params, x) < 1e-4
    # the stages' launches add up to the unpartitioned program's
    assert [sum(st.matmul_launches for st in prog.stages),
            sum(st.eltwise_launches for st in prog.stages)] == [
        base.matmul_launches, base.eltwise_launches] == [5, 5]
    assert prog.kernel_launches == base.kernel_launches
    assert prog.placed_blocks == base.placed_blocks
    # explicit transfer points: stage 1 consumes stage 0's boundary
    assert ("stage", 0, 0) in prog.stages[1].in_refs
    assert prog.stages[0].out_bits == 8 * 4 * 12 * 12 * 6 * 4
    assert prog.out_refs == (("stage", k - 1, 0),)
    assert prog.streams == (None,) * k


def test_gpipe_forward_and_async_equal_sequential(params):
    prog = mapper.compile_lenet("serve", batch=4, partitions=3,
                                device="cpu")
    mbs = [torch.from_numpy(_images(4, m)) for m in range(5)]
    flat = [prog.flatten_args(params, x) for x in mbs]
    outs = pipe.run_partitioned(prog.stages, prog.out_refs, flat)
    asy = pipe.run_partitioned_async(prog.stages, prog.out_refs, flat)
    for x, o, a in zip(mbs, outs, asy):
        assert torch.equal(o[0], prog(params, x))
        assert torch.equal(a[0], o[0])
    assert _equal(prog.run_async(params, mbs[0]), prog(params, mbs[0]))
    assert list(pipe.gpipe_grid(3, 2)) == [
        (0, 0, 0), (1, 0, 1), (1, 1, 0), (2, 1, 1), (2, 2, 0), (3, 2, 1)]
    assert [pipe.tick_phase(t, 3, 5) for t in range(7)] == [
        "fill", "fill", "steady", "steady", "steady", "drain", "drain"]


def test_gpipe_spans_on_the_pipeline_lane(params):
    prog = mapper.compile_lenet("serve", batch=4, partitions=2,
                                device="cpu")
    flat = [prog.flatten_args(params, torch.from_numpy(_images(4, m)))
            for m in range(3)]
    with obs.scoped() as tr:
        pipe.run_partitioned(prog.stages, prog.out_refs, flat)
    spans = tr.spans(lane="pipeline")
    assert [(e.args["tick"], e.args["stage"], e.args["micro"])
            for e in spans] == list(pipe.gpipe_grid(2, 3))
    assert {e.name for e in spans} == {"fill:tick", "steady:tick",
                                       "drain:tick"}


def _loss_program(k, mb):
    meta = dict(device="meta")
    sched = mapper.build_schedule(
        lenet.lenet_loss, mapper.abstract_like(
            lenet.init_lenet(0, device="meta")),
        torch.empty((mb, 28, 28, 1), **meta),
        torch.empty((mb,), dtype=torch.int32, **meta), partitions=k)
    return mapper.compile_partitioned(sched, use_cache=False, device="cpu")


def test_gpipe_value_and_grad_matches_full_batch(params, ref_params):
    """Per-stage autograd GPipe backward (batch 8, M 4, K 2) against the
    reference's ``jax.value_and_grad`` and plain autograd."""
    imgs = _images(8, 3)
    labels = np.array([1, 7, 3, 9, 0, 2, 5, 8], np.int32)
    n_micro, mb = 4, 2
    prog = _loss_program(2, mb)
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    flat = [prog.flatten_args(params, x[m * mb:(m + 1) * mb],
                              y[m * mb:(m + 1) * mb])
            for m in range(n_micro)]
    leaves, spec = pytree.tree_flatten(params)
    stats = {}
    with obs.scoped() as tr:
        loss, gflat = pipe.gpipe_value_and_grad(
            prog.stages, prog.out_refs[0], flat, list(range(len(leaves))),
            stats=stats)
    want_loss, want_grads = jax.value_and_grad(ref_lenet.lenet_loss)(
        ref_params, imgs, labels)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-6)
    grads = pytree.tree_unflatten(gflat, spec)
    for k in grads:
        for j in grads[k]:
            np.testing.assert_allclose(grads[k][j].numpy(),
                                       np.asarray(want_grads[k][j]),
                                       **LOSS_TOL)
    plain = torch.func.grad(lenet.lenet_loss)(params, x, y)
    for a, b in zip(gflat, pytree.tree_leaves(plain)):
        torch.testing.assert_close(a, b, **LOSS_TOL)
    # one forward and one backward span a cell, reversed for the backward
    grid = list(pipe.gpipe_grid(2, n_micro))
    fwd = [(e.args["tick"], e.args["stage"], e.args["micro"])
           for e in tr.spans(lane="pipeline") if e.name.endswith(":fwd")]
    bwd = [(e.args["tick"], e.args["stage"], e.args["micro"])
           for e in tr.spans(lane="pipeline") if e.name.endswith(":bwd")]
    assert fwd == grid and bwd == grid[::-1]
    # the per-stage launch tally (the CPU's plain versions count none)
    assert set(stats) == {"fwd", "bwd"} and set(stats["fwd"]) == {0, 1}
    with pytest.raises(ValueError, match="loss"):
        pipe.gpipe_value_and_grad(prog.stages, ("arg", 0), flat, [0])


def test_labels_get_no_cotangent(params):
    """The labels (int) take no cotangent (the reference's ``float0``):
    asked for, they get zeros; the images, asked for, get plain
    autograd's."""
    prog = _loss_program(2, 2)
    x = torch.from_numpy(_images(2, 5))
    y = torch.tensor([3, 4], dtype=torch.int32)
    flat = [prog.flatten_args(params, x, y)]
    n = len(pytree.tree_leaves(params))
    _, grads = pipe.gpipe_value_and_grad(prog.stages, prog.out_refs[0],
                                         flat, [n, n + 1, 0])
    torch.testing.assert_close(grads[0], torch.func.grad(
        lenet.lenet_loss, argnums=1)(params, x, y), **LOSS_TOL)
    assert torch.equal(grads[1], torch.zeros_like(y))
    assert grads[2].abs().sum() > 0


@pytest.fixture(scope="module")
def ref_losses(tmp_path_factory):
    """The reference's ``Trainer(backend="jit")``: 6 AdamW steps at
    batch 32."""
    opt = ref_make_optimizer("adamw", lr=2e-3)
    ds = RefDigits(batch_size=32, seed=0)

    def init_state():
        p = ref_lenet.init_lenet(jax.random.PRNGKey(0), REF_CONFIG)
        return p, opt.init(p)

    def train_step(params, opt_state, batch):
        imgs, labels = batch
        loss, grads = jax.value_and_grad(ref_lenet.lenet_loss)(
            params, jnp.asarray(imgs), jnp.asarray(labels))
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    tc = RefTrainerConfig(total_steps=6, ckpt_every=50,
                          ckpt_dir=str(tmp_path_factory.mktemp("ref")),
                          async_ckpt=False)
    return RefTrainer(tc, train_step=train_step, init_state=init_state,
                      batch_fn=ds.batch, backend="jit").run()["losses"]


def _trainer(ref_params, tmp_path, backend, **kw):
    opt = make_optimizer("adamw", lr=2e-3)

    def init_state():
        p = lenet_params_from_reference(ref_params, device="cpu")
        return p, opt.init(p)

    def train_step(params, opt_state, batch):
        grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
            params, *batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    tc = TrainerConfig(total_steps=6, ckpt_every=50,
                       ckpt_dir=str(tmp_path / backend), async_ckpt=False)
    return Trainer(tc, train_step=train_step, init_state=init_state,
                   batch_fn=DigitsDataset(batch_size=32, seed=0).batch,
                   backend=backend, device="cpu", loss_fn=lenet.lenet_loss,
                   optimizer=opt, **kw)


def test_trainer_microbatch_pipeline_matches_reference(ref_params,
                                                       ref_losses,
                                                       tmp_path):
    tr = _trainer(ref_params, tmp_path, "pim", microbatches=8,
                  partitions=2)
    prog = tr.pim_program
    assert isinstance(prog, mapper.PartitionedProgram)
    assert prog.n_partitions == 2 and prog.stage_trace_count == 2
    res = tr.run()
    np.testing.assert_allclose(res["losses"], ref_losses, **LOSS_TOL)
    # stages are planned once: no rebuild over 6 steps
    assert prog.stage_trace_count == 2
    assert set(tr.pipeline_stats) == {"fwd", "bwd"}
    jit = _trainer(ref_params, tmp_path, "jit").run()["losses"]
    np.testing.assert_allclose(res["losses"], jit, **LOSS_TOL)


def test_trainer_knobs_validated(ref_params, tmp_path):
    with pytest.raises(ValueError, match="backend='pim'"):
        _trainer(ref_params, tmp_path, "jit", microbatches=4)
    tc = TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path / "v"))
    with pytest.raises(ValueError, match="loss_fn and optimizer"):
        Trainer(tc, train_step=lambda *a: a,
                init_state=lambda: (lenet.init_lenet(0, device="cpu"), {}),
                batch_fn=DigitsDataset(batch_size=8, seed=0).batch,
                backend="pim", partitions=2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        _trainer(ref_params, tmp_path, "pim", microbatches=5)
    with pytest.raises(ValueError, match="pim_compile"):
        _trainer(ref_params, tmp_path, "jit",
                 pim_compile={"streams": [object()]})


def test_trainer_pim_compile_reaches_the_stage_compiler(ref_params,
                                                        tmp_path):
    """``pim_compile`` goes to ``compile_partitioned`` as the reference's
    goes to its compiler: a ring of streams on the CPU is refused there."""
    with pytest.raises(ValueError, match="CUDA"):
        _trainer(ref_params, tmp_path, "pim", microbatches=2, partitions=2,
                 pim_compile={"streams": [object()]})
    tr = _trainer(ref_params, tmp_path, "pim", microbatches=2, partitions=2,
                  pim_compile={})
    assert tr.pim_program.streams == (None, None)


def test_compile_partitioned_needs_partitions_and_caches(params):
    sched = mapper.map_lenet("serve", batch=4)
    with pytest.raises(ValueError, match="no pipeline partitions"):
        mapper.compile_partitioned(sched, device="cpu")
    mapper.clear_program_cache()
    a = mapper.compile_partitioned(sched, partitions=2, device="cpu")
    assert mapper.compile_partitioned(sched, partitions=2,
                                      device="cpu") is a
    b = mapper.compile_partitioned(sched, partitions=3, device="cpu")
    assert b is not a and b.n_partitions == 3
    assert mapper.program_cache_stats()["hits"] == 1
    with pytest.raises(ValueError, match="CUDA"):
        mapper.compile_partitioned(sched, partitions=2, device="cpu",
                                   streams=[object()])
    mapper.clear_program_cache()


@pytest.fixture(scope="module")
def llama():
    cfg = get_smoke_config("llama3-8b")
    model = DecoderLM(cfg, device="cpu").init(0)
    return model, model.stacked_params()


def test_partitioned_llama_decode_with_expansion(llama):
    """The smoke decode step cut into 4 stages inside its expanded stack:
    bit for bit the unpartitioned program of the same schedule and the
    per-block executor, the GPipe grid bit for bit its sequential calls,
    and within 1e-5 of the plain step."""
    model, params = llama
    b, s = 2, 32
    prog = mapper.compile_arch("llama3-8b", "serve", smoke=True, batch=b,
                               seq_len=s, partitions=4, expand_scans=True,
                               device="cpu")
    sched = prog.schedule
    assert sched.graph.groups == {"layers": 1}
    assert [len(p.nodes) for p in prog.partitions] == [39, 36, 11, 5]
    base = mapper.compile_schedule(sched, use_cache=False, device="cpu")
    gen = torch.Generator().manual_seed(0)
    caches = []
    for _ in range(3):
        c = model.init_cache(b, s)
        for t in c["layers"]["block0"].values():
            t.normal_(generator=gen)
        caches.append(c)
    toks = [torch.randint(0, 256, (b,), generator=gen, dtype=torch.int32)
            for _ in range(3)]
    pos = torch.tensor(5, dtype=torch.int32)
    with torch.no_grad():
        got = prog(params, caches[0], toks[0], pos)
        assert _equal(got, base(params, caches[0], toks[0], pos))
        assert _equal(got, mapper.ScheduleExecutor(sched, device="cpu").run(
            params, caches[0], toks[0], pos))
        plain = model.decode_step(params, caches[0], toks[0], pos)
        for a, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(plain)):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
        # the layers' products run on the kernels inside the stages
        assert prog.matmul_launches == base.matmul_launches == 15
        assert [st.matmul_launches for st in prog.stages] == [5, 5, 4, 1]
        flat = [prog.flatten_args(params, c, t, pos)
                for c, t in zip(caches, toks)]
        outs = pipe.run_partitioned(prog.stages, prog.out_refs, flat)
        for c, t, o in zip(caches, toks, outs):
            assert _equal(o, pytree.tree_leaves(base(params, c, t, pos)))


def test_partitioned_decode_without_expansion_keeps_the_stack_whole(llama):
    _, params = llama
    prog = mapper.compile_arch("llama3-8b", "serve", smoke=True, batch=2,
                               seq_len=32, partitions=4, device="cpu")
    assert [len(p.nodes) for p in prog.partitions] == [0, 0, 43, 5]
    cache = DecoderLM(get_smoke_config("llama3-8b"),
                      device="cpu").init_cache(2, 32)
    tok = torch.tensor([1, 2], dtype=torch.int32)
    pos = torch.tensor(0, dtype=torch.int32)
    with torch.no_grad():
        got = prog(params, cache, tok, pos)
        want = mapper.compile_schedule(prog.schedule, use_cache=False,
                                       device="cpu")(params, cache, tok,
                                                     pos)
    assert _equal(got, want)
    assert prog.matmul_launches == 1
