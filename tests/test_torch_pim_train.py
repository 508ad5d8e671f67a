"""The port's LeNet-5 training slice on the CPU, against the reference.

The reference's ``init_lenet`` parameters cross over through the bridge,
batches come from the same ``DigitsDataset(seed=0)``, and AdamW starts at
zeros on both sides. The reference's lowering cannot run here (its
``jax.util`` call), so its ``Trainer(backend="jit")`` is the oracle:

* the port's ``Trainer(backend="pim", device="cpu")`` — the whole AdamW
  step mapped, compiled once and run through the plain kernels — and its
  ``backend="jit"`` (the plain eager step) track the reference's losses
  over 10 steps at batch 32 within rtol 1e-4, atol 1e-5, the reference's
  own pim-vs-jit tolerance (``tests/test_compile.py``);
* the compiled train step equals the per-block executor bit for bit;
* auto-resume after an injected failure is bit-identical to the
  uninterrupted run;
* checkpoints written by either package's ``CheckpointManager`` restore
  in the other, bit for bit;
* one optimizer step per ``state_dtype`` equals the reference's update;
* autograd through a compiled ``lenet_loss`` program matches plain
  autograd and ``jax.grad`` within rtol = atol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs.lenet5 import CONFIG as REF_CONFIG
from repro.data import DigitsDataset as RefDigits
from repro.models import lenet as ref_lenet
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import optimizers as ref_optimizers
from repro.optim import schedule as ref_schedule
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch import mapper, obs
from repro_torch.checkpoint import (CheckpointManager,
                                    lenet_params_from_reference)
from repro_torch.data import DigitsDataset
from repro_torch.kernels import ref as kernel_ref
from repro_torch.mapper import lowering
from repro_torch.models import lenet
from repro_torch.optim import make_optimizer
from repro_torch.optim import optimizers
from repro_torch.optim import schedule
from repro_torch.train import Trainer, TrainerConfig

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 32
STEPS = 10


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, ref_lenet.init_lenet(
        jax.random.PRNGKey(0), REF_CONFIG))


@pytest.fixture(scope="module")
def ref_losses(tmp_path_factory):
    """The reference's ``Trainer(backend="jit")``: 10 AdamW steps."""
    opt = ref_make_optimizer("adamw", lr=2e-3)
    ds = RefDigits(batch_size=BATCH, seed=0)

    def init_state():
        p = ref_lenet.init_lenet(jax.random.PRNGKey(0), REF_CONFIG)
        return p, opt.init(p)

    def train_step(params, opt_state, batch):
        imgs, labels = batch
        loss, grads = jax.value_and_grad(ref_lenet.lenet_loss)(
            params, jnp.asarray(imgs), jnp.asarray(labels))
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    tc = RefTrainerConfig(total_steps=STEPS, ckpt_every=50,
                          ckpt_dir=str(tmp_path_factory.mktemp("ref")),
                          async_ckpt=False)
    return RefTrainer(tc, train_step=train_step, init_state=init_state,
                      batch_fn=ds.batch, backend="jit").run()["losses"]


def _train_step(opt):
    def train_step(params, opt_state, batch):
        imgs, labels = batch
        grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
            params, imgs, labels)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss
    return train_step


def _trainer(ref_params, ckpt_dir, backend, *, batch=BATCH, total=STEPS,
             ckpt_every=50, fail_at=None, **kw):
    opt = make_optimizer("adamw", lr=2e-3)

    def init_state():
        p = lenet_params_from_reference(ref_params, device="cpu")
        return p, opt.init(p)

    tc = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                       ckpt_dir=str(ckpt_dir), async_ckpt=False,
                       fail_at_step=fail_at)
    return Trainer(tc, train_step=_train_step(opt), init_state=init_state,
                   batch_fn=DigitsDataset(batch_size=batch, seed=0).batch,
                   backend=backend, device="cpu", **kw)


def test_pim_trainer_tracks_reference_losses_and_compiles_once(
        ref_params, ref_losses, tmp_path, monkeypatch):
    plans = []
    real_plan = lowering.plan
    monkeypatch.setattr(lowering, "plan",
                        lambda ctx: plans.append(1) or real_plan(ctx))
    tr = _trainer(ref_params, tmp_path, "pim")
    res = tr.run()
    np.testing.assert_allclose(res["losses"], ref_losses, **LOSS_TOL)
    # the program is built once and replayed for every step (the
    # reference's trace_count == 1)
    assert len(plans) == 1
    prog = tr.pim_program
    assert prog.placed_blocks > 0
    # 2 forward convolutions + 9 products through K1; the 3 backward
    # convolutions are native (the reference's fallback)
    assert prog.matmul_launches == 11
    assert len(prog.schedule.graph.nodes) == 180
    assert res["losses"][0] > res["losses"][-1]          # it learns


def test_jit_trainer_tracks_reference_losses(ref_params, ref_losses,
                                             tmp_path):
    tr = _trainer(ref_params, tmp_path, "jit")
    assert tr.pim_program is None
    res = tr.run()
    np.testing.assert_allclose(res["losses"], ref_losses, **LOSS_TOL)


def _leaves(tree):
    return [x for _, x in sorted(_flat(tree).items())]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _np(x) -> np.ndarray:
    """A leaf of either package as numpy, bfloat16 widened exactly."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _bit_equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        _np(fa[k]).dtype == _np(fb[k]).dtype
        and np.array_equal(_np(fa[k]), _np(fb[k])) for k in fa)


def test_compiled_train_step_equals_executor_bit_for_bit(ref_params,
                                                         tmp_path):
    tr = _trainer(ref_params, tmp_path, "pim", batch=8)
    prog = tr.pim_program
    batch = tr._batch(3)
    got = prog(tr.params, tr.opt_state, batch)
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    want = ex.run(tr.params, tr.opt_state, batch)
    assert _bit_equal(got, want)
    # the oracle runs one K2 launch per placed block, the program one
    # grouped K1 launch per placed product
    assert ex.matmul_launches > prog.matmul_launches == 11
    # and both are the plain step within the reference's tolerance
    plain = tr._step_fn.schedule.graph.fn(tr.params, tr.opt_state, batch)
    for g, w in zip(_leaves(got), _leaves(plain), strict=True):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["pim", "jit"])
def test_auto_resume_after_failure_is_bit_identical(ref_params, tmp_path,
                                                    backend):
    straight = _trainer(ref_params, tmp_path / "s", backend, batch=8,
                        total=8, ckpt_every=3)
    res_straight = straight.run()
    crashed = _trainer(ref_params, tmp_path / "c", backend, batch=8,
                       total=8, ckpt_every=3, fail_at=5)
    with pytest.raises(RuntimeError, match="injected"):
        crashed.run()
    resumed = _trainer(ref_params, tmp_path / "c", backend, batch=8,
                       total=8, ckpt_every=3)
    assert resumed.resumed and resumed.start_step == 4
    res = resumed.run()
    assert res["losses"] == res_straight["losses"][4:]
    assert _bit_equal(resumed.params, straight.params)
    assert _bit_equal(resumed.opt_state, straight.opt_state)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_checkpoints_cross_both_ways_bit_for_bit(ref_params, tmp_path,
                                                 state_dtype):
    rng = np.random.default_rng(5)
    ref_opt = ref_make_optimizer("adamw", lr=2e-3, state_dtype=state_dtype)
    ref_tree = {"params": ref_params, "opt": ref_opt.init(ref_params)}
    ref_tree = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape).astype(x.dtype)
                   if x.dtype in (np.float32, jnp.bfloat16)
                   else np.asarray(x) + 3), ref_tree)
    opt = make_optimizer("adamw", lr=2e-3, state_dtype=state_dtype)
    params = lenet_params_from_reference(ref_params, device="cpu")
    like = {"params": params, "opt": opt.init(params)}

    RefCheckpointManager(tmp_path / "r", async_save=False).save(7, ref_tree)
    got, step = CheckpointManager(tmp_path / "r").restore(like)
    assert step == 7 and _bit_equal(got, ref_tree)

    mgr = CheckpointManager(tmp_path / "p", keep=2)
    for s in (1, 2, 3):
        mgr.save(s, got)                 # async; keep the last two
    mgr.wait()
    back, step = RefCheckpointManager(tmp_path / "p").restore(ref_tree)
    assert step == 3 and _bit_equal(back, ref_tree)
    assert sorted(p.name for p in (tmp_path / "p").glob("ckpt_*.npz")) == [
        "ckpt_00000002.npz", "ckpt_00000003.npz"]
    assert not list((tmp_path / "p").glob(".tmp*"))


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_optimizer_step_equals_reference(ref_params, name, state_dtype):
    """Two updates from zeros on the same arrays, as the optimizer runs:
    the state equals the reference's bit for bit, and so do SGDM's
    parameters — the same operations in the same order. AdamW's
    parameters pass through ``sqrt(v̂)``, which torch's CPU kernel does not
    round correctly (1 ulp off for ~0.7% of float32 inputs; XLA's is
    correct): each parameter is held to 1 ulp of itself plus 2 ulps of
    each step's update (the sqrt's ulp, and the quotient's rounding it can
    flip), and fewer than 1% of all parameters may differ at all."""
    rng = np.random.default_rng(11)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), ref_params) for _ in range(2)]
    kw = dict(weight_decay=0.01) if name == "sgdm" else {}
    ref_opt = ref_make_optimizer(name, lr=2e-3, state_dtype=state_dtype,
                                 **kw)
    opt = make_optimizer(name, lr=2e-3, state_dtype=state_dtype, **kw)
    rp, rs = ref_params, ref_opt.init(ref_params)
    p = lenet_params_from_reference(ref_params, device="cpu")
    s = opt.init(p)
    updates = []
    for g in grads:
        before = _flat(jax.tree.map(np.asarray, rp))
        rp, rs = ref_opt.update(g, rs, rp)
        p, s = opt.update(lenet_params_from_reference(g, device="cpu"), s, p)
        updates.append({k: np.abs(np.asarray(v) - before[k])
                        for k, v in _flat(rp).items()})
    rs = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                      if x.dtype == jnp.bfloat16 else np.asarray(x), rs)
    rp = jax.tree.map(np.asarray, rp)
    if name == "sgdm":
        assert _bit_equal(p, rp)
    else:
        fp, frp = _flat(p), _flat(rp)
        assert fp.keys() == frp.keys()
        differing = 0
        for k in fp:
            got, want = _np(fp[k]), _np(frp[k])
            assert got.dtype == want.dtype == np.float32, k
            limit = np.spacing(np.abs(want)) + 2 * sum(
                np.spacing(u[k]) for u in updates)
            assert np.all(np.abs(got.astype(np.float64) - want) <= limit), k
            differing += int((got != want).sum())
        assert differing < 0.01 * sum(v.size for v in frp.values())
    flat = {k: (v.float() if v.dtype == torch.bfloat16 else v)
            for k, v in _flat(s).items()}
    assert flat.keys() == _flat(rs).keys()
    for k, v in _flat(rs).items():
        assert torch.equal(flat[k], torch.from_numpy(np.array(v))), k
    assert optimizers.BLOCK == ref_optimizers.BLOCK == 256


@pytest.mark.parametrize("name, args", [
    ("cosine_schedule", (2e-3, 50)),
    ("linear_warmup_cosine", (2e-3, 10, 50))], ids=["cosine", "warmup"])
def test_lr_schedules_equal_reference(name, args):
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(getattr(ref_schedule, name)(*args)(jnp.asarray(steps)))
    got = getattr(schedule, name)(*args)(torch.from_numpy(steps)).numpy()
    assert got.dtype == want.dtype == np.float32
    # jnp.cos and torch.cos may round the last bit apart
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_grad_through_compiled_loss_matches_plain_autograd(ref_params,
                                                           monkeypatch):
    """Autograd through a compiled ``lenet_loss`` program: every placed
    product's and MAC's cotangent comes from the kernels' backward."""
    b = 16
    params = lenet_params_from_reference(ref_params, device="cpu")
    rng = np.random.default_rng(3)
    for layer in params.values():
        layer["b"] = torch.from_numpy(
            rng.standard_normal(layer["b"].shape).astype(np.float32))
    imgs, labels = RefDigits(batch_size=b, seed=0).batch(4)
    args = (torch.from_numpy(imgs), torch.from_numpy(labels))
    sched = mapper.build_schedule(lenet.lenet_loss,
                                  mapper.abstract_like(params),
                                  *mapper.abstract_like(args))
    prog = mapper.compile_schedule(sched, use_cache=False, device="cpu")
    leaves = {f"{k}/{j}": v.clone().requires_grad_(True)
              for k, layer in params.items() for j, v in layer.items()}
    tree = {k: {j: leaves[f"{k}/{j}"] for j in layer}
            for k, layer in params.items()}
    calls = {"mm": 0, "mac": 0}
    real_mm, real_mac = (kernel_ref.pim_matmul_grouped_ref,
                         kernel_ref.pim_mac_wave_ref)
    monkeypatch.setattr(kernel_ref, "pim_matmul_grouped_ref",
                        lambda *a, **k: calls.__setitem__(
                            "mm", calls["mm"] + 1) or real_mm(*a, **k))
    # one call of K3's plain version per launch (a whole wave)
    monkeypatch.setattr(kernel_ref, "pim_mac_wave_ref",
                        lambda *a, **k: calls.__setitem__(
                            "mac", calls["mac"] + 1) or real_mac(*a, **k))
    loss = prog(tree, *args)
    forward = dict(calls)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    backward = {k: calls[k] - forward[k] for k in calls}
    # conv1's placed product needs its weight's cotangent only (the images
    # want none); conv2, fc1, fc2 and fc3 both operands'. Each bias add's
    # MAC needs the cotangent of its product input only.
    assert forward == {"mm": 5, "mac": prog.eltwise_launches}
    assert backward == {"mm": 9, "mac": prog.eltwise_launches}
    # no native product of a placed node is differentiated
    seen, stack = set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        assert type(fn).__name__ not in ("MmBackward0", "BmmBackward0",
                                         "ConvolutionBackward0")
        stack.extend(f for f, _ in fn.next_functions)
    want = torch.func.grad(lenet.lenet_loss)(params, *args)
    ref_grads = jax.grad(ref_lenet.lenet_loss)(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
        jnp.asarray(imgs), jnp.asarray(labels))
    for (path, _), g in zip(leaves.items(), grads, strict=True):
        k, j = path.split("/")
        torch.testing.assert_close(g, want[k][j], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[k][j]),
                                   rtol=1e-4, atol=1e-4)


def test_unported_trainer_options_raise(ref_params, tmp_path):
    # the pipelined plan is ported (tests/test_torch_pipeline.py); it
    # needs a loss and an optimizer, as the reference's does
    for kw in (dict(microbatches=2), dict(partitions=2)):
        with pytest.raises(ValueError, match="loss_fn and optimizer"):
            _trainer(ref_params, tmp_path, "pim", **kw)
        with pytest.raises(ValueError, match="backend='pim'"):
            _trainer(ref_params, tmp_path, "jit", **kw)
    # the quantized grids are ported (test_torch_pim_quant.py); off the
    # pim backend they are refused, as the reference refuses them
    for kw in (dict(weight_dtype="int8"), dict(act_dtype="fp16")):
        with pytest.raises(ValueError, match="backend='pim'"):
            _trainer(ref_params, tmp_path, "jit", **kw)
    with pytest.raises(ValueError, match="backend"):
        _trainer(ref_params, tmp_path, "xla")


def test_trainer_records_step_metrics_and_span(ref_params, tmp_path):
    m = obs.metrics()
    before = m.snapshot()["counters"].get("train.steps", 0)
    with obs.scoped() as tr:
        _trainer(ref_params, tmp_path, "jit", batch=4, total=3).run()
    snap = m.snapshot()
    assert snap["counters"]["train.steps"] == before + 3
    assert snap["histograms"]["train.step_wall_s"]["count"] >= 3
    steps = [e for e in tr.events if e.name == "train:step"]
    assert [e.args["step"] for e in steps] == [0, 1, 2]
