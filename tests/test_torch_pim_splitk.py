"""The K split of K1, K2 and K5 (``kernels/pim_mac.py`` ``split_k``), on
the CPU.

The CUDA body splits a contraction into S chunks of whole 128-deep tiles,
sums each chunk as one ascending chain and adds the chunk sums in order.
Its bits then depend on S, so S must be a function of the per-block
(M, K, N) alone (a grouped launch equals the per-block launches, the
compiled program equals the executor), and S = 1 wherever K <= 256 (every
forward and dA launch keeps its one chain over K). These tests hold the
policy at the launch shapes the mapped LeNet-5 makes on the CPU — serve
at batch 256, one AdamW train step at batch 64, and autograd through the
compiled ``lenet_loss`` and its per-block executor at batch 256 — and
hold the transposed-A helpers, which the VJPs' dB launches use, to the
launches on the materialized transpose bit for bit.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

from repro_torch import mapper
from repro_torch.data import make_digits
from repro_torch.models import lenet
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainerConfig

# the kernel module (``repro_torch.kernels.pim_mac`` the attribute is the
# function of that name)
pm = importlib.import_module("repro_torch.kernels.pim_mac")

SERVE_BATCH = 256          # chip_smoke's pim_lenet and pim_grad batch
TRAIN_BATCH = 64           # chip_smoke's pim_train batch
CONV1_DB = (128, 147456, 128)   # conv1's dB at batch 256: (M, K, N)
CARD_SMS = 132             # SMs of an H100 SXM


def _logging_helpers(monkeypatch, log):
    """Wrap the single-launch helpers so each launch logs its logical
    (kernel, G, M, K, N); every forward and backward launch goes through
    them."""
    real = {n: getattr(pm, n) for n in ("_matmul_grouped", "_matmul",
                                        "_matmul_grouped_q")}

    def k1(a, b, bm, bn, bk, cg, trans_a=False):
        m, k = a.shape[:0:-1] if trans_a else a.shape[1:]
        log.append(("k1", b.shape[0], m, k, b.shape[2]))
        return real["_matmul_grouped"](a, b, bm, bn, bk, cg, trans_a=trans_a)

    def k2(a, b, bm, bn, bk, trans_a=False):
        m, k = a.shape[::-1] if trans_a else a.shape
        log.append(("k2", 1, m, k, b.shape[1]))
        return real["_matmul"](a, b, bm, bn, bk, trans_a=trans_a)

    def k5(a, q, s, bm, bn, bk, cg):
        log.append(("k5", q.shape[0], a.shape[1], a.shape[2], q.shape[2]))
        return real["_matmul_grouped_q"](a, q, s, bm, bn, bk, cg)

    for name, fn in (("_matmul_grouped", k1), ("_matmul", k2),
                     ("_matmul_grouped_q", k5)):
        monkeypatch.setattr(pm, name, fn)


def _grad_leaves(params):
    tree = {k: {j: v.clone().requires_grad_(True) for j, v in layer.items()}
            for k, layer in params.items()}
    return tree, [v for layer in tree.values() for v in layer.values()]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The logical launch shapes of each path, by path name."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        params = lenet.init_lenet(0, device="cpu")
        imgs, labels = make_digits(SERVE_BATCH, seed=1)
        x, y = torch.from_numpy(imgs), torch.from_numpy(labels)

        out["pim_lenet"] = log = []
        _logging_helpers(mp, log)
        prog = mapper.compile_lenet("serve", batch=SERVE_BATCH, device="cpu")
        prog(params, x)
        mapper.ScheduleExecutor(prog.schedule, device="cpu").run(params, x)
        mp.undo()

        out["pim_train"] = log = []
        opt = make_optimizer("adamw", lr=2e-3)

        def train_step(p, opt_state, batch):
            grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
                p, *batch)
            p, opt_state = opt.update(grads, opt_state, p)
            return p, opt_state, loss

        tx, ty = x[:TRAIN_BATCH], y[:TRAIN_BATCH]
        trainer = Trainer(
            TrainerConfig(total_steps=1, ckpt_every=2, async_ckpt=False,
                          ckpt_dir=str(tmp_path_factory.mktemp("ckpt"))),
            train_step=train_step,
            init_state=lambda: (params, opt.init(params)),
            batch_fn=lambda step: (tx, ty), backend="pim", device="cpu")
        _logging_helpers(mp, log)
        trainer.run()
        mapper.ScheduleExecutor(trainer.pim_program.schedule,
                                device="cpu").run(
            params, opt.init(params), (tx, ty))
        mp.undo()

        out["pim_grad"] = log = []
        abstract = (mapper.abstract_like(params),
                    *mapper.abstract_like((x, y)))
        sched = mapper.build_schedule(lenet.lenet_loss, *abstract)
        gprog = mapper.compile_schedule(sched, use_cache=False, device="cpu")
        ex = mapper.ScheduleExecutor(sched, device="cpu")
        _logging_helpers(mp, log)
        for run in (gprog, ex.run):
            tree, leaves = _grad_leaves(params)
            torch.autograd.grad(run(tree, x, y), leaves)
    finally:
        mp.undo()
    return out


def test_split_k_takes_the_per_block_shape_alone():
    assert list(inspect.signature(pm.split_k).parameters) == ["m", "k", "n"]
    # G only sizes the workspace: one split for every group count
    for g in (1, 2, 8):
        splits, depth, ws = pm._split(g, *CONV1_DB, "cpu")
        assert (splits, depth) == (231, 640)
        assert ws.shape == (231, g, 128, 128)
    assert pm._split(4, 256, 256, 128, "cpu") == (1, 256, None)


@pytest.mark.parametrize("path", ["pim_lenet", "pim_train", "pim_grad"])
def test_paths_split_only_contractions_over_256(launches, path):
    log = launches[path]
    assert log, f"{path} made no K1/K2/K5 launch"
    for kernel, g, m, k, n in log:
        splits = pm.split_k(m, k, n)
        if k <= pm.SPLIT_MIN_K:
            assert splits == 1, (kernel, g, m, k, n)
        depth = pm.chunk_depth(k, splits)
        assert (splits - 1) * depth < k <= splits * depth
    if path != "pim_grad":         # every forward launch keeps one chain
        assert all(k <= pm.SPLIT_MIN_K for *_, k, _ in log)


def test_pim_grad_splits_the_weight_gradients(launches):
    """The dB launches of conv1 and conv2 (K1 from the program, K2 from
    the executor) are the only split launches, and conv1's fills the
    card."""
    split = {(kernel, (m, k, n)): pm.split_k(m, k, n)
             for kernel, _, m, k, n in launches["pim_grad"]
             if pm.split_k(m, k, n) > 1}
    assert split == {("k1", CONV1_DB): 231, ("k2", CONV1_DB): 231,
                     ("k1", (256, 16384, 128)): 64,
                     ("k2", (256, 16384, 128)): 64}
    m, k, n = CONV1_DB
    assert (m // 128) * (n // 128) * pm.split_k(m, k, n) >= CARD_SMS


def _shapes():
    ks = list(range(8, 4096, 8)) + [8192, 16384, 16392, 36864, 147456,
                                    147456 + 8]
    return [(m, k, n) for m in (128, 256, 1024, 1280, 147456)
            for n in (128, 384) for k in ks]


def test_chunks_are_whole_tiles_and_cover_k_exactly():
    for m, k, n in _shapes():
        splits = pm.split_k(m, k, n)
        depth = pm.chunk_depth(k, splits)
        if splits == 1:
            assert depth == k
            continue
        assert k > pm.SPLIT_MIN_K
        assert depth % pm.SPLIT_TILE == 0
        assert depth >= pm.SPLIT_MIN_TILES * pm.SPLIT_TILE
        # S chunks, none empty, the last ending at K
        assert (splits - 1) * depth < k <= splits * depth
        # blocks of a group: about SPLIT_BLOCKS at most (one chunk fewer
        # per tile would go below it)
        tiles = (m // 128) * (n // 128)
        assert tiles * splits < pm.SPLIT_BLOCKS + tiles


@pytest.mark.parametrize("cg", [1, 2])
def test_transposed_a_helpers_equal_the_materialized_launch(cg):
    rng = np.random.default_rng(11 + cg)
    a = torch.from_numpy(rng.standard_normal((2, 384, 128), np.float32))
    g = torch.from_numpy(rng.standard_normal((2 * cg, 384, 256),
                                             np.float32))
    got = pm._matmul_grouped(a, g, 128, 128, 128, cg, trans_a=True)
    want = pm._matmul_grouped(a.transpose(1, 2).contiguous(), g, 128, 128,
                              128, cg)
    assert got.shape == (2 * cg, 128, 256) and torch.equal(got, want)
    got2 = pm._matmul(a[0], g[0], 128, 128, 128, trans_a=True)
    assert torch.equal(got2, pm._matmul(a[0].T.contiguous(), g[0], 128, 128,
                                        128))
    assert torch.equal(got2, got[0])
    with pytest.raises(ValueError, match="shapes"):
        pm._matmul_grouped(a, g[:, :256], 128, 128, 128, cg, trans_a=True)
    with pytest.raises(ValueError, match="shapes"):
        pm._matmul(a[0], g[0, :256], 128, 128, 128, trans_a=True)
