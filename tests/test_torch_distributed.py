"""The port's distributed substrate across four gloo ranks on the CPU
(``torch.multiprocessing.spawn``, a ``FileStore`` under the test's
temporary directory; no TCP store), against the reference:

  (a) ``optim.compressed_psum`` over 4 ranks, two steps with error
      feedback, bit for bit the reference's under ``jax.vmap(...,
      axis_name="data")`` (its ``pmax`` / ``psum`` batch there);
  (b) ``parallel.pipeline.make_pipelined_fn`` with 2 and 4 stages, within
      1e-5 (``tests/test_pipeline.py``'s limit) of the unpipelined form
      and of the reference's stage function run sequentially in JAX;
  (c) llama3-8b smoke's train step on DTensor params over a (2, 2)
      ``("data", "model")`` mesh, fsdp off and on, against the
      single-process step: loss within 2e-4, params within 2e-3 (the
      reference's ``test_system.py`` limits); a batch whose second data
      shard holds the first shard's tokens must fail that check. The
      first AdamW step moves each param by about lr · sign(g), so those
      limits cannot see the backward: the mesh's gradients (each leaf
      gathered whole) are held against the single-process gradients and
      ``jax.grad`` of the reference's loss on the same params, and the
      stepped params within 1e-5; one data rank's part of a gradient
      leaf's pending data-parallel sum doubled (a fault the loss cannot
      see, nor the first step's params) must fail the gradient hold;
  (d) elastic resume: a one-process ``Trainer`` checkpoints steps 0–10,
      then ``launch.train.run`` on a (4, 1) mesh resumes at step 11 and
      runs to 16, its losses within 2e-4 of the uninterrupted run's.

One world runs every check (its start and DTensor's first sharding
propagation dominate the time); each test reads its part of the world's
record. The group and the join each time out at 120 s.
"""

from __future__ import annotations

import datetime
import json
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT_S = 120
PSUM_SHAPES = {"a": (300,), "b": (8, 33)}
PIPE = dict(layers=3, n_micro=4, mb=2, d=16)
STEP = dict(batch=4, seq=16, lr=1e-3)
ELASTIC = dict(batch=8, seq=32, lr=1e-3, first=11, total=17)
TOL_LOSS, TOL_PARAMS = 2e-4, 2e-3
# the mesh's own holds, from the sound readings (``CHANGES.md``): params
# after the step, and each gradient leaf against its largest |g|, against
# the single-process step and against ``jax.grad`` (the reference's
# gradient tolerance, ``tests/test_torch_variant_grads.py``)
TOL_STEPPED, TOL_GRAD, TOL_GRAD_REF = 1e-5, 1e-5, 1e-4


# -- inputs (numpy, seeded) ---------------------------------------------------


def _psum_inputs():
    rng = np.random.default_rng(0)
    return [{k: rng.standard_normal((WORLD, *s)).astype(np.float32)
             for k, s in PSUM_SHAPES.items()} for _ in range(2)]


def _pipe_inputs(n_stages: int):
    rng = np.random.default_rng(n_stages)
    w = (rng.standard_normal((n_stages, PIPE["layers"], PIPE["d"],
                              PIPE["d"])) * 0.3).astype(np.float32)
    x = rng.standard_normal((PIPE["n_micro"], PIPE["mb"],
                             PIPE["d"])).astype(np.float32)
    return x, w


def _stage_fn(stage_w: torch.Tensor, xm: torch.Tensor) -> torch.Tensor:
    for wl in stage_w:
        xm = torch.tanh(xm @ wl)
    return xm


# -- the world's checks (each runs on every rank) -----------------------------


def _check_psum(rank: int, inputs) -> dict:
    from repro_torch.optim import compressed_psum

    out, err = {}, None
    for i, step in enumerate(inputs):
        grads = {k: torch.from_numpy(v[rank]) for k, v in step.items()}
        red, err = compressed_psum(grads, None, err)
        out.update({f"red{i}/{k}": v.numpy() for k, v in red.items()})
        out.update({f"err{i}/{k}": v.numpy() for k, v in err.items()})
    return out


def _check_pipeline(rank: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import make_pipelined_fn

    out = {}
    for n_stages in (2, 4):
        mesh = init_device_mesh("cpu", (WORLD // n_stages, n_stages),
                                mesh_dim_names=("data", "pod"))
        x, w = map(torch.from_numpy, _pipe_inputs(n_stages))
        piped = make_pipelined_fn(_stage_fn, mesh, axis="pod",
                                  n_micro=PIPE["n_micro"])(x, w)
        ref = x
        for s in range(n_stages):
            ref = torch.stack([_stage_fn(w[s], xm) for xm in ref])
        out[f"pipe{n_stages}"] = piped.numpy()
        out[f"pipe{n_stages}_gap"] = float((piped - ref).abs().max())
    return out


def _llama_smoke():
    from repro_torch import configs
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.optim import make_optimizer

    cfg = configs.get_smoke_config("llama3-8b")
    params = DecoderLM(cfg, device="cpu").init(0).stacked_params()
    opt = make_optimizer("adamw", lr=STEP["lr"])
    return cfg, params, opt


def _step_batch() -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenStream

    return TokenStream(get_smoke_config("llama3-8b").vocab_size,
                       STEP["seq"], STEP["batch"], seed=1).batch(0)


def _gap(p1, l1, p2, l2) -> tuple[float, float]:
    from repro_torch._tree import leaves_with_path
    from repro_torch.parallel.sharding import full

    mx = 0.0
    for (_, a), (_, b) in zip(leaves_with_path(p1), leaves_with_path(p2)):
        mx = max(mx, float((a.float() - full(b).float()).abs().max()))
    return abs(float(l1) - float(full(l2))), mx


def _doubled_on_data_rank_0(grads, mesh):
    """``grads`` with data rank 0's part of the first leaf that is not
    replicated along the data axis doubled (a ``Partial(sum)``: the
    data-parallel reduction still pending, so rank 0's rows count twice):
    (the tree, the leaf's path)."""
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import map_with_path

    path = next(k for k, g in _leaves(grads)
                if not g.placements[0].is_replicate())
    scale = 2.0 if mesh.get_coordinate()[0] == 0 else 1.0

    def one(key, g):
        if key != path:
            return g
        return DTensor.from_local(g.to_local() * scale, mesh, g.placements,
                                  shape=g.shape, stride=g.stride())

    return map_with_path(one, grads), path


def _check_train_step(rank: int) -> tuple[dict, dict]:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding

    cfg, params, opt = _llama_smoke()
    batch = {k: torch.as_tensor(v) for k, v in _step_batch().items()}
    step = steps.make_train_step(cfg, lr=STEP["lr"])
    p1, _, l1 = step(params, opt.init(params), batch)

    mesh = make_host_mesh(model_axis=2, device="cpu")
    loss_fn = steps.make_loss_fn(cfg)
    out, arrays = {}, {}
    for fsdp in (False, True):
        rules = sharding.single_pod_rules(mesh, fsdp=fsdp)
        p_specs = sharding.param_specs(params, rules)
        o_specs = steps._opt_specs_like(opt.init(params), p_specs)
        dp = sharding.distribute(params, p_specs, mesh)
        do = sharding.distribute(opt.init(params), o_specs, mesh)
        db = sharding.distribute(batch, steps.batch_specs(cfg, rules), mesh)
        with sharding.use_rules(rules):
            grads, _ = steps.grad_and_value(loss_fn, dp, db)
            p2, _, l2 = step(dp, do, db)
        out[f"fsdp={fsdp}"] = _gap(p1, l1, p2, l2)
        arrays.update({f"grad/fsdp={fsdp}/{k}": sharding.full(g).numpy()
                       for k, g in _leaves(grads)})
        if fsdp:
            bad, out["doubled_leaf"] = _doubled_on_data_rank_0(grads, mesh)
            arrays.update({f"grad/doubled/{k}": sharding.full(g).numpy()
                           for k, g in _leaves(bad)})
        out[f"fsdp={fsdp}/placed"] = all(
            tuple(leaf.placements) == sharding.placements(spec, mesh)
            for (_, leaf), spec in zip(_leaves(dp), _spec_leaves(p_specs)))

    # control: the second data shard holds the first shard's tokens
    rules = sharding.single_pod_rules(mesh, fsdp=True)
    half = STEP["batch"] // 2
    coord = mesh.get_coordinate()[0]
    rows = slice(0, half)                       # every shard takes rows 0..
    own = slice(coord * half, (coord + 1) * half)
    place = (Shard(0), Replicate())
    bad = {"tokens": DTensor.from_local(batch["tokens"][rows], mesh, place),
           "labels": DTensor.from_local(batch["labels"][own], mesh, place)}
    dp = sharding.distribute(params, sharding.param_specs(params, rules),
                             mesh)
    with sharding.use_rules(rules):
        p2, _, l2 = step(dp, opt.init(params), bad)
    out["swapped"] = _gap(p1, l1, p2, l2)
    return out, arrays


def _leaves(tree):
    from repro_torch._tree import leaves_with_path
    return list(leaves_with_path(tree))


def _spec_leaves(specs) -> list:
    from repro_torch.parallel.sharding import Spec
    if isinstance(specs, Spec):
        return [specs]
    return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]


def _check_elastic(rank: int, ckpt: str) -> dict:
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import run

    mesh = make_host_mesh(model_axis=1, device="cpu")
    res = run(configs.get_smoke_config("llama3-8b"), mesh=mesh,
              steps=ELASTIC["total"], batch=ELASTIC["batch"],
              seq=ELASTIC["seq"], lr=ELASTIC["lr"], ckpt=ckpt, device="cpu")
    return {"losses": res["losses"], "start_step": res["start_step"],
            "resumed": res["resumed"]}


def _world(rank: int, store: str, out_dir: str, psum_inputs, ckpt: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        record, seconds = {}, {}
        t0 = time.monotonic()
        arrays = _check_psum(rank, psum_inputs)
        arrays.update(_check_pipeline(rank))
        record["pipe_gaps"] = {k: arrays.pop(k) for k in list(arrays)
                               if k.endswith("_gap")}
        seconds["psum+pipeline"] = time.monotonic() - t0
        record["train_step"], grads = _check_train_step(rank)
        arrays.update(grads)
        seconds["train_step"] = time.monotonic() - t0 - sum(seconds.values())
        record["elastic"] = _check_elastic(rank, ckpt)
        seconds["elastic"] = time.monotonic() - t0 - sum(seconds.values())
        record["seconds"] = seconds
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **arrays)
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(
            json.dumps(record))
    finally:
        dist.destroy_process_group()


def _spawn(args) -> None:
    ctx = mp.spawn(_world, args=args, nprocs=WORLD, join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD}-rank world did not end in "
                        f"{TIMEOUT_S} s")


def _elastic_first_run(ckpt: str, steps: int) -> list[float]:
    """A one-process ``Trainer`` on the plain step, with the inputs and
    init of ``launch.train.run``."""
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps as steps_mod
    from repro_torch.train import Trainer, TrainerConfig

    cfg, _, _ = _llama_smoke()
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.optim import make_optimizer
    model = DecoderLM(cfg, device="cpu")
    opt = make_optimizer("adamw", lr=ELASTIC["lr"],
                         state_dtype=cfg.opt_state_dtype)

    def init_state():
        params = model.init(0).stacked_params()
        return params, opt.init(params)

    ts = TokenStream(cfg.vocab_size, ELASTIC["seq"], ELASTIC["batch"],
                     seed=0)
    tr = Trainer(TrainerConfig(total_steps=steps, ckpt_every=5,
                               ckpt_dir=ckpt, async_ckpt=False),
                 train_step=steps_mod.make_train_step(cfg,
                                                      lr=ELASTIC["lr"]),
                 init_state=init_state, batch_fn=ts.batch, device="cpu")
    return tr.run()["losses"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    psum_inputs = _psum_inputs()
    ckpt = str(root / "elastic")
    _elastic_first_run(ckpt, ELASTIC["first"])
    uninterrupted = _elastic_first_run(str(root / "whole"),
                                       ELASTIC["total"])
    t0 = time.monotonic()
    _spawn((str(root / "store"), str(root), psum_inputs, ckpt))
    spawn_s = time.monotonic() - t0
    ranks = [(dict(np.load(root / f"rank{r}.npz")),
              json.loads((root / f"rank{r}.json").read_text()))
             for r in range(WORLD)]
    return dict(ranks=ranks, psum_inputs=psum_inputs,
                uninterrupted=uninterrupted, spawn_s=spawn_s,
                grads=_single_process_grads())


# -- (a) compressed_psum ------------------------------------------------------


def _reference_psum(inputs):
    import jax
    import jax.numpy as jnp

    from repro.optim import compressed_psum

    s1 = {k: jnp.asarray(v) for k, v in inputs[0].items()}
    s2 = {k: jnp.asarray(v) for k, v in inputs[1].items()}
    red1, err1 = jax.vmap(lambda g: compressed_psum(g, "data", None),
                          axis_name="data")(s1)
    red2, err2 = jax.vmap(lambda g, e: compressed_psum(g, "data", e),
                          axis_name="data")(s2, err1)
    out = {}
    for i, (red, err) in enumerate(((red1, err1), (red2, err2))):
        out.update({f"red{i}/{k}": np.asarray(v) for k, v in red.items()})
        out.update({f"err{i}/{k}": np.asarray(v) for k, v in err.items()})
    return out


@pytest.mark.parametrize("rank", range(WORLD))
def test_compressed_psum_bit_equal_to_reference(world, rank):
    want = _reference_psum(world["psum_inputs"])
    got = world["ranks"][rank][0]
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key], ref[rank], err_msg=key)
    # the reduced gradients are the ranks' mean, to int8 quantization
    mean = world["psum_inputs"][0]["b"].mean(0)
    rel = np.abs(got["red0/b"] - mean).max() / np.abs(mean).max()
    assert rel < 0.02, rel


# -- (b) the mesh pipeline ----------------------------------------------------


def _reference_sequential(n_stages: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    x, w = (jnp.asarray(a) for a in _pipe_inputs(n_stages))

    def stage_fn(stage_w, xm):
        def layer(c, wl):
            return jnp.tanh(c @ wl), None
        y, _ = jax.lax.scan(layer, xm, stage_w)
        return y

    ref = x
    for s in range(n_stages):
        ref = jax.vmap(lambda xm, s=s: stage_fn(w[s], xm))(ref)
    return np.asarray(ref)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipelined_fn_matches_unpipelined(world, n_stages):
    ref = _reference_sequential(n_stages)
    for arrays, record in world["ranks"]:
        assert record["pipe_gaps"][f"pipe{n_stages}_gap"] < 1e-5
        got = arrays[f"pipe{n_stages}"]
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-5


# -- (c) the train step on a (2, 2) mesh ---------------------------------------


def _single_process_grads() -> dict:
    """The gradients of the check's loss, one process: the plain step's
    (``torch.func``) and the reference's ``jax.grad`` on the same params
    (the port's leaf paths are the reference's flattened keys)."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.ckpt import _flatten
    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.launch import steps as ref_steps
    from repro.models.transformer import build_model
    from repro_torch.launch import steps
    from repro_torch.models.transformer import param_tree

    cfg, params, _ = _llama_smoke()
    batch = _step_batch()
    plain, _ = torch.func.grad_and_value(steps.make_loss_fn(cfg))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    rparams = jax.tree.map(jnp.asarray, param_tree(
        {k: p.numpy() for k, p in _leaves(params)}))
    ref = jax.jit(jax.grad(ref_steps.make_loss_fn(build_model(
        ref_smoke_config("llama3-8b")))))(rparams, batch)
    return {"plain": {k: g.numpy() for k, g in _leaves(plain)},
            "reference": {k: np.asarray(v) for k, v in _flatten(ref).items()}}


def _grad_gaps(arrays: dict, tag: str, want: dict) -> dict:
    """Each leaf's largest gap from ``want`` over that leaf's largest
    |g|."""
    return {k: float(np.abs(arrays[f"grad/{tag}/{k}"] - w).max()
                     / max(np.abs(w).max(), 1e-30)) for k, w in want.items()}


@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_train_step_matches_single_process(world, fsdp):
    for _, record in world["ranks"]:
        loss_gap, param_gap = record["train_step"][f"fsdp={fsdp}"]
        assert loss_gap < TOL_LOSS and param_gap < TOL_PARAMS, (
            loss_gap, param_gap)
        assert param_gap < TOL_STEPPED, param_gap
        assert record["train_step"][f"fsdp={fsdp}/placed"]


@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_gradients_match_single_process_and_reference(world, fsdp):
    for arrays, _ in world["ranks"]:
        plain = _grad_gaps(arrays, f"fsdp={fsdp}", world["grads"]["plain"])
        assert max(plain.values()) < TOL_GRAD, plain
        ref = _grad_gaps(arrays, f"fsdp={fsdp}",
                         world["grads"]["reference"])
        assert max(ref.values()) < TOL_GRAD_REF, ref


def test_doubled_gradient_shard_fails_the_gradient_hold(world):
    """The control of the gradient hold: its forward, so its loss, is the
    sound run's; one data rank's part of one leaf's pending data-parallel
    sum is doubled."""
    for arrays, record in world["ranks"]:
        leaf = record["train_step"]["doubled_leaf"]
        gaps = _grad_gaps(arrays, "doubled", world["grads"]["plain"])
        assert gaps[leaf] >= TOL_GRAD, gaps[leaf]
        assert all(g < TOL_GRAD for k, g in gaps.items() if k != leaf)


def test_swapped_batch_shard_fails_the_check(world):
    for _, record in world["ranks"]:
        loss_gap, param_gap = record["train_step"]["swapped"]
        assert not (loss_gap < TOL_LOSS and param_gap < TOL_PARAMS), (
            loss_gap, param_gap)


# -- (d) elastic resume --------------------------------------------------------


def test_elastic_resume_on_four_ranks_matches_uninterrupted(world):
    whole = world["uninterrupted"]
    for _, record in world["ranks"]:
        el = record["elastic"]
        assert el["resumed"] and el["start_step"] == ELASTIC["first"]
        got = el["losses"]
        want = whole[ELASTIC["first"]:]
        assert len(got) == len(want) == ELASTIC["total"] - ELASTIC["first"]
        assert np.all(np.isfinite(got))
        assert np.abs(np.asarray(got) - np.asarray(want)).max() < TOL_LOSS
