"""The port's sharding rules (``repro_torch.parallel.sharding``) and a
launch cell's shardings (``repro_torch.launch.steps.cell_shardings``)
against the reference's, leaf for leaf.

Every arch of ``ARCH_IDS`` at its published config, on the (16, 16)
single-pod and (2, 16, 16) multi-pod production meshes (abstract meshes:
no ranks needed), for each applicable ``LM_SHAPES`` cell through
``make_rules``: the param, optimizer-state, batch, cache and token specs
equal the reference's ``PartitionSpec``s. So do ``param_specs`` and
``cache_specs`` (its FlashDecoding sequence split included) under
``single_pod_rules(fsdp=True, seq_shard=True)``. Beside them: the
production shapes, ``fit_spec`` on indivisible dims, ``placements`` on a
one-rank gloo mesh, and ``constrain`` as a no-op without rules.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro.launch import steps as ref_steps
from repro.parallel import sharding as ref_sh
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import steps
from repro_torch.parallel import sharding

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _meshes(name: str):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), sharding.AbstractMesh(shape, axes)


def _ref_flat(tree) -> dict:
    """``{path: spec entries}`` of a reference tree of ``NamedSharding``s
    or ``PartitionSpec``s."""
    is_leaf = lambda x: isinstance(x, (NamedSharding, P))   # noqa: E731
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {ref_sh._path_str(path): tuple(getattr(leaf, "spec", leaf))
            for path, leaf in leaves}


def _flat(tree, prefix: str = "") -> dict:
    """``{path: spec entries}`` of the port's spec tree."""
    if isinstance(tree, sharding.Spec):
        return {prefix: tuple(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _cells():
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for mesh in MESHES:
            for shape in base.LM_SHAPES:
                if base.shape_applicable(cfg, shape):
                    yield pytest.param(arch, mesh, shape.name,
                                       id=f"{arch}-{mesh}-{shape.name}")


@pytest.mark.parametrize("arch,mesh,shape_name", list(_cells()))
def test_cell_shardings_equal_reference(arch, mesh, shape_name):
    ref_mesh, mesh_ = _meshes(mesh)
    shape = next(s for s in base.LM_SHAPES if s.name == shape_name)
    ref_shape = next(s for s in ref_base.LM_SHAPES if s.name == shape_name)
    want = ref_steps.cell_shardings(ref_mesh, ref_configs.get_config(arch),
                                    ref_shape)
    got = steps.cell_shardings(mesh_, configs.get_config(arch), shape)
    assert got.rules.rules == want.rules.rules
    for field in ("params", "opt_state", "batch", "cache"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            ref, port = _ref_flat(w), _flat(g)
            assert port == ref, field
            assert len(port) > 0
    if want.token is None:
        assert got.token is None
    else:
        assert tuple(got.token) == tuple(want.token.spec)
    if shape_name == "decode_32k":
        # a KV cache whose heads cannot take the model axis splits its
        # sequence over it instead (FlashDecoding)
        kv = {k: v for k, v in _flat(got.cache).items()
              if k.endswith(("/k", "/v"))}
        heads = configs.get_config(arch).n_kv_heads
        assert all("model" in spec for spec in kv.values())
        assert all((spec[-2] == "model") == (heads % 16 == 0)
                   for spec in kv.values())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_seq_shard_fsdp_specs_equal_reference(arch):
    ref_mesh, mesh_ = _meshes("single")
    decode = next(s for s in base.LM_SHAPES if s.name == "decode_32k")
    ref_cfg = ref_configs.get_config(arch)
    cfg = configs.get_config(arch)
    ref_rules = ref_sh.single_pod_rules(ref_mesh, fsdp=True, seq_shard=True)
    rules = sharding.single_pod_rules(mesh_, fsdp=True, seq_shard=True)
    ref_params = ref_sh.param_specs(ref_steps.abstract_params(ref_cfg),
                                    ref_rules)
    assert _flat(sharding.param_specs(steps.abstract_params(cfg), rules)) \
        == _ref_flat(ref_params)
    ref_cache = ref_sh.cache_specs(
        ref_steps.abstract_cache(ref_cfg, decode), ref_rules)
    got = _flat(sharding.cache_specs(steps.abstract_cache(cfg, decode),
                                     rules))
    assert got == _ref_flat(ref_cache)


def test_production_shapes_equal_reference():
    assert [tuple(vars(s).values()) for s in base.LM_SHAPES] == \
        [tuple(vars(s).values()) for s in ref_base.LM_SHAPES]
    assert base.LONG_CONTEXT_ARCHS == ref_base.LONG_CONTEXT_ARCHS
    for arch in configs.ARCH_IDS:
        for s, r in zip(base.LM_SHAPES, ref_base.LM_SHAPES):
            assert base.shape_applicable(configs.get_config(arch), s) == \
                ref_base.shape_applicable(ref_configs.get_config(arch), r)


@pytest.mark.parametrize("phys,shape", [
    (["model", None], (49_155, 4096)),          # granite's vocab on 16
    ([None, "model", None], (4096, 24, 128)),   # 24 kv heads on 16
    ([("data",), "model"], (4096, 14_336)),
    ([("pod", "data"), None], (48, 8)),         # 32-way on 48 rows
    ([("pod", "data"), "model"], (64, 32)),
])
def test_fit_spec_drops_indivisible_entries(phys, shape):
    ref_mesh, mesh_ = _meshes("multi")
    got = sharding.fit_spec(list(phys), shape, mesh_)
    assert tuple(got) == tuple(ref_sh.fit_spec(list(phys), shape, ref_mesh))
    for entry, dim in zip(got, shape):
        if entry is not None:
            assert dim % sharding._axis_size(mesh_, entry) == 0


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A (1, 1, 1) ``("pod", "data", "model")`` DeviceMesh over a one-rank
    gloo group (a ``FileStore``, no TCP port), torn down after."""
    from torch.distributed.device_mesh import init_device_mesh

    started = not dist.is_initialized()
    if started:
        store = str(tmp_path_factory.mktemp("store") / "store")
        dist.init_process_group("gloo", store=dist.FileStore(store, 1),
                                rank=0, world_size=1)
    yield init_device_mesh("cpu", (1, 1, 1),
                           mesh_dim_names=("pod", "data", "model"))
    if started:
        dist.destroy_process_group()


def _spec_of(placements, mesh, ndim: int) -> sharding.Spec:
    """The spec a DTensor's placements encode (``placements``' inverse)."""
    entries = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            entries[p.dim].append(name)
    return sharding.Spec(*(tuple(e) or None for e in entries))


@pytest.mark.parametrize("spec", [
    sharding.Spec(None, None), sharding.Spec("model", None),
    sharding.Spec(None, "model"), sharding.Spec("data", "model"),
    sharding.Spec(("pod", "data"), None), sharding.Spec(("pod", "data"),
                                                        "model"),
])
def test_placements_round_trip(one_rank_mesh, spec):
    from torch.distributed.tensor import Replicate, Shard

    mesh = one_rank_mesh
    pl = sharding.placements(spec, mesh)
    assert len(pl) == 3
    for name, p in zip(mesh.mesh_dim_names, pl):
        owner = [d for d, e in enumerate(spec)
                 if e == name or (isinstance(e, tuple) and name in e)]
        assert p == (Shard(owner[0]) if owner else Replicate())
    assert _spec_of(pl, mesh, 2) == spec
    x = torch.arange(12.0).reshape(4, 3)
    d = sharding.distribute({"w": x}, {"w": spec}, mesh)["w"]
    assert tuple(d.placements) == pl
    assert torch.equal(sharding.full(d), x)


def test_placements_refuses_a_tuple_against_the_mesh_order(one_rank_mesh):
    with pytest.raises(ValueError):
        sharding.placements(sharding.Spec(("data", "pod"), None),
                            one_rank_mesh)


def test_constrain_without_rules_is_the_input(one_rank_mesh):
    x = torch.ones(2, 3, 4)
    assert sharding.current_rules() is None
    assert sharding.constrain(x, ("batch", None, "vocab")) is x
    _, mesh_ = _meshes("single")
    with sharding.use_rules(sharding.single_pod_rules(mesh_)):
        assert sharding.constrain(x, ("batch", None, "vocab")) is x
    with sharding.use_rules(sharding.single_pod_rules(one_rank_mesh)):
        assert sharding.constrain(x, ("batch", None, "vocab")) is x
    assert sharding.current_rules() is None
    assert np.array_equal(x.numpy(), np.ones((2, 3, 4)))
