"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP + pod axis) on
``torch.distributed``'s ``DeviceMesh`` and DTensor: the port of
``repro.parallel.sharding``.

Models annotate tensors with *logical* axis names; the launcher binds those
names to physical mesh axes. This keeps model code mesh-agnostic: the same
model lays out on a (16, 16) single-pod mesh, a (2, 16, 16) multi-pod mesh,
or one device (where every rule resolves to replication, and
``constrain`` returns its input itself).

Logical axes used by the model zoo:
  batch    — data parallel dimension              -> ("pod","data")
  seq      — sequence parallelism (long-context)  -> None or "data"
  embed    — d_model (kept replicated)            -> None
  heads    — attention heads (tensor parallel)    -> "model"
  kv_heads — KV heads                             -> "model"
  mlp      — FFN hidden (tensor parallel)         -> "model"
  vocab    — vocab dim of embedding/lm_head       -> "model"
  expert   — MoE expert dim (expert parallel)     -> "model"
  layers   — scanned layer stack dim              -> None (or "pod" for PP)
  fsdp     — extra param shard dim for big archs  -> "data"

A spec (``Spec``) has one entry per tensor dim: ``None``, a mesh axis name
or a tuple of names (one dim split over several mesh axes, major to
minor), normalized as JAX's ``PartitionSpec`` normalizes it (a one-name
tuple is the name). A mesh is anything with axis names and sizes: a live
``DeviceMesh`` or an ``AbstractMesh``, which resolves the production
meshes without their ranks. ``placements(spec, mesh)`` is the DTensor
layout of a spec, and ``distribute(tree, specs, mesh)`` lays a param or
cache tree out by its specs.

Paths are the '/'-joined leaf paths of ``checkpoint.ckpt._flatten``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any

import torch

from repro_torch._tree import leaves_with_path, map_with_path, tree_map


class Spec(tuple):
    """One partition entry per tensor dim, as JAX's ``PartitionSpec``
    holds them: ``None``, an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or ranks (the
    reference's ``jax.sharding.AbstractMesh``): enough to resolve specs
    for a production mesh on a host that has none of its ranks."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``,
    in the mesh's order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Binding of logical axis names to physical mesh axes."""

    rules: dict[str, Any]
    mesh: Any = None

    def resolve(self, logical: tuple) -> Spec:
        return Spec(*(None if name is None else self.rules.get(name)
                      for name in logical))


def single_pod_rules(mesh, *, fsdp: bool = False,
                     seq_shard: bool = False) -> AxisRules:
    rules = {
        "batch": ("data",),
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_cap": "data",   # MoE dispatch-capacity dim: sharded over
        #                         data so expert FLOPs/buffers spread across
        #                         the full mesh, not just the model axis
        "seq": "data" if seq_shard else None,
        "seq_act": "model",   # Megatron-style sequence sharding of the
        #                       inter-layer residual/carry (memory, not math)
        "fsdp": "data" if fsdp else None,
    }
    return AxisRules(rules=rules, mesh=mesh)


def multi_pod_rules(mesh, *, fsdp: bool = False,
                    seq_shard: bool = False) -> AxisRules:
    rules = {
        "batch": ("pod", "data"),
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_cap": ("pod", "data"),
        "seq": "data" if seq_shard else None,
        "seq_act": "model",
        "fsdp": "data" if fsdp else None,
    }
    return AxisRules(rules=rules, mesh=mesh)


def long_context_rules(mesh, *, multi_pod: bool = False) -> AxisRules:
    """Sequence-parallel rules for the batch=1 long_500k decode shape:
    batch is unshardable (size 1) so the KV/sequence dim takes the data
    axes instead (context parallelism)."""
    rules = {
        "batch": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_cap": ("pod", "data") if multi_pod else ("data",),
        "seq": ("pod", "data") if multi_pod else ("data",),
        "fsdp": None,
    }
    return AxisRules(rules=rules, mesh=mesh)


_LOCAL = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_LOCAL, "rules", None)


@contextlib.contextmanager
def use_rules(rules: AxisRules | None):
    """Bind ``rules`` for the block (the reference's ``with mesh,
    use_rules(rules)``). Under rules on a live mesh, a plain tensor that
    meets a DTensor (the rope tables, masks, offsets and iotas a step
    makes) enters as replicated: DTensor's implicit replication, as a
    JAX mesh context lets unsharded constants in."""
    prev = current_rules()
    _LOCAL.rules = rules
    try:
        with _implicit_replication(rules):
            yield rules
    finally:
        _LOCAL.rules = prev


def _live(rules: AxisRules | None) -> bool:
    return (rules is not None and rules.mesh is not None
            and not isinstance(rules.mesh, AbstractMesh))


def _implicit_replication(rules: AxisRules | None):
    if not _live(rules):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    register_dtensor_rules()
    return implicit_replication()


def logical_to_spec(logical: tuple) -> Spec | None:
    r = current_rules()
    if r is None:
        return None
    return r.resolve(logical)


def constrain(x, logical: tuple):
    """The layout hint of ``with_sharding_constraint``: with active rules
    on a live mesh, a DTensor ``x`` is redistributed to the placements
    of ``logical`` (entries that do not divide their dim dropped, as
    ``fit_spec`` drops them). Otherwise ``x`` itself: no op, nothing a
    trace sees."""
    r = current_rules()
    if not _live(r):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = fit_spec(list(r.resolve(logical)), tuple(x.shape), r.mesh)
    want = placements(spec, r.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(r.mesh, want)


# ---------------------------------------------------------------------------
# parameter partitioning: pattern-match param tree paths to logical specs
# ---------------------------------------------------------------------------

# Ordered (regex, logical axes per dim) rules over '/'-joined tree paths.
# Matched right-to-left against trailing dims when the param has a leading
# stacked-layers dim. A tuple marks the dim sharded over fsdp.
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/table", ("vocab", None)),
    (r"lm_head/w", (("fsdp",), "vocab")),
    (r"(attn|shared_attn)/wq", (("fsdp",), "heads")),
    (r"(attn|shared_attn)/wk", (("fsdp",), "kv_heads")),
    (r"(attn|shared_attn)/wv", (("fsdp",), "kv_heads")),
    (r"(attn|shared_attn)/wo", ("heads", ("fsdp",))),
    (r"(attn|shared_attn)/[bq]k?_bias", ("heads",)),
    (r"moe/router", (None, "expert")),
    # EP owns the model axis for expert weights; the inner dims use fsdp
    # (expert + mlp would double-book the axis)
    (r"moe/w_gate", ("expert", ("fsdp",), None)),
    (r"moe/w_up", ("expert", ("fsdp",), None)),
    (r"moe/w_down", ("expert", None, ("fsdp",))),
    (r"(mlp|shared_mlp|shared_expert)/w_gate", (("fsdp",), "mlp")),
    (r"(mlp|shared_mlp|shared_expert)/w_up", (("fsdp",), "mlp")),
    (r"(mlp|shared_mlp|shared_expert)/w_down", ("mlp", ("fsdp",))),
    (r"(mlstm|slstm)/w_(q|k|v|o|z)", (("fsdp",), "heads")),
    (r"(mlstm|slstm)/w_proj_(up|gate)", (("fsdp",), "mlp")),
    (r"(mlstm|slstm)/w_proj_down", ("mlp", ("fsdp",))),
    (r"mamba/w_in", (("fsdp",), "heads")),
    (r"mamba/w_(x|z|b|c|dt)", (("fsdp",), "heads")),
    (r"mamba/w_out", ("heads", ("fsdp",))),
    (r"mamba/conv", (None, None, "heads")),
]


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = mesh_axes(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for e in entry:
            n *= sizes[e]
        return n
    return sizes[entry]


def fit_spec(phys: list, shape, mesh) -> Spec:
    """Drop spec entries whose mesh-axis product does not divide the dim
    (an exact layout needs it: a 49155 vocab or 24 kv heads cannot shard
    on a 16-way axis)."""
    if mesh is None:
        return Spec(*phys)
    return Spec(*(None if entry is not None
                  and dim % _axis_size(mesh, entry) != 0 else entry
                  for dim, entry in zip(shape, phys)))


def _padded(phys: list, ndim: int) -> list:
    """Right-align ``phys`` on ``ndim`` dims: leading (stacked layers /
    groups) dims padded with None, surplus entries cut."""
    return ([None] * (ndim - len(phys)) + phys)[:ndim]


def spec_for_param(path: str, shape, *, scanned: bool,
                   rules: AxisRules) -> Spec:
    """Resolve the spec of one parameter."""
    ndim = len(shape)
    for pat, logical in PARAM_RULES:
        if re.search(pat, path):
            phys = [None if name is None
                    else rules.rules.get("fsdp") if isinstance(name, tuple)
                    else rules.rules.get(name)
                    for name in logical]
            return fit_spec(_padded(phys, ndim), shape, rules.mesh)
    # default: replicate (norm scales, biases, small tables)
    return Spec(*([None] * ndim))


def param_specs(params, rules: AxisRules, *, scanned_prefixes=("layers",)):
    """A spec tree matching ``params`` (tensors, meta tensors or anything
    with a ``shape``)."""

    def leaf_spec(path, leaf):
        scanned = any(path.startswith(pre) for pre in scanned_prefixes)
        return spec_for_param(path, tuple(leaf.shape), scanned=scanned,
                              rules=rules)

    return map_with_path(leaf_spec, params)


# ---------------------------------------------------------------------------
# decode-cache partitioning (KV caches + recurrent states)
# ---------------------------------------------------------------------------

_KV_LOGICAL = ("batch", "seq", "kv_heads", None)

CACHE_RULES: list[tuple[str, tuple]] = [
    (r"(shared_kv|block\d+)/[kv]$", _KV_LOGICAL),
    (r"mlstm/C", ("batch", "heads", None, None)),
    (r"mlstm/n", ("batch", "heads", None)),
    (r"mlstm/m", ("batch", "heads")),
    (r"slstm/(c|n|h)", ("batch", None)),
    (r"slstm/m", ("batch", "heads")),
    (r"mamba/ssm", ("batch", "heads", None, None)),
    (r"mamba/conv", ("batch", None, "mlp")),
    (r"tail/ssm", ("batch", "heads", None, None)),
    (r"tail/conv", ("batch", None, "mlp")),
]


def cache_specs(cache, rules: AxisRules):
    """Spec tree for a decode cache (right-aligned logical rules, leading
    stacked-layer dims padded with None)."""

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        for pat, logical in CACHE_RULES:
            if not re.search(pat, path):
                continue
            phys = [rules.rules.get(n) if n is not None else None
                    for n in logical]
            spec = fit_spec(_padded(phys, ndim), shape, rules.mesh)
            if logical == _KV_LOGICAL:
                # KV cache: if the heads dim cannot take the model axis
                # (e.g. 8 or 24 kv heads on a 16-way axis), split the
                # *sequence* dim over it instead (FlashDecoding-style):
                # scores contract seq, and a partial-sum all-reduce joins
                # them. Otherwise a 32k/500k cache replicates.
                entries = list(spec)
                model_ax = rules.rules.get("kv_heads")
                used = {e for e in entries if e is not None}
                seq_dim = ndim - 3
                if (model_ax is not None and model_ax not in used
                        and entries[seq_dim] is None
                        and shape[seq_dim] % _axis_size(
                            rules.mesh, model_ax) == 0):
                    entries[seq_dim] = model_ax
                    spec = Spec(*entries)
            return spec
        return Spec(*([None] * ndim))

    return map_with_path(leaf_spec, cache)


# ---------------------------------------------------------------------------
# DTensor layouts
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a
    mesh dim named in the entry of tensor dim d is ``Shard(d)``, any other
    ``Replicate()``. A tuple entry shards its dim over its mesh dims major
    to minor, which DTensor reads in mesh order, so the tuple must follow
    it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """``tree``'s tensor leaves as DTensors on ``mesh``, each laid out by
    its spec in ``specs`` (``param_specs`` / ``cache_specs`` /
    ``CellShardings``' trees; a spec where ``tree`` has a subtree lays out
    every leaf below it); every rank passes the same full values (the
    reference's ``device_put`` onto ``NamedSharding``s). A leaf already a
    DTensor is redistributed. On a one-rank mesh every shard is the whole
    tensor: the DTensor wraps the leaf's own storage, no copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    register_dtensor_rules()

    def put(leaf, spec):
        want = placements(spec, mesh)
        if isinstance(leaf, DTensor):
            if tuple(leaf.placements) == want:
                return leaf
            return leaf.redistribute(mesh, want)
        if mesh.size() == 1:
            return DTensor.from_local(leaf.detach(), mesh, want,
                                      run_check=False)
        return distribute_tensor(leaf.detach(), mesh, want)

    return tree_map(lambda spec, sub: tree_map(lambda x: put(x, spec), sub),
                    specs, tree, is_leaf=lambda x: isinstance(x, Spec))


def unshard(x, *dims: int):
    """``x`` with tensor dims ``dims`` whole on every rank: a DTensor
    sharded (or partial) along one of them is redistributed to
    ``Replicate()`` on those mesh dims, the others kept. For an op whose
    DTensor rule is missing or wrong along those dims (a gather along a
    split vocab; a view's merge, ``mergeable``). A plain tensor is
    returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    nd = x.dim()
    dims = {d % nd for d in dims}
    want = tuple(Replicate() if not isinstance(p, Shard)
                 or p.dim % nd in dims else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def mergeable(x, *groups: tuple[int, ...]):
    """``x`` ready for a view that merges each of ``groups`` (dims of
    ``x``, in the order the merge lays them out, major first; a dim that
    the view first splits named for each of its parts) into one dim.
    torch 2.11's DTensor keeps a split through such a merge only on the
    group's leading dim and has no layout for the rest, so every dim
    behind a group's first is gathered whole (``unshard``) and the leading
    ones stay split. Where the gathered dim is the heads (attention's
    grouped products) every rank of the model axis computes every head:
    on a real model axis the attention runs replicated, not tensor
    parallel as under GSPMD (ROADMAP 7b)."""
    return unshard(x, *{d for group in groups for d in group[1:]})


def is_distributed(tree) -> bool:
    """Whether any leaf of ``tree`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(leaf, DTensor)
               for _, leaf in leaves_with_path(tree))


def full(x):
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


_REGISTERED = False


def register_dtensor_rules() -> None:
    """Give the port's custom ops (``core.estimator``) a DTensor layout:
    each has none of its own, so its operands are redistributed to
    ``Replicate()`` at the call and its results are replicated, which is
    what GSPMD inserts around an op it cannot partition. Registered once,
    on the first ``distribute``."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    from repro_torch.core import estimator  # noqa: F401  (the ops)

    ops = torch.ops.repro_torch
    for name in ("add_any", "select_parts", "take_parts", "scatter_add",
                 "silu_vjp", "softplus_vjp", "dynamic_slice",
                 "dynamic_update_slice_"):
        op = getattr(ops, name).default
        n_out = len(op._schema.returns)

        def replicate_all(*args, _n_out=n_out, **kwargs):
            # tensor arguments arrive as specs (with placements)
            ins = [Replicate() if hasattr(a, "placements") else None
                   for a in args]
            return [([Replicate()] * _n_out, ins)]

        register_sharding(op)(replicate_all)
    _REGISTERED = True
