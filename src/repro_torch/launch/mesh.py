"""Mesh construction on ``torch.distributed``: the port of
``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group. A production pod is a (16, 16) ``("data", "model")`` mesh;
multi-pod adds a leading ``"pod"`` axis. Elastic scaling passes ``pods``
to grow the pod axis without touching model code: the ``"pod"`` axis only
ever carries batch (and optionally pipeline stages), so reshaping the
fleet re-binds the same logical rules.

A mesh lives on the ranks of the default process group. Under
``torchrun`` the group comes from its environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``); with none, ``make_host_mesh`` starts a
one-rank group on the entry's device (NCCL on CUDA, gloo on the CPU)
over a ``FileStore``, so no TCP port is opened; ``release_group`` ends
it and removes the store's directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

_STORE_DIR: str | None = None      # the FileStore of the group started here


def _ensure_group(device: torch.device) -> None:
    """Start the default process group if there is none: torchrun's
    environment when set, else one rank over a ``FileStore``."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    global _STORE_DIR
    _STORE_DIR = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(_STORE_DIR, "store"), 1),
        rank=0, world_size=1)


def release_group() -> None:
    """End the default process group, and remove the ``FileStore``
    directory if this module started the group."""
    global _STORE_DIR
    if dist.is_initialized():
        dist.destroy_process_group()
    if _STORE_DIR is not None:
        shutil.rmtree(_STORE_DIR, ignore_errors=True)
        _STORE_DIR = None


def _mesh(device: torch.device, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, pods: int = 2,
                         device: str | torch.device | None = None):
    """The (16, 16) ``("data", "model")`` pod mesh, or (pods, 16, 16)
    with ``"pod"`` in front, over the default group's ranks, which must
    number exactly that many (the group started first if there is
    none)."""
    shape = (pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    dev = resolve_device(device)
    _ensure_group(dev)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process "
                           f"group has {dist.get_world_size()}")
    return _mesh(dev, shape, axes)


def make_host_mesh(model_axis: int = 1, *,
                   device: str | torch.device | None = None):
    """Whatever ranks the process group has (tests / examples): a
    (world // model_axis, model_axis) ``("data", "model")`` mesh, the
    group started first if there is none (module docstring)."""
    dev = resolve_device(device)
    _ensure_group(dev)
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model_axis}")
    return _mesh(dev, (n // model_axis, model_axis), ("data", "model"))
