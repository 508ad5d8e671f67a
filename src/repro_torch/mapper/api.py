"""One-call mapping entry points: the port of ``repro.mapper.api``.

``map_lenet`` traces the paper's LeNet on meta tensors (nothing is
allocated) and compiles it into a placed, cost-rolled static schedule;
``compile_lenet`` goes one step further, schedule ->
:func:`repro_torch.mapper.compile.compile_schedule` -> a
``CompiledProgram`` running the forward pass *through the placement* on
the port's PIM kernels.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: ``kind="train"``, ``partitions``, ``expand_scans=True``,
``weight_dtype`` / ``act_dtype`` other than ``"fp32"``, and
``map_arch`` / ``compile_arch``.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch._device import resolve_device
from repro_torch.configs.lenet5 import CONFIG
from repro_torch.mapper import compile as compile_mod
from repro_torch.mapper import placement as placement_mod
from repro_torch.mapper import schedule as schedule_mod
from repro_torch.mapper.hardware import PIMHierarchy
from repro_torch.models import lenet


def abstract_like(tree):
    """Meta-device stand-ins for a pytree of tensors — the 'trace without
    allocating' idiom of the mapper (the reference's
    ``ShapeDtypeStruct``s)."""
    return pytree.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


def map_lenet(kind: str = "serve", *, batch: int = 4,
              hierarchy: PIMHierarchy | None = None,
              policy: placement_mod.PlacementPolicy | None = None,
              tech: str = "proposed",
              weight_dtype: str = "fp32",
              act_dtype: str = "fp32",
              partitions: int | None = None,
              expand_scans: bool = False) -> schedule_mod.Schedule:
    """Map the paper's LeNet: ``serve`` = forward pass at ``batch``."""
    if kind == "train":
        raise NotImplementedError(
            "kind='train' is not ported yet (ROADMAP.md, queue item 3.1: "
            "the LeNet training slice)")
    if kind != "serve":
        raise ValueError(f"kind must be 'train' or 'serve', got {kind!r}")
    params = lenet.init_lenet(0, CONFIG, device="meta")
    images = torch.empty((batch, CONFIG.in_hw, CONFIG.in_hw, 1),
                         dtype=torch.float32, device="meta")
    return schedule_mod.build_schedule(
        lenet.lenet_apply, params, images,
        hierarchy=hierarchy, policy=policy, tech=tech,
        weight_dtype=weight_dtype, act_dtype=act_dtype,
        partitions=partitions, expand_scans=expand_scans)


def compile_lenet(kind: str = "serve", *, batch: int = 4,
                  hierarchy: PIMHierarchy | None = None,
                  policy: placement_mod.PlacementPolicy | None = None,
                  tech: str = "proposed", weight_dtype: str = "fp32",
                  act_dtype: str = "fp32",
                  partitions: int | None = None,
                  device: str | torch.device | None = None
                  ) -> compile_mod.CompiledProgram:
    """Map the paper's LeNet and compile it to a program that runs on
    ``device`` (CUDA by default): ``prog(params, images)`` -> logits."""
    dev = resolve_device(device)
    sched = map_lenet(kind, batch=batch, hierarchy=hierarchy,
                      policy=policy, tech=tech, weight_dtype=weight_dtype,
                      act_dtype=act_dtype, partitions=partitions)
    return compile_mod.compile_schedule(sched, device=dev)


def map_arch(*args, **kwargs):
    raise NotImplementedError(
        "map_arch is not ported yet (ROADMAP.md, queue item 3.2: the "
        "decoder LM through the mapper)")


def compile_arch(*args, **kwargs):
    raise NotImplementedError(
        "compile_arch is not ported yet (ROADMAP.md, queue item 3.2: the "
        "decoder LM through the mapper)")
