"""One-call mapping entry points: the port of ``repro.mapper.api``.

``map_lenet`` traces the paper's LeNet on meta tensors (nothing is
allocated) and compiles it into a placed, cost-rolled static schedule;
``compile_lenet`` goes one step further, schedule ->
:func:`repro_torch.mapper.compile.compile_schedule` -> a
``CompiledProgram`` running the forward pass *through the placement* on
the port's PIM kernels. ``map_arch`` / ``compile_arch`` do the same for a
registered architecture's step. ``kind="serve"``: one decode token
against a ``seq_len`` contiguous cache, its layer stack folded into the
reference's scanned nodes; the compiled step runs the nodes outside the
stack on the kernels (the LM head on K1, or K5 on a quantized grid; the
final norm's MACs on K3) and those inside natively, as the reference's
lowering binds the placed ops of a scan body. ``kind="train"``: one
AdamW step; every product lies in a folded loop (the layer stack, its
transpose, the cross-entropy's chunks), so the compiled step reaches K3
alone, for the eltwise nodes outside them (the rope tables, the final
norm and its VJP, the update).

``weight_dtype`` stores the placed weights on a reduced-precision grid
(``"int8"`` / ``"fp8_e4m3"`` / ``"fp8_e5m2"`` / ``"fp16"``; K5 in the
compiled program), ``act_dtype`` prices activation transfers at a grid's
width, and ``ideal_provision`` picks the ideal bound's footprint (see
``build_schedule``).

``partitions=K`` cuts the step into K pipeline partitions
(``placement.partition``) and ``expand_scans=True`` first expands the
folded layer stack into resident per-layer copies where the subarray
budget allows (``graph.expand_graph``), so the cuts can land inside it;
``compile_*`` with ``partitions`` returns a ``PartitionedProgram``, one
stage program per partition (``compile.compile_partitioned``), with
``streams`` the ring of CUDA streams its asynchronous drivers run the
stages on.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.configs.base import ArchConfig, ShapeSpec
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


def map_lenet(kind: str = "serve", *, batch: int = 4, lr: float = 0.05,
              hierarchy: PIMHierarchy | None = None,
              policy: placement_mod.PlacementPolicy | None = None,
              tech: str = "proposed",
              weight_dtype: str = "fp32",
              act_dtype: str = "fp32",
              ideal_provision: str = "fp32",
              partitions: int | None = None,
              expand_scans: bool = False) -> schedule_mod.Schedule:
    """Map the paper's LeNet at ``batch``: ``serve`` = the forward pass,
    ``train`` = one SGD step at ``lr`` on the cross-entropy loss,
    ``train_step(params, images, labels) -> (new_params, loss)``."""
    if kind not in ("train", "serve"):
        raise ValueError(f"kind must be 'train' or 'serve', got {kind!r}")
    params = lenet.init_lenet(0, CONFIG, device="meta")
    images = torch.empty((batch, CONFIG.in_hw, CONFIG.in_hw, 1),
                         dtype=torch.float32, device="meta")
    common = dict(hierarchy=hierarchy, policy=policy, tech=tech,
                  weight_dtype=weight_dtype, act_dtype=act_dtype,
                  ideal_provision=ideal_provision, partitions=partitions,
                  expand_scans=expand_scans)
    if kind == "serve":
        return schedule_mod.build_schedule(lenet.lenet_apply, params, images,
                                           **common)
    labels = torch.empty((batch,), dtype=torch.int32, device="meta")

    def train_step(params, images, labels):
        grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
            params, images, labels)
        return tree_map(lambda p, g: p - lr * g, params, grads), loss

    return schedule_mod.build_schedule(train_step, params, images, labels,
                                       **common)


def _compile(sched: schedule_mod.Schedule, device, streams):
    """A program of ``sched``: partitioned where it has partitions."""
    if sched.partitions:
        return compile_mod.compile_partitioned(sched, device=device,
                                               streams=streams)
    return compile_mod.compile_schedule(sched, device=device)


def compile_lenet(kind: str = "serve", *, batch: int = 4, lr: float = 0.05,
                  hierarchy: PIMHierarchy | None = None,
                  policy: placement_mod.PlacementPolicy | None = None,
                  tech: str = "proposed", weight_dtype: str = "fp32",
                  act_dtype: str = "fp32", ideal_provision: str = "fp32",
                  partitions: int | None = None,
                  expand_scans: bool = False,
                  device: str | torch.device | None = None, streams=None):
    """Map the paper's LeNet and compile it to a program that runs on
    ``device`` (CUDA by default): ``prog(params, images)`` -> logits, or
    for ``train`` ``prog(params, images, labels)`` -> (params, loss). A
    ``CompiledProgram``, or with ``partitions`` a ``PartitionedProgram``
    (its stages on ``streams``)."""
    dev = resolve_device(device)
    sched = map_lenet(kind, batch=batch, lr=lr, hierarchy=hierarchy,
                      policy=policy, tech=tech, weight_dtype=weight_dtype,
                      act_dtype=act_dtype, ideal_provision=ideal_provision,
                      partitions=partitions, expand_scans=expand_scans)
    return _compile(sched, dev, streams)


def map_arch(name: str, kind: str = "train", *, seq_len: int = 128,
             batch: int = 1, smoke: bool = False,
             hierarchy: PIMHierarchy | None = None,
             policy: placement_mod.PlacementPolicy | None = None,
             tech: str = "proposed",
             weight_dtype: str = "fp32",
             act_dtype: str = "fp32",
             ideal_provision: str = "fp32",
             partitions: int | None = None,
             expand_scans: bool = False,
             config: ArchConfig | None = None) -> schedule_mod.Schedule:
    """Map one registered architecture's step, traced on meta tensors
    (the full configs map without allocating): ``kind="train"`` schedules
    one AdamW step (forward, backward and update) over a batch of
    ``batch`` sequences of ``seq_len`` tokens (rounded up to a multiple of
    ``grad_accum``); ``kind="serve"`` one decode
    step against a ``seq_len`` cache at ``batch``. ``smoke=True`` uses
    the reduced config; ``config``, where given, is mapped instead of the
    registered one (the architecture cut in depth, say);
    ``partitions`` and ``expand_scans`` as in ``build_schedule``."""
    if kind not in ("train", "serve"):
        raise ValueError(f"kind must be 'train' or 'serve', got {kind!r}")
    from repro_torch.launch import steps as steps_mod

    cfg = config or (configs.get_smoke_config(name) if smoke
                     else configs.get_config(name))
    if kind == "train" and cfg.grad_accum > 1:
        # the step scans grad_accum microbatches: keep the batch divisible
        batch = max(1, -(-batch // cfg.grad_accum)) * cfg.grad_accum
    shape = ShapeSpec(f"map_{kind}", seq_len, batch, kind)
    params = steps_mod.abstract_params(cfg)
    if kind == "train":
        args = (steps_mod.make_train_step(cfg), params,
                steps_mod.abstract_opt_state(cfg, params),
                steps_mod.input_specs(cfg, shape))
    else:
        args = (steps_mod.make_serve_step(cfg), params,
                steps_mod.abstract_cache(cfg, shape),
                *steps_mod.decode_input_specs(cfg, shape))
    return schedule_mod.build_schedule(
        *args, hierarchy=hierarchy, policy=policy, tech=tech,
        weight_dtype=weight_dtype, act_dtype=act_dtype,
        ideal_provision=ideal_provision, partitions=partitions,
        expand_scans=expand_scans)


def compile_arch(name: str, kind: str = "train", *, seq_len: int = 128,
                 batch: int = 1, smoke: bool = False,
                 hierarchy: PIMHierarchy | None = None,
                 policy: placement_mod.PlacementPolicy | None = None,
                 tech: str = "proposed", weight_dtype: str = "fp32",
                 act_dtype: str = "fp32", ideal_provision: str = "fp32",
                 partitions: int | None = None,
                 expand_scans: bool = False,
                 config: ArchConfig | None = None,
                 device: str | torch.device | None = None, streams=None):
    """Map one architecture's step and compile it to a program that runs
    on ``device`` (CUDA by default), ``params`` the reference's tree
    (``DecoderLM.stacked_params``): for ``train``, ``prog(params,
    opt_state, batch)`` -> (params, opt_state, loss), ``batch`` a
    ``TokenStream`` batch (``{"tokens", "labels"}``) as tensors; for
    ``serve``, ``prog(params, cache, token, pos)`` -> (logits, cache). A
    ``CompiledProgram``, or with ``partitions`` a ``PartitionedProgram``
    (its stages on ``streams``)."""
    sched = map_arch(name, kind, seq_len=seq_len, batch=batch, smoke=smoke,
                     hierarchy=hierarchy, policy=policy, tech=tech,
                     weight_dtype=weight_dtype, act_dtype=act_dtype,
                     ideal_provision=ideal_provision, partitions=partitions,
                     expand_scans=expand_scans, config=config)
    return _compile(sched, resolve_device(device), streams)
