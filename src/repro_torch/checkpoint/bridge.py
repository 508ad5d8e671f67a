"""Parameters and KV pools from the reference's layouts.

``params_from_reference`` takes the reference's parameters flattened the
way ``repro.checkpoint.ckpt`` saves them — '/'-joined key paths such as
``layers/block0/attn/wq``, the stack of units on a leading axis of each
``layers/...`` leaf — and returns a :class:`DecoderLM` holding the same
values; ``stacked_from_reference`` returns them as the reference's own
tree instead (``transformer.param_tree``), what ``decode_step``,
``hidden_states`` and a mapped step take, and ``opt_state_from_reference``
the reference's AdamW state for that tree (so that both frameworks take
one step from the same state), and ``model_from_stacked`` is the inverse of
``DecoderLM.stacked_params``: a module holding a tree's values, so that
the module and the mapped step compute from the same weights.
``kv_pool_from_reference`` takes the reference's paged KV pool
and returns the port's pool dict, bit for bit. ``lenet_params_from_reference``
takes the reference's LeNet parameter dict and returns the port's, whose
layout is the same. Plain numpy in, so all three read saved arrays as well
as live ones.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.lenet5 import CONFIG as LENET5, LeNetConfig
from repro_torch.core import quant
from repro_torch.models import lenet
from repro_torch.models.transformer import (DecoderLM, leaf_at,
                                            leaf_layout, leaf_shapes,
                                            param_tree)
from repro_torch.optim.optimizers import BLOCK as OPT_BLOCK


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bit for bit. A bfloat16 leaf arrives as an
    ``ml_dtypes`` array that ``torch.from_numpy`` rejects: its bits go
    across as uint16 and are viewed as bfloat16."""
    arr = np.array(arr)                 # an owned, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if arr.dtype == np.uint16:          # fp16-grid codes, held as int16
        return torch.from_numpy(arr.view(np.int16))
    return torch.from_numpy(arr)


def params_from_reference(flat: Mapping[str, np.ndarray], cfg: ArchConfig,
                          device: str | torch.device | None = None
                          ) -> DecoderLM:
    """A ``DecoderLM`` on ``device`` (CUDA by default) whose parameters
    equal the reference's flattened ``flat``. Raises on a missing key, a
    key left over, or a shape or dtype that does not match."""
    layout = leaf_layout(cfg)
    missing = set(layout) - set(flat)
    if missing:
        raise ValueError(f"reference leaves missing: {sorted(missing)}")
    extra = set(flat) - set(layout)
    if extra:
        raise ValueError(f"reference leaves not ported: {sorted(extra)}")
    model = DecoderLM(cfg, device=device)
    want: dict[str, tuple[torch.Tensor, np.ndarray]] = {}
    for key, (dims, shape, owners) in layout.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape[:len(dims)]) != dims:
            raise ValueError(f"{key}: stacked {arr.shape[:len(dims)]}, "
                             f"config has {dims}")
        rows = arr.reshape(-1, *arr.shape[len(dims):]) if dims else [arr]
        for i, path in enumerate(owners):
            want[f"{key}[{i}]" if dims else key] = (
                model.get_parameter(path), rows[i])
    with torch.no_grad():
        for key, (param, arr) in want.items():
            t = _to_torch(arr)
            if t.shape != param.shape or t.dtype != param.dtype:
                raise ValueError(f"{key}: {t.dtype} {tuple(t.shape)}, port "
                                 f"expects {param.dtype} "
                                 f"{tuple(param.shape)}")
            param.copy_(t)
    return model


def stacked_from_reference(flat: Mapping[str, np.ndarray], cfg: ArchConfig,
                           device: str | torch.device | None = None
                           ) -> dict:
    """The reference's flattened parameters ``flat`` as its tree
    (``transformer.param_tree``, the layers stacked), bit for bit, on
    ``device`` (CUDA by default). Raises on a missing or extra key, or a
    shape or dtype that does not match ``cfg``."""
    want = leaf_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"reference leaves {sorted(set(flat) ^ set(want))}"
                         f" differ from the port's tree")
    dev, dtype = resolve_device(device), torch_dtype(cfg.dtype)
    out = {}
    for key, shape in want.items():
        t = _to_torch(flat[key])
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{key}: {t.dtype} {tuple(t.shape)}, port "
                             f"expects {dtype} {shape}")
        out[key] = t.to(dev)
    return param_tree(out)


def opt_state_from_reference(flat: Mapping[str, np.ndarray], cfg: ArchConfig,
                             device: str | torch.device | None = None
                             ) -> dict:
    """The reference's AdamW state, flattened as ``repro.checkpoint.ckpt``
    saves it (``step``, ``m/<param path>``, ``v/<param path>``; on the
    int8 grid each moment a ``.../q`` int8 [blocks, 256] and
    ``.../scale`` float32 [blocks, 1] pair), as the port's state tree
    (``optim.adamw_init``'s, for ``stacked_from_reference``'s parameters),
    bit for bit, on ``device`` (CUDA by default). Raises on a missing or
    extra key, or a shape or dtype that does not match ``cfg`` and its
    ``opt_state_dtype``."""
    state_dtype = cfg.opt_state_dtype
    want: dict[str, tuple[tuple, torch.dtype]] = {"step": ((), torch.int32)}
    for moment in ("m", "v"):
        for key, shape in leaf_shapes(cfg).items():
            if state_dtype == "int8":
                blocks = -(-math.prod(shape) // OPT_BLOCK)
                want[f"{moment}/{key}/q"] = ((blocks, OPT_BLOCK), torch.int8)
                want[f"{moment}/{key}/scale"] = ((blocks, 1), torch.float32)
            else:
                want[f"{moment}/{key}"] = (shape, torch_dtype(state_dtype))
    if set(flat) != set(want):
        raise ValueError(f"reference state leaves "
                         f"{sorted(set(flat) ^ set(want))} differ from the "
                         f"port's tree")
    dev = resolve_device(device)
    out = {}
    for key, (shape, dtype) in want.items():
        t = _to_torch(flat[key])
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{key}: {t.dtype} {tuple(t.shape)}, port "
                             f"expects {dtype} {shape}")
        out[key] = t.to(dev)
    tree = param_tree({k: v for k, v in out.items() if k != "step"})
    return {"m": tree["m"], "v": tree["v"], "step": out["step"]}


def model_from_stacked(tree: Mapping, cfg: ArchConfig,
                       device: str | torch.device | None = None
                       ) -> DecoderLM:
    """The inverse of ``DecoderLM.stacked_params``: a ``DecoderLM`` on
    ``device`` (CUDA by default) whose parameters equal the tree's."""
    model = DecoderLM(cfg, device=device)
    with torch.no_grad():
        for key, (dims, shape, owners) in leaf_layout(cfg).items():
            rows = leaf_at(tree, key).reshape(-1, *shape)
            for i, path in enumerate(owners):
                model.get_parameter(path).copy_(rows[i])
    return model


def kv_pool_from_reference(ref_cache: Mapping, kv_dtype: str,
                           device: str | torch.device | None = None
                           ) -> dict[str, torch.Tensor]:
    """The port's KV pool (``DecoderLM.init_paged_cache`` layout) holding
    the reference's pool ``{"layers": {"block<i>": {"k", "v"[, "k_scale",
    "v_scale"]}}}`` — one site per block of a unit, ``block0`` …
    ``block<n-1>``, leaves stacked ``[n_units, num_blocks, block_size, G,
    head_dim]`` — bit for bit, on ``device`` (CUDA by default): layer
    ``u·n + i`` of the pool is block ``i`` of unit ``u``. The fp16 grid's
    uint16 codes arrive as int16 holding the same bits (``core.quant``).
    Raises on other sites, leaves or code dtypes."""
    layers = ref_cache["layers"]
    n = len(layers)
    if set(layers) != {f"block{i}" for i in range(n)}:
        raise ValueError(f"reference pool sites {sorted(layers)}: the port "
                         f"pages one attention site per block, block0 … "
                         f"block{n - 1}")
    s = quant.spec(kv_dtype)
    names = {"k", "v"} if s.name == "fp32" else {"k", "k_scale", "v",
                                                 "v_scale"}
    for site in layers.values():
        if set(site) != names:
            raise ValueError(f"reference pool leaves {sorted(site)}, "
                             f"kv_dtype {s.name!r} has {sorted(names)}")
    dev = resolve_device(device)
    pool = {}
    for name in sorted(names):
        blocks = [_to_torch(layers[f"block{i}"][name]) for i in range(n)]
        # [n_units, n, ...] -> layer u·n + i
        pool[name] = torch.stack(blocks, 1).flatten(0, 1).to(dev)
        if name in ("k", "v") and s.name != "fp32" and (
                pool[name].dtype != quant.code_dtype(s)):
            raise ValueError(
                f"{name}: {np.asarray(layers['block0'][name]).dtype} codes,"
                f" kv_dtype {s.name!r} stores {quant.code_dtype(s)}")
    return pool


def lenet_params_from_reference(params: Mapping[str, Mapping[str, np.ndarray]],
                                cfg: LeNetConfig = LENET5,
                                device: str | torch.device | None = None
                                ) -> dict:
    """The port's LeNet parameters (``models.lenet.init_lenet``'s layout:
    HWIO conv weights, ``(fin, fout)`` fc weights) holding the reference's
    ``{"conv1": {"w", "b"}, ..., "fc3": {"w", "b"}}`` bit for bit, on
    ``device`` (CUDA by default). Raises on a missing or extra layer or
    leaf, or a shape or dtype that does not match ``cfg``."""
    want = lenet.init_lenet(0, cfg, device="meta")
    if set(params) != set(want):
        raise ValueError(f"reference LeNet layers {sorted(params)}, the "
                         f"port has {sorted(want)}")
    dev = resolve_device(device)
    out: dict = {}
    for layer, leaves in want.items():
        if set(params[layer]) != set(leaves):
            raise ValueError(f"{layer}: leaves {sorted(params[layer])}, want"
                             f" {sorted(leaves)}")
        out[layer] = {}
        for name, like in leaves.items():
            t = _to_torch(params[layer][name])
            if t.shape != like.shape or t.dtype != like.dtype:
                raise ValueError(f"{layer}/{name}: {t.dtype} "
                                 f"{tuple(t.shape)}, port expects "
                                 f"{like.dtype} {tuple(like.shape)}")
            out[layer][name] = t.to(dev)
    return out
