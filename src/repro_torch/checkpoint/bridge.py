"""Parameters and KV pools from the reference's layouts.

``params_from_reference`` takes the reference's parameters flattened the
way ``repro.checkpoint.ckpt`` saves them — '/'-joined key paths such as
``layers/block0/attn/wq``, the layer stack on a leading axis of each
``layers/...`` leaf — and returns a :class:`DecoderLM` holding the same
values. ``kv_pool_from_reference`` takes the reference's paged KV pool
and returns the port's pool dict, bit for bit. ``lenet_params_from_reference``
takes the reference's LeNet parameter dict and returns the port's, whose
layout is the same. Plain numpy in, so all three read saved arrays as well
as live ones.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.lenet5 import CONFIG as LENET5, LeNetConfig
from repro_torch.core import quant
from repro_torch.models import lenet
from repro_torch.models.transformer import DecoderLM


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
    model = DecoderLM(cfg, device=device)
    want: dict[str, tuple[torch.Tensor, np.ndarray]] = {}
    want["embed/table"] = (model.embed.table, flat["embed/table"])
    want["final_norm/scale"] = (model.final_norm.scale,
                                flat["final_norm/scale"])
    want["lm_head/w"] = (model.lm_head.w, flat["lm_head/w"])
    names = {"norm1/scale": lambda b: b.norm1.scale,
             "norm2/scale": lambda b: b.norm2.scale,
             "attn/wq": lambda b: b.attn.wq, "attn/wk": lambda b: b.attn.wk,
             "attn/wv": lambda b: b.attn.wv, "attn/wo": lambda b: b.attn.wo,
             "mlp/w_gate": lambda b: b.mlp.w_gate,
             "mlp/w_up": lambda b: b.mlp.w_up,
             "mlp/w_down": lambda b: b.mlp.w_down}
    for name, get in names.items():
        key = f"layers/block0/{name}"
        stacked = flat[key]
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"{key}: {stacked.shape[0]} stacked layers, "
                             f"config has {cfg.n_layers}")
        for i, blk in enumerate(model.layers):
            want[f"{key}[{i}]"] = (get(blk), stacked[i])
    extra = set(flat) - {k.split("[")[0] for k in want}
    if extra:
        raise ValueError(f"reference leaves not ported: {sorted(extra)}")
    with torch.no_grad():
        for key, (param, arr) in want.items():
            t = _to_torch(arr)
            if t.shape != param.shape or t.dtype != param.dtype:
                raise ValueError(f"{key}: {t.dtype} {tuple(t.shape)}, port "
                                 f"expects {param.dtype} "
                                 f"{tuple(param.shape)}")
            param.copy_(t)
    return model


def kv_pool_from_reference(ref_cache: Mapping, kv_dtype: str,
                           device: str | torch.device | None = None
                           ) -> dict[str, torch.Tensor]:
    """The port's KV pool (``DecoderLM.init_paged_cache`` layout) holding
    the reference's pool ``{"layers": {"block0": {"k", "v"[, "k_scale",
    "v_scale"]}}}`` — leaves stacked ``[n_layers, num_blocks, block_size,
    G, head_dim]`` — bit for bit, on ``device`` (CUDA by default). The
    fp16 grid's uint16 codes arrive as int16 holding the same bits
    (``core.quant``). Raises on other sites, leaves or code dtypes."""
    layers = ref_cache["layers"]
    if set(layers) != {"block0"}:
        raise ValueError(f"reference pool sites {sorted(layers)}: the port "
                         f"pages one attention site per layer (block0)")
    site = layers["block0"]
    s = quant.spec(kv_dtype)
    names = {"k", "v"} if s.name == "fp32" else {"k", "k_scale", "v",
                                                 "v_scale"}
    if set(site) != names:
        raise ValueError(f"reference pool leaves {sorted(site)}, kv_dtype "
                         f"{s.name!r} has {sorted(names)}")
    dev = resolve_device(device)
    pool = {name: _to_torch(site[name]).to(dev) for name in sorted(names)}
    for name in ("k", "v"):
        if s.name != "fp32" and pool[name].dtype != quant.code_dtype(s):
            raise ValueError(f"{name}: {np.asarray(site[name]).dtype} codes,"
                             f" kv_dtype {s.name!r} stores "
                             f"{quant.code_dtype(s)}")
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
