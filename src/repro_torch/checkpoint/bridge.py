"""Parameters from the reference's checkpoint layout.

``params_from_reference`` takes the reference's parameters flattened the
way ``repro.checkpoint.ckpt`` saves them — '/'-joined key paths such as
``layers/block0/attn/wq``, the layer stack on a leading axis of each
``layers/...`` leaf — and returns a :class:`DecoderLM` holding the same
values. Plain numpy in, so it reads a saved ``.npz`` as well as a live
flattening.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import DecoderLM


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bit for bit. A bfloat16 leaf arrives as an
    ``ml_dtypes`` array that ``torch.from_numpy`` rejects: its bits go
    across as uint16 and are viewed as bfloat16."""
    arr = np.array(arr)                 # an owned, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
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
