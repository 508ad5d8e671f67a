"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. There is no silent CPU fallback — asking for CUDA (the
    default) on a host without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default — pass device='cpu' to run its plain PyTorch path")
        if dev.index is None:       # "cuda" and "cuda:<current>" compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
