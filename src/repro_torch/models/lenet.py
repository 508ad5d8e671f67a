"""LeNet-5-type CNN — the paper's benchmark network (§4.1): the port of
``repro.models.lenet``.

The public layout is the reference's: NHWC images, HWIO conv weights,
``(fin, fout)`` fc weights and the same parameter dict keys, so the
reference's parameters cross over unchanged
(``repro_torch.checkpoint.lenet_params_from_reference``).

``lenet_apply`` is written so that its aten graph holds the reference
jaxpr's costed nodes in the same order, which the mapper reads
(``repro_torch.mapper.graph``): each convolution is called without a
bias and its bias added as its own ``add``; fc layers are ``x @ w + b``
(``F.linear`` would fuse the two into one ``addmm``); and the 2x2 average
pool is a reshape-sum followed by ``/ 4.0``, so that its ``div`` node
appears as in the reference's ``_avg_pool2``. The layout changes between
NHWC and PyTorch's NCHW convolution are views the mapper does not cost.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device, torch_dtype
from repro_torch.configs.lenet5 import CONFIG, LeNetConfig


def init_lenet(seed: int = 0, cfg: LeNetConfig = CONFIG, *,
               device: str | torch.device | None = None) -> dict:
    """Parameters on ``device`` (CUDA by default), drawn from a seeded
    ``torch.Generator``: the reference's distributions (He-normal weights,
    zero biases), not its numbers. On the meta device nothing is drawn."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    c1, c2 = cfg.conv_channels
    ksz = cfg.kernel
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))

    def normal(shape, fan):
        if gen is None:
            return torch.empty(shape, dtype=dt, device=dev)
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * (2.0 / fan) ** 0.5).to(dt)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=dev)

    # spatial sizes: 28 -conv5-> 24 -pool-> 12 -conv5-> 8 -pool-> 4
    flat = c2 * 4 * 4
    f1, f2 = cfg.fc_dims
    return {
        "conv1": {"w": normal((ksz, ksz, 1, c1), ksz * ksz), "b": zeros(c1)},
        "conv2": {"w": normal((ksz, ksz, c1, c2), c1 * ksz * ksz),
                  "b": zeros(c2)},
        "fc1": {"w": normal((flat, f1), flat), "b": zeros(f1)},
        "fc2": {"w": normal((f1, f2), f1), "b": zeros(f2)},
        "fc3": {"w": normal((f2, cfg.n_classes), f2),
                "b": zeros(cfg.n_classes)},
    }


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 convolution of NHWC ``x`` with HWIO ``w``, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).sum((2, 4)) / 4.0


def lenet_apply(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: [B, 28, 28, 1] -> logits [B, 10]."""
    x = _conv(images, params["conv1"]["w"]) + params["conv1"]["b"]
    x = _avg_pool2(torch.tanh(x))
    x = _conv(x, params["conv2"]["w"]) + params["conv2"]["b"]
    x = _avg_pool2(torch.tanh(x))
    x = x.reshape(x.shape[0], -1)
    x = torch.tanh(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = torch.tanh(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["fc3"]["w"] + params["fc3"]["b"]


def n_params(params: dict) -> int:
    return sum(p.numel() for layer in params.values() for p in layer.values())
