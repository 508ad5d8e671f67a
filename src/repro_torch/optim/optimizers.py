"""Optimizers: SGD-momentum and AdamW with configurable state precision.
The port of ``repro.optim.optimizers``.

Functional, as the reference's: ``update`` returns new parameters and a
new state and changes nothing in place, so a train step is a pure
function the mapper can capture and replay. The arithmetic is the
reference's, operation for operation and in the same order (the mapper
prices the update's eltwise nodes in that order); leaves are visited in
the reference's sorted key order (``repro_torch._tree``).

``state_dtype`` supports:

  * ``float32``  — exact baseline
  * ``bfloat16`` — 2x smaller
  * ``int8``     — blockwise-quantized (one absmax scale per ``BLOCK``
                   elements, rounded half to even as ``jnp.round``), 4x
                   smaller
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch._tree import leaves_with_path, tree_map

BLOCK = 256

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# blockwise int8 state quantization
# ---------------------------------------------------------------------------


def _q_int8(x: torch.Tensor) -> dict:
    """Blockwise int8 quantization; shape and size are recovered from the
    matching parameter at load time."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-20)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _dq_int8(s: dict, like: torch.Tensor) -> torch.Tensor:
    flat = (s["q"].to(torch.float32) * s["scale"]).reshape(-1)
    return flat[:like.numel()].reshape(like.shape)


def _store(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q_int8(x)
    return x.to(_DTYPES[dtype])


def _load(s, dtype: str, like: torch.Tensor) -> torch.Tensor:
    if dtype == "int8":
        return _dq_int8(s, like)
    return s.to(torch.float32)


def _zero_step(params) -> torch.Tensor:
    _, leaf = next(leaves_with_path(params))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _unzip(out, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    is_tuple = lambda t: isinstance(t, tuple)   # noqa: E731
    return [tree_map(lambda t, i=i: t[i], out, is_leaf=is_tuple)
            for i in range(n)]


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------


def sgdm_init(params, state_dtype: str = "float32"):
    return {"mu": tree_map(
        lambda p: _store(torch.zeros_like(p, dtype=torch.float32),
                         state_dtype), params),
        "step": _zero_step(params)}


def sgdm_update(grads, state, params, *, lr: float, momentum: float = 0.9,
                weight_decay: float = 0.0, state_dtype: str = "float32"):
    def upd(g, p, mu_s):
        mu = _load(mu_s, state_dtype, p)
        g32 = g.to(torch.float32)
        if weight_decay:
            g32 = g32 + weight_decay * p.to(torch.float32)
        mu_new = momentum * mu + g32
        p_new = (p.to(torch.float32) - lr * mu_new).to(p.dtype)
        return _store(mu_new, state_dtype), p_new

    # grads/params lead (tensor leaves); the state tree may be deeper
    # (int8 dicts): the prefix semantics hand `upd` the subtree
    mu_new, p_new = _unzip(tree_map(upd, grads, params, state["mu"]), 2)
    return p_new, {"mu": mu_new, "step": state["step"] + 1}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, state_dtype: str = "float32"):
    def zeros(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), state_dtype)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _zero_step(params)}


def adamw_update(grads, state, params, *, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01,
                 state_dtype: str = "float32"):
    step = state["step"] + 1
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(g, p, m_s, v_s):
        g32 = g.to(torch.float32)
        m = b1 * _load(m_s, state_dtype, p) + (1 - b1) * g32
        v = b2 * _load(v_s, state_dtype, p) + (1 - b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        upd_ = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(
            torch.float32)
        p_new = (p.to(torch.float32) - lr * upd_).to(p.dtype)
        return _store(m, state_dtype), _store(v, state_dtype), p_new

    m, v, p_new = _unzip(
        tree_map(upd, grads, params, state["m"], state["v"]), 3)
    return p_new, {"m": m, "v": v, "step": step}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Any
    update: Any


def make_optimizer(name: str, *, lr, state_dtype: str = "float32",
                   **kw) -> Optimizer:
    if name == "adamw":
        return Optimizer(
            init=partial(adamw_init, state_dtype=state_dtype),
            update=partial(adamw_update, lr=lr, state_dtype=state_dtype,
                           **kw))
    if name == "sgdm":
        return Optimizer(
            init=partial(sgdm_init, state_dtype=state_dtype),
            update=partial(sgdm_update, lr=lr, state_dtype=state_dtype,
                           **kw))
    raise ValueError(name)
