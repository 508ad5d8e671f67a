"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each CUDA kernel of the port is held against its plain version here: the
CPU tests compare these with the reference's Pallas kernels, and
``chip_smoke.py`` compares each kernel with its plain version on the
card. A kernel wrapper calls its plain version only for tensors on the
CPU.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(q: torch.Tensor, k_store: torch.Tensor,
                               v_store: torch.Tensor,
                               block_table: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode attention over a paged KV pool.

    q: [B, H, D]; k/v_store: [N, bs, G, D]; block_table: [B, W] physical
    block ids (entries past a slot's position point at the scratch
    block); pos: [B] per-slot positions. Returns [B, H, D] in q's dtype.

    Gathers every table entry (the reference's XLA path,
    ``repro/models/attention.py`` paged decode), scores in float32 scaled
    by 1/sqrt(D), masks keys past ``pos[b]``, softmaxes, rounds the
    probabilities to v's dtype (as the Pallas kernel does before its PV
    product) and takes the PV product in float32. Query head ``h`` reads
    kv head ``h // (H // G)``.
    """
    b, h, d = q.shape
    _, bs, g, _ = k_store.shape
    w = block_table.shape[1]
    tbl = block_table.long()
    k = k_store[tbl].reshape(b, w * bs, g, d)
    v = v_store[tbl].reshape(b, w * bs, g, d)
    qg = q.reshape(b, g, h // g, d)
    scores = torch.einsum("bgrd,blgd->bgrl", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(d))
    valid = (torch.arange(w * bs, device=q.device)[None]
             <= pos.long()[:, None])                       # [B, L]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrl,blgd->bgrd", probs.float(), v.float())
    return out.reshape(b, h, d).to(q.dtype)
