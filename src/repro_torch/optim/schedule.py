"""Learning-rate schedules (pure functions of the step counter): the port
of ``repro.optim.schedule``. ``step`` is an integer tensor."""

from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        t = torch.clamp_max(step.to(torch.float32), total_steps) / total_steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * (min_frac + (1 - min_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        s = step.to(torch.float32)
        warm = base_lr * torch.clamp_max(s / max(warmup, 1), 1.0)
        return torch.where(s < warmup, warm, cos(step - warmup))
    return lr
