"""Optimizers and learning-rate schedules of the port (``repro.optim``'s
counterpart). Gradient compression (``compress_int8``,
``compressed_psum``) is not ported yet (ROADMAP.md, queue item 7)."""

from repro_torch.optim.optimizers import (Optimizer, adamw_init,
                                          adamw_update, make_optimizer,
                                          sgdm_init, sgdm_update)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["Optimizer", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_warmup_cosine", "make_optimizer", "sgdm_init",
           "sgdm_update"]
