"""Optimizers, learning-rate schedules and gradient compression of the
port (``repro.optim``'s counterpart)."""

from repro_torch.optim.compression import (compress_int8, compressed_psum,
                                           decompress_int8)
from repro_torch.optim.optimizers import (Optimizer, adamw_init,
                                          adamw_update, make_optimizer,
                                          sgdm_init, sgdm_update)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["Optimizer", "adamw_init", "adamw_update", "compress_int8",
           "compressed_psum", "cosine_schedule", "decompress_int8",
           "linear_warmup_cosine", "make_optimizer", "sgdm_init",
           "sgdm_update"]
