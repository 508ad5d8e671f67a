from repro_torch.checkpoint.bridge import (kv_pool_from_reference,
                                           lenet_params_from_reference,
                                           model_from_stacked,
                                           opt_state_from_reference,
                                           params_from_reference,
                                           stacked_from_reference)
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         load_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "kv_pool_from_reference", "latest_step",
           "lenet_params_from_reference", "load_checkpoint",
           "model_from_stacked", "opt_state_from_reference",
           "params_from_reference", "save_checkpoint",
           "stacked_from_reference"]
