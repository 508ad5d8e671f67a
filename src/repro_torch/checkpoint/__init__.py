from repro_torch.checkpoint.bridge import (kv_pool_from_reference,
                                           params_from_reference)

__all__ = ["kv_pool_from_reference", "params_from_reference"]
