from repro_torch.checkpoint.bridge import params_from_reference

__all__ = ["params_from_reference"]
