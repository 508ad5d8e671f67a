from repro_torch.models.lenet import init_lenet, lenet_apply
from repro_torch.models.transformer import DecoderLM

__all__ = ["DecoderLM", "init_lenet", "lenet_apply"]
