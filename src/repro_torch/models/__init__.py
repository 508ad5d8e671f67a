from repro_torch.models.transformer import DecoderLM

__all__ = ["DecoderLM"]
