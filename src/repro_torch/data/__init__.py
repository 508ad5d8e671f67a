"""Data of the port: the procedural digits (``pipeline``)."""

from repro_torch.data.pipeline import make_digits

__all__ = ["make_digits"]
