"""Data of the port: the procedural digits (``pipeline``)."""

from repro_torch.data.pipeline import DigitsDataset, make_digits

__all__ = ["DigitsDataset", "make_digits"]
