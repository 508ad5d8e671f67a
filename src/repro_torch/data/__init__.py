"""Data of the port: the procedural digits and the synthetic token stream
(``pipeline``)."""

from repro_torch.data.pipeline import DigitsDataset, TokenStream, make_digits

__all__ = ["DigitsDataset", "TokenStream", "make_digits"]
