"""Numerics of the port: float32 bit fields (``fp``) and the KV storage
grids (``quant``)."""
