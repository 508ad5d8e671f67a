"""Numerics and cost model of the port: float32 bit fields (``fp``), the KV
storage grids (``quant``), the paper's cell, MAC-cost and accelerator
model (``cell``, ``cost``, ``accelerator``, copies of the reference's) and
the op counter on aten graphs (``estimator``)."""
