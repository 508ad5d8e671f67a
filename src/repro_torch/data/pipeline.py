"""The procedural digits dataset: a copy of the reference's numpy-only
``make_digits`` (``repro/data/pipeline.py``), so the port serves the same
images as the reference for the same seed.

MNIST is not available offline: ``make_digits`` renders a procedural
10-class digit-like dataset (5x7 glyph stamps + jitter + noise, 28x28x1).
``DigitsDataset`` and the synthetic token stream are not ported.
"""

from __future__ import annotations

import numpy as np

# 5x7 bitmap glyphs for digits 0-9 (classic calculator-style font)
_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["01110", "10000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00001", "01110"],
}


def _glyph_array(d: int) -> np.ndarray:
    return np.array([[int(c) for c in row] for row in _GLYPHS[d]],
                    dtype=np.float32)


def make_digits(n: int, *, seed: int = 0,
                noise: float = 0.15) -> tuple[np.ndarray, np.ndarray]:
    """Render ``n`` 28x28x1 digit images with random shift/scale/noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.zeros((n, 28, 28, 1), np.float32)
    for i, lab in enumerate(labels):
        g = _glyph_array(int(lab))
        scale = rng.integers(2, 4)               # 2x or 3x upscale
        big = np.kron(g, np.ones((scale, scale), np.float32))
        h, w = big.shape
        dy = rng.integers(1, 28 - h) if h < 27 else 0
        dx = rng.integers(1, 28 - w) if w < 27 else 0
        canvas = np.zeros((28, 28), np.float32)
        canvas[dy:dy + h, dx:dx + w] = big
        canvas += rng.normal(0, noise, (28, 28)).astype(np.float32)
        imgs[i, :, :, 0] = np.clip(canvas, 0.0, 1.0)
    return imgs, labels

