"""Inputs made from the seed: photographic frames and their q88 JPEGs.

:func:`photo` is a frozen copy of ``benchmarks/synth.py``'s (numpy only).
"""

from __future__ import annotations

import io

import numpy as np


def photo(w: int, h: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 photographic synthetic image."""
    g = np.random.default_rng(seed)
    x = np.linspace(0, 4 * np.pi, w)
    y = np.linspace(0, 3 * np.pi, h)
    base = np.stack(
        [
            127 + 110 * np.sin(x)[None, :] * np.cos(y)[:, None],
            127 + 90 * np.cos(2 * x)[None, :] + 0 * y[:, None],
            127 + 70 * np.sin(y)[:, None] + 0 * x[None, :],
        ],
        -1,
    )
    return (base + g.normal(0, 6.0, base.shape)).clip(0, 255).astype(np.uint8)


def frames(seed: int, count: int, h: int, w: int) -> list[np.ndarray]:
    """``count`` distinct (h, w, 3) u8 frames, each a :func:`photo` under
    a seed derived from ``seed`` and its index."""
    return [photo(w, h, int(np.random.default_rng([seed, i]).integers(2**62))) for i in range(count)]


def jpeg(img: np.ndarray, quality: int) -> bytes:
    """Baseline JPEG, 4:2:0 chroma."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality, subsampling=2)
    return buf.getvalue()


def decode(data: bytes) -> np.ndarray:
    """JPEG bytes → (H, W, 3) u8 RGB, as PIL decodes them."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
