"""High-resolution tiled depth inference: tile planning, extraction and
feathered, affine-aligned blending.

Counterpart of ``image_to_pointcloud_tpu/parallel/tiling.py``. Large
inputs are cut into overlapping model-native tiles that run as one batch;
each tile's relative depth is affine-aligned (least-squares scale and
shift) to a low-resolution anchor pass, then the tiles are blended back
with separable feathered weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.utils.constants import device_constant

__all__ = ["blend_tiles", "extract_tiles", "plan_tiles"]


def plan_tiles(h: int, w: int, tile: int, overlap: int) -> list[tuple[int, int]]:
    """Top-left corners of overlapping tiles covering (h, w).

    Requires ``0 <= overlap < tile <= min(h, w)``; callers clamp
    (``HighResPipeline`` does).
    """
    if tile <= 0 or not 0 <= overlap < tile:
        raise ValueError(f"need 0 <= overlap < tile, got tile={tile} overlap={overlap}")
    if tile > h or tile > w:
        raise ValueError(f"tile {tile} exceeds image {h}x{w}; clamp it first")
    stride = tile - overlap

    def axis(n):
        if n <= tile:
            return [0]
        pos = list(range(0, n - tile, stride))
        pos.append(n - tile)
        return pos

    return [(y, x) for y in axis(h) for x in axis(w)]


def extract_tiles(img: torch.Tensor, corners, tile: int) -> torch.Tensor:
    """(H, W, C) → (T, tile, tile, C)."""
    return torch.stack([img[y : y + tile, x : x + tile] for y, x in corners])


@functools.lru_cache(maxsize=32)
def _feather_1d(tile: int) -> np.ndarray:
    ramp = np.minimum(np.arange(tile) + 1, np.arange(tile)[::-1] + 1)
    return (ramp / ramp.max()).astype(np.float32)


def _align_affine(tile_depth: torch.Tensor, anchor: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Least-squares (scale, shift) mapping tile_depth → anchor."""
    x = tile_depth.reshape(-1)
    y = anchor.reshape(-1)
    mx, my = x.mean(), y.mean()
    cov = ((x - mx) * (y - my)).mean()
    var = ((x - mx) ** 2).mean()
    s = cov / (var + eps)
    b = my - s * mx
    return s * tile_depth + b


def blend_tiles(
    tile_depths: torch.Tensor,
    corners,
    out_hw: tuple[int, int],
    anchor: torch.Tensor | None = None,
) -> torch.Tensor:
    """(T, t, t) per-tile depths → (H, W) feather-blended mosaic; each
    tile affine-aligned to ``anchor`` (an (H, W) upsampled full-image
    pass) first when one is given."""
    h, w = out_hw
    t = tile_depths.shape[1]
    dev = tile_depths.device
    fw = device_constant(("feather", t), dev, torch.float32,
                         lambda: np.outer(_feather_1d(t), _feather_1d(t)))
    acc = torch.zeros((h, w), dtype=torch.float32, device=dev)
    wacc = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for i, (y, x) in enumerate(corners):
        d = tile_depths[i]
        if anchor is not None:
            d = _align_affine(d, anchor[y : y + t, x : x + t])
        acc[y : y + t, x : x + t] += d * fw
        wacc[y : y + t, x : x + t] += fw
    return acc / wacc.clamp_min(1e-8)
