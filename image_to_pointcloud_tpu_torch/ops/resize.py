"""Separable resampling as two matrix products with exact OpenCV / PIL /
torch weights.

Counterpart of ``image_to_pointcloud_tpu/ops/resize.py``. The weight
builders are numpy and identical to the JAX package's (copied: importing
any module of ``image_to_pointcloud_tpu.ops`` imports JAX). Every resize
is ``W_rows @ img @ W_colsᵀ``; float32 inputs run in full float32, as the
JAX package's HIGHEST precision does, and bfloat16 inputs (feature maps
inside the model) stay bfloat16 with float32 accumulation.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.utils.constants import device_constant

__all__ = [
    "resample_matrix",
    "resample_weights",
    "resize2d",
    "resize_area",
    "resize_batched",
    "resize_bicubic_pil",
    "resize_linear",
    "resize_planes",
]


def _weights_area(in_size: int, out_size: int) -> np.ndarray:
    """cv2.INTER_AREA weights for downscaling (box-filter area overlap)."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        left = i * scale
        right = (i + 1) * scale
        j0 = int(math.floor(left))
        j1 = int(math.ceil(right))
        for j in range(j0, min(j1, in_size)):
            overlap = min(right, j + 1) - max(left, j)
            if overlap > 0:
                w[i, j] = overlap / scale
        s = w[i].sum()
        if s > 0:
            w[i] /= s
    return w.astype(np.float32)


def _weights_linear(in_size: int, out_size: int) -> np.ndarray:
    """cv2.INTER_LINEAR weights (half-pixel centers, clamped borders)."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        j = int(math.floor(src))
        f = src - j
        j0 = min(max(j, 0), in_size - 1)
        j1 = min(max(j + 1, 0), in_size - 1)
        w[i, j0] += 1.0 - f
        w[i, j1] += f
    return w.astype(np.float32)


def _cubic_filter(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic kernel with a=-0.5 (PIL's BICUBIC filter)."""
    x = np.abs(x)
    r = np.zeros_like(x)
    m1 = x < 1.0
    m2 = (x >= 1.0) & (x < 2.0)
    r[m1] = ((a + 2.0) * x[m1] - (a + 3.0)) * x[m1] * x[m1] + 1.0
    r[m2] = (((x[m2] - 5.0) * x[m2] + 8.0) * x[m2] - 4.0) * a
    return r


def _weights_bicubic_pil(in_size: int, out_size: int) -> np.ndarray:
    """PIL ``Image.resize(..., BICUBIC)`` weights (support widened by the
    scale when downscaling, normalized per output pixel)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        j0 = max(int(center - support + 0.5), 0)
        j1 = min(int(center + support + 0.5), in_size)
        js = np.arange(j0, j1)
        ww = _cubic_filter((js - center + 0.5) / filterscale)
        tot = ww.sum()
        if tot != 0:
            ww = ww / tot
        w[i, j0:j1] = ww
    return w.astype(np.float32)


def _weights_linear_ac(in_size: int, out_size: int) -> np.ndarray:
    """torch ``F.interpolate(mode='bilinear', align_corners=True)`` weights."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    for i in range(out_size):
        src = i * scale
        j = int(math.floor(src))
        f = src - j
        j0 = min(max(j, 0), in_size - 1)
        j1 = min(max(j + 1, 0), in_size - 1)
        w[i, j0] += 1.0 - f
        w[i, j1] += f
    return w.astype(np.float32)


def _weights_bicubic_torch(in_size: int, out_size: int) -> np.ndarray:
    """torch ``F.interpolate(mode='bicubic', align_corners=False,
    antialias=False)`` weights (a=-0.75, clamped borders) — DINOv2's
    position-embedding interpolation."""
    a = -0.75
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        j = int(math.floor(src))
        t = src - j
        offs = np.array([-1, 0, 1, 2])
        x = np.abs(offs - t)
        ww = np.where(
            x < 1.0,
            ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
            np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
        )
        for o, wt in zip(offs, ww):
            jj = min(max(j + o, 0), in_size - 1)
            w[i, jj] += wt
    return w.astype(np.float32)


_FILTERS = {
    "area": _weights_area,
    "linear": _weights_linear,
    "linear_ac": _weights_linear_ac,
    "bicubic_pil": _weights_bicubic_pil,
    "bicubic_torch": _weights_bicubic_torch,
}


@functools.lru_cache(maxsize=256)
def resample_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """Cached (out_size, in_size) resampling-weight matrix."""
    if in_size == out_size and method in ("area", "linear", "linear_ac"):
        return np.eye(out_size, dtype=np.float32)
    return _FILTERS[method](in_size, out_size)


def resample_weights(in_size: int, out_size: int, method: str, like: torch.Tensor) -> torch.Tensor:
    """:func:`resample_matrix` as a tensor of ``like``'s device and dtype,
    made once (a device constant: a CUDA graph may read it)."""
    return device_constant(("resample", in_size, out_size, method), like.device, like.dtype,
                           lambda: resample_matrix(in_size, out_size, method))


def resize_planes(
    x: torch.Tensor, out_hw: tuple[int, int], method: str
) -> torch.Tensor:
    """Resize the last two dims, (..., H, W) → (..., oh, ow).

    Same-size resizes are identities for every filter and are skipped;
    integer inputs are resized in float32.
    """
    if not x.is_floating_point():
        x = x.float()
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    wr = resample_weights(x.shape[-2], out_hw[0], method, x)
    wc = resample_weights(x.shape[-1], out_hw[1], method, x)
    return torch.matmul(torch.matmul(wr, x), wc.T)


def resize_batched(
    x: torch.Tensor, out_hw: tuple[int, int], method: str
) -> torch.Tensor:
    """Resize a (B, H, W, C) batch with the given filter."""
    return resize_planes(x.permute(0, 3, 1, 2), out_hw, method).permute(0, 2, 3, 1)


def resize2d(img: torch.Tensor, out_hw: tuple[int, int], method: str) -> torch.Tensor:
    """Resize an (H, W) or (H, W, C) image with the given filter, in
    float32."""
    x = img.float()
    if x.dim() == 2:
        return resize_planes(x, out_hw, method)
    return resize_batched(x[None], out_hw, method)[0]


def resize_area(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_AREA resize (reference backend/app.py:444)."""
    return resize2d(img, out_hw, "area")


def resize_linear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_LINEAR resize (reference backend/app.py:188)."""
    return resize2d(img, out_hw, "linear")


def resize_bicubic_pil(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """PIL BICUBIC resize (HF processor semantics, backend/app.py:109)."""
    return resize2d(img, out_hw, "bicubic_pil")
