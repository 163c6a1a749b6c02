"""Separable Gaussian blur with cv2.GaussianBlur(ksize, sigma=0) semantics.

Counterpart of ``image_to_pointcloud_tpu/ops/gaussian.py`` (the
``smooth_depth`` option): OpenCV's fixed small kernels for ksize ≤ 9,
the sigma formula beyond, BORDER_REFLECT_101 borders.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_blur", "gaussian_kernel1d"]

# OpenCV's bit-exact fixed-point kernels for sigma<=0 and ksize<=9.
_SMALL_GAUSSIAN = {
    1: np.array([1.0], dtype=np.float32),
    3: np.array([0.25, 0.5, 0.25], dtype=np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], dtype=np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125], dtype=np.float32),
    9: np.array([4, 13, 30, 51, 60, 51, 30, 13, 4], dtype=np.float32) / 256.0,
}


@functools.lru_cache(maxsize=64)
def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """1-D Gaussian kernel identical to cv2.getGaussianKernel(ksize, sigma)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    w /= w.sum()
    return w.astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Blur (..., H, W) float maps like cv2.GaussianBlur((k, k), sigma)."""
    k = gaussian_kernel1d(int(ksize), float(sigma))
    half = (len(k) - 1) // 2
    x = img.float()
    if half == 0:
        return x
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    x = x.reshape(-1, 1, h, w)
    # BORDER_REFLECT_101 == torch 'reflect'; taps summed in kernel order.
    xp = F.pad(x, (0, 0, half, half), mode="reflect")
    rows = sum(float(k[i]) * xp[..., i : i + h, :] for i in range(len(k)))
    xp = F.pad(rows, (half, half, 0, 0), mode="reflect")
    out = sum(float(k[i]) * xp[..., i : i + w] for i in range(len(k)))
    return out.reshape(*lead, h, w)
