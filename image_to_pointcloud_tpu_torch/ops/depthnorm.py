"""Robust depth normalization — the reference's shared normalize path.

Counterpart of ``image_to_pointcloud_tpu/ops/depthnorm.py``, bit-exact
with it:

1. non-finite values are replaced by the median of the finite values,
2. percentiles p2/p98 are taken (numpy linear interpolation),
3. if ``p98 <= p2`` fall back to (min, max),
4. clip to [p2, p98] and scale by ``(d - p2) / (p98 - p2 + 1e-6)``,
5. if the range is still degenerate the output is all zeros,
6. optional inversion ``d -> 1 - d``.

The JAX package finds its order statistics by bisecting float bit
patterns, a TPU trick to avoid sorting; on the GPU a sort is cheap, and
the order statistics it yields are the same exact values.
:func:`order_statistics` is the JAX package's public function of that
name, with its bits: it sorts the same order-preserving integer keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.utils.constants import device_constant

__all__ = ["normalize_depth", "order_statistics"]


def _ordered_key(bits: torch.Tensor) -> torch.Tensor:
    """float32 bits (as int32) ↔ int32 keys in IEEE-754 total order: a
    negative float's magnitude bits are flipped, so -0.0 sorts just below
    +0.0 and every NaN beyond ±inf. Its own inverse."""
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def order_statistics(x: torch.Tensor, ks) -> torch.Tensor:
    """Exact k-th smallest values (0-based ranks ``ks``) of 1-D ``x``, in
    float32, bit for bit the JAX package's: that bisects the ordered keys
    of the floats' bits, and this sorts the same keys, so ties of -0.0
    and +0.0 keep their sign (a ``torch.sort`` of the floats would tie
    them)."""
    keys = _ordered_key(x.float().reshape(-1).view(torch.int32))
    idx = np.asarray(ks, np.int64)
    ranks = device_constant(("ranks", idx.shape, *idx.ravel().tolist()), keys.device, None,
                            lambda: idx)
    return _ordered_key(torch.sort(keys).values[ranks]).view(torch.float32)


def normalize_depth(depth: torch.Tensor, invert: bool = True) -> torch.Tensor:
    """Normalize a depth map (any shape, as one population) to [0, 1];
    returns float32 of the same shape."""
    d = depth.float()
    flat = d.reshape(-1)
    n = flat.shape[0]
    # Constants as f32 device scalars, made by a fill (no host copy).
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=d.device)  # noqa: E731

    # Median of the finite values (nanmedian): non-finites sort to +inf
    # and the median ranks follow the finite count, all on the device.
    finite = torch.isfinite(flat)
    srt = torch.sort(torch.where(finite, flat, f32(math.inf))).values
    nfin = finite.sum()
    meds = srt[torch.stack([(nfin - 1) // 2, nfin // 2]).clamp_min(0)]
    med = f32(0.5) * (meds[0] + meds[1])
    flat = torch.where(finite, flat, med)

    # numpy 'linear' percentiles from four exact order statistics, with
    # the JAX package's f32 interpolation term for term.
    pos2 = 2.0 / 100.0 * (n - 1)
    pos98 = 98.0 / 100.0 * (n - 1)
    srt = torch.sort(flat).values
    os4 = torch.stack([srt[i] for i in (math.floor(pos2), math.ceil(pos2),
                                        math.floor(pos98), math.ceil(pos98))])
    frac2 = f32(pos2 - math.floor(pos2))
    frac98 = f32(pos98 - math.floor(pos98))
    one = f32(1.0)
    p2 = os4[0] * (one - frac2) + os4[1] * frac2
    p98 = os4[2] * (one - frac98) + os4[3] * frac98

    # Fallback to (min, max) when p98 <= p2.
    use_fallback = p98 <= p2
    lo = torch.where(use_fallback, srt[0], p2)
    hi = torch.where(use_fallback, srt[-1], p98)

    scaled = (torch.minimum(torch.maximum(flat, lo), hi) - lo) / (hi - lo + f32(1e-6))
    out = torch.where(hi > lo, scaled, torch.zeros_like(scaled))
    if invert:
        out = one - out
    return out.reshape(d.shape)
