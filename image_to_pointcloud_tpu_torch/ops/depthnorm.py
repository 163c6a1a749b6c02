"""Robust depth normalization — the reference's shared normalize path.

Counterpart of ``image_to_pointcloud_tpu/ops/depthnorm.py``, bit-exact
with it:

1. non-finite values are replaced by the median of the finite values,
2. percentiles p2/p98 are taken (numpy linear interpolation),
3. if ``p98 <= p2`` fall back to (min, max),
4. clip to [p2, p98] and scale by ``(d - p2) / (p98 - p2 + 1e-6)``,
5. if the range is still degenerate the output is all zeros,
6. optional inversion ``d -> 1 - d``.

The JAX package finds its order statistics by bisecting the floats'
IEEE-total-order keys, a TPU trick to avoid sorting. On the card,
:func:`normalize_depth_planes` normalizes a batch of planes in one
hand-written exact radix select over the same keys (``csrc/depthnorm.cu``);
on the CPU its plain version sorts those keys. Either way -0.0 ranks below
+0.0 and the clip is taken in that order, as the JAX package's do.
:func:`order_statistics` is the JAX package's public function of that
name, with its bits: it sorts the same order-preserving integer keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from image_to_pointcloud_tpu_torch import cuda
from image_to_pointcloud_tpu_torch.utils.constants import device_constant

__all__ = [
    "normalize_depth",
    "normalize_depth_cuda",
    "normalize_depth_planes",
    "normalize_depth_plain",
    "order_statistics",
]

# The divisor's epsilon, rounded to f32 as ``torch.full((), 1e-6)`` does.
_EPS = float(np.float32(1e-6))


def _ordered_key(bits: torch.Tensor) -> torch.Tensor:
    """float32 bits (as int32) ↔ int32 keys in IEEE-754 total order: a
    negative float's magnitude bits are flipped, so -0.0 sorts just below
    +0.0 and every NaN beyond ±inf. Its own inverse."""
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _keys(x: torch.Tensor) -> torch.Tensor:
    return _ordered_key(x.view(torch.int32))


def _values(keys: torch.Tensor) -> torch.Tensor:
    return _ordered_key(keys).view(torch.float32)


def order_statistics(x: torch.Tensor, ks) -> torch.Tensor:
    """Exact k-th smallest values (0-based ranks ``ks``) of 1-D ``x``, in
    float32, bit for bit the JAX package's: that bisects the ordered keys
    of the floats' bits, and this sorts the same keys, so ties of -0.0
    and +0.0 keep their sign (a ``torch.sort`` of the floats would tie
    them)."""
    keys = _keys(x.float().reshape(-1))
    idx = np.asarray(ks, np.int64)
    ranks = device_constant(("ranks", idx.shape, *idx.ravel().tolist()), keys.device, None,
                            lambda: idx)
    return _values(torch.sort(keys).values[ranks])


def _percentile_ranks(n: int) -> tuple[list[int], float, float]:
    """The ranks floor/ceil of 0.02·(n-1) and of 0.98·(n-1), then 0 and
    n-1 (the fallback's min and max), and the two interpolation fractions
    rounded to f32."""
    pos2 = 2.0 / 100.0 * (n - 1)
    pos98 = 98.0 / 100.0 * (n - 1)
    ranks = [math.floor(pos2), math.ceil(pos2), math.floor(pos98), math.ceil(pos98), 0, n - 1]
    return (ranks, float(np.float32(pos2 - math.floor(pos2))),
            float(np.float32(pos98 - math.floor(pos98))))


def normalize_depth_plain(planes: torch.Tensor, invert: bool = True) -> torch.Tensor:
    """The plain version: (B, n) f32 planes, each one population, → (B, n)
    f32. The kernel's arithmetic in PyTorch ops: the order statistics from
    sorts of the total-order keys, the clip by key comparisons."""
    x = planes.float()
    n = x.shape[-1]
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=x.device)  # noqa: E731

    # Median of the finite values (nanmedian): non-finites rank as +inf and
    # the median ranks follow each plane's finite count.
    finite = torch.isfinite(x)
    srt = torch.sort(_keys(torch.where(finite, x, f32(math.inf)))).values
    nfin = finite.sum(-1, keepdim=True)
    meds = _values(srt.gather(-1, torch.cat([(nfin - 1) // 2, nfin // 2], -1).clamp_min(0)))
    med = f32(0.5) * (meds[:, :1] + meds[:, 1:])
    x = torch.where(finite, x, med)

    # numpy 'linear' percentiles from four exact order statistics, with
    # the JAX package's f32 interpolation term for term; the fallback's
    # (min, max) are ranks 0 and n-1.
    keys = _keys(x)
    ranks, frac2, frac98 = _percentile_ranks(n)
    os6 = _values(torch.sort(keys).values[:, ranks])
    frac2, frac98, one = f32(frac2), f32(frac98), f32(1.0)
    p2 = os6[:, 0:1] * (one - frac2) + os6[:, 1:2] * frac2
    p98 = os6[:, 2:3] * (one - frac98) + os6[:, 3:4] * frac98
    use_fallback = p98 <= p2
    lo = torch.where(use_fallback, os6[:, 4:5], p2)
    hi = torch.where(use_fallback, os6[:, 5:6], p98)

    # clip(x, lo, hi) in the total order (-0.0 below +0.0), as jnp.clip's
    # maximum and minimum take it.
    c = torch.where(keys < _keys(lo), lo, x)
    c = torch.where(_keys(c) > _keys(hi), hi, c)
    scaled = (c - lo) / (hi - lo + f32(_EPS))
    out = torch.where(hi > lo, scaled, torch.zeros_like(scaled))
    return one - out if invert else out


def normalize_depth_cuda(planes: torch.Tensor, invert: bool = True) -> torch.Tensor:
    """The CUDA kernel: (B, n) f32 planes on the card → (B, n) f32, bit for
    bit :func:`normalize_depth_plain`, with no host synchronisation (the
    ranks and fractions follow from n alone)."""
    if not planes.is_cuda:
        raise ValueError(f"normalize_depth_cuda: needs a CUDA tensor, got {planes.device}")
    if planes.dim() != 2 or planes.shape[0] == 0 or planes.shape[1] == 0:
        raise ValueError(f"normalize_depth_cuda: needs non-empty (B, n) planes, got "
                         f"{tuple(planes.shape)}")
    x = planes.float().contiguous()
    bsz, n = x.shape
    ranks, frac2, frac98 = _percentile_ranks(n)
    lib = cuda.library()
    scratch = torch.zeros(lib.ipc_depthnorm_scratch_bytes(bsz), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.ipc_depthnorm(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), bsz, n, *ranks,
            frac2, frac98, _EPS, int(bool(invert)), torch.cuda.current_stream().cuda_stream,
        )
    cuda.check(err, cuda.DEPTHNORM)
    cuda.DEPTHNORM.count()
    return out


def normalize_depth_planes(depth: torch.Tensor, invert: bool = True) -> torch.Tensor:
    """Normalize each of B depth planes (``depth`` of shape (B, ...), each
    plane one population) to [0, 1]; f32 of the same shape. A CUDA tensor
    launches the kernel on all planes at once, a CPU tensor takes the
    plain version."""
    planes = depth.reshape(depth.shape[0], -1)
    if depth.device.type == "cuda":
        out = normalize_depth_cuda(planes, invert)
    elif depth.device.type == "cpu":
        out = normalize_depth_plain(planes, invert)
    else:
        raise ValueError(f"normalize_depth: unsupported device {depth.device}")
    return out.reshape(depth.shape)


def normalize_depth(depth: torch.Tensor, invert: bool = True) -> torch.Tensor:
    """Normalize a depth map (any shape, as one population) to [0, 1];
    returns float32 of the same shape."""
    return normalize_depth_planes(depth.reshape(1, -1), invert).reshape(depth.shape)
