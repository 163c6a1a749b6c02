"""Statistical outlier removal on depth-grid clouds: the windowed grid-kNN
search as a hand-written CUDA kernel and its plain PyTorch version, and
Open3D's threshold rule.

Counterpart of ``image_to_pointcloud_tpu/ops/outlier.py`` (the scan form
``grid_knn_mean_distances`` and ``outlier_keep_from_means``) and
``ops/outlier_pallas.py`` (the Pallas kernel). The kernel
(``csrc/grid_knn.cu``) runs for CUDA tensors; CPU tensors take
:func:`grid_knn_mean_distances_plain`, the scan form written as a loop
over the window offsets.
"""

from __future__ import annotations

import torch

from image_to_pointcloud_tpu_torch import cuda

__all__ = [
    "grid_knn_mean_distances",
    "grid_knn_mean_distances_cuda",
    "grid_knn_mean_distances_plain",
    "outlier_keep_from_means",
]

_BIG = 1e30
_SENTINEL = 1e9


def outlier_keep_from_means(
    means: torch.Tensor, pos: torch.Tensor, std_ratio: float = 2.0
) -> torch.Tensor:
    """Open3D RemoveStatisticalOutliers rule over the last dim of the mean
    kNN distances: statistics over the points with ``pos`` only (Open3D's
    count_if(mean > 0)), keep = pos & mean < mean + std_ratio·std
    (Bessel). A leading batch dim applies the rule per row."""
    npos = pos.float().sum(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=means.dtype, device=means.device)
    cloud_mean = torch.where(pos, means, zero).sum(dim=-1, keepdim=True) / npos.clamp_min(1.0)
    sq = torch.where(pos, (means - cloud_mean) ** 2, zero)
    var = sq.sum(dim=-1, keepdim=True) / (npos - 1.0).clamp_min(1.0)
    threshold = cloud_mean + std_ratio * torch.sqrt(var)
    return pos & (means < threshold)


def grid_knn_mean_distances_plain(
    points_grid: torch.Tensor, *, k: int = 20, window: int = 4
) -> torch.Tensor:
    """(B, hh, ww, 3) grid points → (B, hh·ww) mean distance to the k
    nearest neighbours inside the (2·window+1)² grid window (self
    included at 0). Sentinel-padded borders; d² > 1e17 is no neighbour;
    the running top-k is an insertion cascade, one window offset at a
    time, exactly as the scan form. A NaN distance (a NaN coordinate in
    the window, or an infinite centre) propagates through ``minimum`` and
    ``maximum`` into the whole list, so nothing is found and that point's
    mean is 0, as in the JAX package."""
    p = points_grid.float()
    bsz, hh, ww, _ = p.shape
    r = window
    pad = torch.full(
        (bsz, hh + 2 * r, ww + 2 * r, 3), _SENTINEL, dtype=p.dtype, device=p.device
    )
    pad[:, r : r + hh, r : r + ww] = p
    big = torch.full((), _BIG, dtype=p.dtype, device=p.device)
    best = [big.expand(bsz, hh, ww)] * k
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            diff = pad[:, dy : dy + hh, dx : dx + ww] - p
            d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
            d2 = d2 + diff[..., 2] * diff[..., 2]
            v = torch.where(d2 > 1e17, big, d2)
            for i in range(k):
                lo = torch.minimum(best[i], v)
                v = torch.maximum(best[i], v)
                best[i] = lo
    acc = torch.zeros((bsz, hh, ww), dtype=p.dtype, device=p.device)
    cnt = torch.zeros_like(acc)
    for b in best:
        found = b < _BIG * 0.5
        acc = acc + torch.where(found, torch.sqrt(b.clamp_min(0.0)), 0.0)
        cnt = cnt + found.float()
    return (acc / cnt.clamp_min(1.0)).reshape(bsz, hh * ww)


def grid_knn_mean_distances_cuda(points_grid: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: (B, hh, ww, 3) f32 → (B, hh·ww), k=20, window=4.

    The input may be any strided view whose row stride is ``ww`` point
    strides — e.g. ``packed[:, :3].transpose(1, 2).reshape(B, hh, ww, 3)``
    of the planar (B, 8, N) point buffer, which the kernel reads in place.
    Bit-identical to :func:`grid_knn_mean_distances_plain`, NaN points
    included: the kernel visits the taps in another order (the sorted
    top-20 does not depend on it) and writes 0 wherever a NaN distance
    makes the plain version's mean 0.
    """
    if not points_grid.is_cuda or points_grid.dtype != torch.float32:
        raise ValueError(
            f"grid_knn: needs a CUDA float32 tensor, got {points_grid.dtype} "
            f"on {points_grid.device}"
        )
    if points_grid.dim() != 4 or points_grid.shape[-1] != 3:
        raise ValueError(f"grid_knn: shape {tuple(points_grid.shape)} is not (B, hh, ww, 3)")
    bsz, hh, ww, _ = points_grid.shape
    sb, sh, sp, sc = points_grid.stride()
    if hh > 1 and sh != ww * sp:
        raise ValueError("grid_knn: grid rows must be ww point strides apart")
    out = torch.empty((bsz, hh * ww), dtype=torch.float32, device=points_grid.device)
    lib = cuda.library()
    with torch.cuda.device(points_grid.device):
        err = lib.ipc_grid_knn(
            points_grid.data_ptr(), out.data_ptr(), bsz, hh, ww, sb, sp, sc,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check(err, cuda.GRID_KNN)
    cuda.GRID_KNN.count()
    return out


def grid_knn_mean_distances(
    points_grid: torch.Tensor, *, k: int = 20, window: int = 4
) -> torch.Tensor:
    """(B, hh, ww, 3) → (B, hh·ww) mean kNN distances; the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if points_grid.device.type == "cuda":
        if (k, window) != (20, 4):
            raise ValueError(f"grid_knn kernel is built for k=20, window=4, not {k}, {window}")
        return grid_knn_mean_distances_cuda(points_grid)
    if points_grid.device.type == "cpu":
        return grid_knn_mean_distances_plain(points_grid, k=k, window=window)
    raise ValueError(f"grid_knn: unsupported device {points_grid.device}")
