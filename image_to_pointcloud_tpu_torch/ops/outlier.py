"""Statistical outlier removal: the windowed grid-kNN search on depth-grid
clouds as a hand-written CUDA kernel and its plain PyTorch version, the
exact O(N²) kNN, and Open3D's threshold rule.

Counterpart of ``image_to_pointcloud_tpu/ops/outlier.py`` (the scan form
``grid_knn_mean_distances``, the exact ``knn_mean_distances`` and
``statistical_outlier_mask``, ``outlier_keep_from_means``) and
``ops/outlier_pallas.py`` (the Pallas kernel). The kernel
(``csrc/grid_knn.cu``) runs for CUDA tensors; CPU tensors take
:func:`grid_knn_mean_distances_plain`, the scan form written as a loop
over the window offsets. The exact search is plain torch on every device,
as it is jnp in the JAX package.
"""

from __future__ import annotations

import torch

from image_to_pointcloud_tpu_torch import cuda

__all__ = [
    "grid_knn_mean_distances",
    "grid_knn_mean_distances_cuda",
    "grid_knn_mean_distances_plain",
    "knn_mean_distances",
    "outlier_keep_from_means",
    "statistical_outlier_mask",
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


def knn_mean_distances(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    k: int = 20,
    query_block: int = 512,
    key_block: int = 2048,
) -> torch.Tensor:
    """(N, 3) points → (N,) mean distance to the k nearest neighbours
    (self included, at 0), exact: Open3D's ``remove_statistical_outlier``
    search, as the JAX package's blocked form.

    The points are zero-padded to whole query and key blocks (padding is
    no neighbour); per query block a running top-k of squared distances
    ``|q|² + |k|² - 2 q·k`` is merged over the key blocks; invalid points
    are no neighbour (``_BIG``) and get mean 0. The product ``q·k`` is
    three f32 multiply-adds written out, not a matmul, so it stays true
    f32 on CUDA whatever the TF32 setting (``precision=HIGHEST`` in JAX).
    """
    n = points.shape[0]
    dev = points.device
    p = points.float()
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    nq = -(-n // query_block) * query_block
    nk = -(-n // key_block) * key_block
    cap = max(nq, nk)
    p_pad = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    p_pad[:n] = p
    v_pad = torch.zeros((cap,), dtype=torch.bool, device=dev)
    v_pad[:n] = valid
    keys, kvalid = p_pad[:nk], v_pad[:nk]
    key_sq = (keys * keys).sum(dim=1)
    big = torch.full((), _BIG, dtype=torch.float32, device=dev)
    means = torch.empty((nq,), dtype=torch.float32, device=dev)
    for q0 in range(0, nq, query_block):
        q = p_pad[q0 : q0 + query_block]
        q_sq = (q * q).sum(dim=1, keepdim=True)
        best = big.expand(query_block, k)
        for k0 in range(0, nk, key_block):
            kp = keys[k0 : k0 + key_block]
            dot = (q[:, None, 0] * kp[None, :, 0] + q[:, None, 1] * kp[None, :, 1]
                   + q[:, None, 2] * kp[None, :, 2])
            d2 = q_sq + key_sq[None, k0 : k0 + key_block] - 2.0 * dot
            d2 = torch.where(kvalid[None, k0 : k0 + key_block], d2.clamp_min(0.0), big)
            best = torch.topk(torch.cat([best, d2], dim=1), k, dim=1, largest=False).values
        found = best < _BIG * 0.5
        dist = torch.sqrt(best.clamp_min(0.0))
        cnt = found.sum(dim=1).clamp_min(1)
        means[q0 : q0 + query_block] = torch.where(found, dist, 0.0).sum(dim=1) / cnt
    return torch.where(valid, means[:n], 0.0)


def statistical_outlier_mask(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    k: int = 20,
    std_ratio: float = 2.0,
    query_block: int = 512,
    key_block: int = 2048,
) -> torch.Tensor:
    """(N,) keep mask with Open3D ``remove_statistical_outlier`` semantics
    over the exact kNN."""
    if valid is None:
        valid = torch.ones((points.shape[0],), dtype=torch.bool, device=points.device)
    means = knn_mean_distances(points, valid, k=k, query_block=query_block, key_block=key_block)
    return outlier_keep_from_means(means, valid & (means > 0.0), std_ratio)
