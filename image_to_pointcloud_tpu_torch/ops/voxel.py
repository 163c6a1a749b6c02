"""Voxel-grid downsampling with fixed-capacity outputs (Open3D
``voxel_down_sample`` semantics).

Counterpart of ``image_to_pointcloud_tpu/ops/voxel.py``. Each occupied
voxel's points and colours are averaged; the voxel index is
``floor((p - (min_bound - voxel_size/2)) / voxel_size)`` (Open3D centres
the grid half a voxel below the min bound). Points are grouped by a stable
lexicographic sort of the (x, y, z) indices, z the primary key as in
``jnp.lexsort((x, y, z))`` (never a combined linear key, which wraps int32
for a wide cloud under a tiny voxel), segment starts give a dense rank,
and a scatter-add sums each segment into its slot. Outputs keep the JAX
package's fixed capacity: (N, ...) buffers, the first ``count`` valid.

On the CPU the scatter-add runs in the sorted order, as XLA's does, so the
sums are the JAX package's bit for bit. On CUDA ``index_add_`` is atomic:
each voxel's sum is taken in an order that changes from run to run, so
the means differ from the CPU's by a few f32 ulp of the coordinates.
"""

from __future__ import annotations

import torch

__all__ = ["voxel_downsample"]


def _lexsort_zyx(idx3: torch.Tensor) -> torch.Tensor:
    """Stable order sorting by z, then y, then x."""
    order = torch.argsort(idx3[:, 0], stable=True)
    for axis in (1, 2):
        order = order[torch.argsort(idx3[order, axis], stable=True)]
    return order


def voxel_downsample(
    points: torch.Tensor,
    colors: torch.Tensor,
    voxel_size: float,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Average points and colours per occupied voxel.

    Args:
      points: (N, 3) float32.
      colors: (N, C) float32, averaged alongside the positions.
      voxel_size: the voxel edge length.
      valid: optional (N,) bool mask of live inputs.

    Returns:
      (points (N, 3), colors (N, C), valid (N,), count): the first
      ``count`` slots hold one voxel each, in sorted voxel order.
    """
    n = points.shape[0]
    dev = points.device
    p = points.float()
    c = colors.float()
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    vsize = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    minb = torch.where(valid[:, None], p, inf).amin(dim=0)
    idx3 = torch.floor((p - (minb - 0.5 * vsize)) / vsize).to(torch.int32)
    iv = torch.where(valid[:, None], idx3, torch.iinfo(torch.int32).max)  # invalid last
    order = _lexsort_zyx(iv)
    sidx, sp, sc, svalid = iv[order], p[order], c[order], valid[order]

    is_start = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=dev), (sidx[1:] != sidx[:-1]).any(dim=1),
    ]) & svalid
    rank = torch.cumsum(is_start.to(torch.int32), dim=0) - 1  # dense voxel id
    rank = torch.where(svalid, rank, n - 1).long()  # invalid parked in the last slot

    zero = torch.zeros((), device=dev)
    sums_p = torch.zeros((n, 3), device=dev).index_add_(0, rank, torch.where(svalid[:, None], sp, zero))
    sums_c = torch.zeros((n, c.shape[1]), device=dev).index_add_(
        0, rank, torch.where(svalid[:, None], sc, zero))
    cnt = torch.zeros((n,), device=dev).index_add_(0, rank, svalid.float())

    count = is_start.sum()
    out_valid = torch.arange(n, device=dev) < count
    safe = cnt.clamp_min(1.0)[:, None]
    return sums_p / safe, sums_c / safe, out_valid, count
