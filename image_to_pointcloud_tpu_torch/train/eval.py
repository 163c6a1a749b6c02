"""Standard monocular-depth evaluation metrics.

Counterpart of ``image_to_pointcloud_tpu/train/eval.py``: the metrics
every depth-estimation paper reports, mask-aware, for validating
fine-tuned checkpoints against ground truth:

  AbsRel   mean |d − d*| / d*
  SqRel    mean (d − d*)² / d*
  RMSE     √mean (d − d*)²
  RMSElog  √mean (log d − log d*)²
  SILog    scale-invariant log error (Eigen et al.)
  δ<1.25ᵏ  fraction with max(d/d*, d*/d) < 1.25ᵏ, k ∈ {1,2,3}

As the JAX package jits it, on CUDA each signature (the shapes and
dtypes of pred and target, and whether a mask is given: the jit's pytree
structure) is one CUDA graph, held by a module-level graph owner per
device (``pipeline/graph.py``'s ``_GraphOwner``); on the CPU the same
callable runs eagerly.
"""

from __future__ import annotations

import threading

import torch

from image_to_pointcloud_tpu_torch.pipeline.graph import _GraphOwner

__all__ = ["depth_metrics"]

_OWNERS: dict[torch.device, _GraphOwner] = {}
_OWNERS_LOCK = threading.Lock()


def _owner(device: torch.device) -> _GraphOwner:
    """The graph owner of ``device`` (made at its first use)."""
    with _OWNERS_LOCK:
        owner = _OWNERS.get(device)
        if owner is None:
            owner = _OWNERS[device] = _GraphOwner(device, device.type == "cuda")
        return owner


@torch.no_grad()
def depth_metrics(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None
) -> dict[str, torch.Tensor]:
    """Metrics over valid pixels (mask True, target > 0), as 0-d tensors.

    Args:
      pred/target: (..., H, W) positive depths.
      mask: optional boolean validity mask (same shape).
    """
    key = ("depth_metrics", tuple(pred.shape), pred.dtype, tuple(target.shape), target.dtype,
           mask is not None)
    fn = _owner(pred.device)._signature(key, _metrics)
    return fn(pred, target) if mask is None else fn(pred, target, mask)


def _metrics(pred, target, mask=None) -> dict[str, torch.Tensor]:
    """:func:`depth_metrics`'s body."""
    valid = target > 0
    if mask is not None:
        valid = valid & mask
    n = valid.sum().clamp_min(1)
    eps = 1e-12
    p = torch.where(valid, pred.clamp_min(eps), 1.0)
    t = torch.where(valid, target.clamp_min(eps), 1.0)

    def vmean(x):
        return torch.where(valid, x, 0.0).sum() / n

    diff = p - t
    log_diff = torch.log(p) - torch.log(t)
    ratio = torch.maximum(p / t, t / p)

    silog_first = vmean(log_diff**2)
    silog_second = vmean(log_diff) ** 2
    return {
        "abs_rel": vmean(torch.abs(diff) / t),
        "sq_rel": vmean(diff**2 / t),
        "rmse": torch.sqrt(vmean(diff**2)),
        "rmse_log": torch.sqrt(vmean(log_diff**2)),
        "silog": torch.sqrt((silog_first - silog_second).clamp_min(0.0)),
        "delta1": vmean((ratio < 1.25).float()),
        "delta2": vmean((ratio < 1.25**2).float()),
        "delta3": vmean((ratio < 1.25**3).float()),
    }
