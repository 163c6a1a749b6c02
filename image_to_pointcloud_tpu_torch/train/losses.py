"""Depth-estimation training losses (fine-tuning support).

Counterpart of ``image_to_pointcloud_tpu/train/losses.py``, the same
formulas on (B, H, W) torch tensors:

* :func:`silog_loss` — scale-invariant log loss (Eigen et al.).
* :func:`affine_invariant_loss` — MiDaS-style: per-image least-squares
  scale/shift alignment of prediction to target, then trimmed MAE.
* :func:`gradient_matching_loss` — multi-scale depth-gradient matching.
"""

from __future__ import annotations

import torch

__all__ = ["silog_loss", "affine_invariant_loss", "gradient_matching_loss"]


def _mask(pred: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.ones_like(pred)
    return mask.to(torch.float32)


def silog_loss(pred, target, mask=None, lam: float = 0.85, eps: float = 1e-6):
    """Scale-invariant log loss over valid pixels."""
    m = _mask(pred, mask)
    n = m.sum(dim=(-2, -1)).clamp_min(1.0)
    g = (torch.log(pred.clamp_min(eps)) - torch.log(target.clamp_min(eps))) * m
    s1 = (g**2).sum(dim=(-2, -1)) / n
    s2 = (g.sum(dim=(-2, -1)) / n) ** 2
    return torch.mean(s1 - lam * s2)


def _lsq_align(pred, target, m, eps=1e-6):
    n = m.sum(dim=(-2, -1), keepdim=True).clamp_min(1.0)
    mp = (pred * m).sum(dim=(-2, -1), keepdim=True) / n
    mt = (target * m).sum(dim=(-2, -1), keepdim=True) / n
    cov = ((pred - mp) * (target - mt) * m).sum(dim=(-2, -1), keepdim=True) / n
    var = (((pred - mp) ** 2) * m).sum(dim=(-2, -1), keepdim=True) / n
    s = cov / (var + eps)
    b = mt - s * mp
    return s * pred + b


def affine_invariant_loss(pred, target, mask=None, trim: float = 0.2):
    """MiDaS-style scale/shift-invariant trimmed MAE per image.

    After least-squares alignment, the worst ``trim`` fraction of valid
    residuals per image is discarded (MiDaS Eq. 6 trims 20%):
    ``keep_n = floor((1 − trim)·nvalid)`` in f32. ``trim=0`` recovers the
    plain masked MAE.
    """
    m = _mask(pred, mask)
    aligned = _lsq_align(pred, target, m)
    res = torch.abs(aligned - target) * m
    if trim <= 0.0:
        n = m.sum(dim=(-2, -1)).clamp_min(1.0)
        return torch.mean(res.sum(dim=(-2, -1)) / n)
    b = res.shape[0]
    flat = res.reshape(b, -1)
    mflat = m.reshape(b, -1)
    nvalid = mflat.sum(dim=-1)
    # Keep the floor((1-trim)·nvalid) smallest valid residuals: invalid
    # pixels sort to +inf, so the ascending prefix is valid-only.
    order = torch.sort(torch.where(mflat > 0, flat, torch.inf), dim=-1).values
    keep_n = torch.floor((1.0 - trim) * nvalid).to(torch.int32)
    idx = torch.arange(flat.shape[-1], device=flat.device)[None, :]
    kept = torch.where(idx < keep_n[:, None], order, 0.0)
    return torch.mean(kept.sum(dim=-1) / keep_n.clamp_min(1))


def gradient_matching_loss(pred, target, mask=None, scales: int = 4):
    """Multi-scale gradient matching on (B, H, W) depth maps."""
    p, t, m = pred, target, _mask(pred, mask)
    total = 0.0
    for _ in range(scales):
        # A diff is valid only when BOTH endpoint pixels are (MiDaS
        # multiplies both masks).
        dx = torch.abs(torch.diff(p - t, dim=-1)) * (m[..., :, 1:] * m[..., :, :-1])
        dy = torch.abs(torch.diff(p - t, dim=-2)) * (m[..., 1:, :] * m[..., :-1, :])
        n = m.sum(dim=(-2, -1)).clamp_min(1.0)
        total = total + torch.mean((dx.sum(dim=(-2, -1)) + dy.sum(dim=(-2, -1))) / n)
        p = p[..., ::2, ::2]
        t = t[..., ::2, ::2]
        m = m[..., ::2, ::2]
    return total / scales
