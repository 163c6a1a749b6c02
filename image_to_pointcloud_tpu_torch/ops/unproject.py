"""Pinhole depth→point-cloud unprojection into the packed planar buffer.

Counterpart of ``image_to_pointcloud_tpu/ops/unproject.py``'s jnp
``unproject`` — the form the serving graph calls — bit-exact with it:

* intrinsics ``cx = w/2``, ``cy = h/2``; focal ``f = (w/2)/tan(fov/2)``
  when a fov is given, else ``max(w, h) * 1.2``,
* density stride {"low": 4, "medium": 2, "high": 1},
* ``z = d[v,u] * depth_scale``; x and y substitute ``1e-6`` for z when
  ``z == 0`` but z itself stays 0,
* ``x = u·z / f`` divided, not multiplied by ``1/f`` (that rounds
  differently, and the host reconstruct shares this exact math),
* rows ``[x, y, z, r, g, b, 1 (valid), 0]``.

The Pallas kernel ``unproject_pallas`` of the JAX package is off the
serving path and not ported yet.
"""

from __future__ import annotations

import math

import torch

__all__ = ["DENSITY_STRIDES", "focal_length", "unproject"]

DENSITY_STRIDES = {"low": 4, "medium": 2, "high": 1}


def focal_length(h: int, w: int, fov_deg: float | None) -> float:
    """Reference intrinsics (backend/app.py:218-223)."""
    if fov_deg and fov_deg > 0:
        return (w / 2.0) / math.tan(math.radians(fov_deg) / 2.0)
    return max(h, w) * 1.2


def unproject(
    depth_norm: torch.Tensor,
    image_rgb: torch.Tensor,
    *,
    depth_scale: "torch.Tensor | float",
    step: int,
    h: int,
    w: int,
    fov_deg: float | None = None,
) -> torch.Tensor:
    """Back-project normalized depth into packed (8, N) point buffers.

    Args:
      depth_norm: (..., h, w) normalized depth (see ops.depthnorm).
      image_rgb: (..., h, w, 3) RGB image (uint8 or float).
      depth_scale: world-unit scale for z: a number, or a tensor with one
        value per leading index (e.g. (B,) for a batch).
      step: density stride (see DENSITY_STRIDES).
      h, w: image dims (define the intrinsics).
      fov_deg: optional field of view; None → f = max(h, w)*1.2.

    Returns:
      (..., 8, N) float32: rows [x, y, z, r, g, b, 1.0 (valid), 0.0].
    """
    dev = depth_norm.device
    d = depth_norm[..., ::step, ::step].float()
    rgb = image_rgb[..., ::step, ::step, :].float()
    hh, ww = d.shape[-2:]
    lead = d.shape[:-2]
    n = hh * ww
    cx, cy = w / 2.0, h / 2.0
    # A device tensor, not a Python number, so that no backend turns the
    # division into a multiplication by the reciprocal.
    f = torch.full((), focal_length(h, w, fov_deg), dtype=torch.float32, device=dev)
    scale = torch.as_tensor(depth_scale, dtype=torch.float32, device=dev)
    scale = scale.reshape(*scale.shape, 1, 1)

    u = torch.arange(ww, dtype=torch.float32, device=dev) * step - cx
    v = (torch.arange(hh, dtype=torch.float32, device=dev) * step - cy)[:, None]
    z = d * scale
    zs = torch.where(z != 0.0, z, torch.full((), 1e-6, dtype=torch.float32, device=dev))
    x = u * zs / f
    y = v * zs / f
    return torch.stack(
        [
            x.reshape(*lead, n),
            y.reshape(*lead, n),
            z.reshape(*lead, n),
            rgb[..., 0].reshape(*lead, n),
            rgb[..., 1].reshape(*lead, n),
            rgb[..., 2].reshape(*lead, n),
            torch.ones((*lead, n), dtype=torch.float32, device=dev),
            torch.zeros((*lead, n), dtype=torch.float32, device=dev),
        ],
        dim=-2,
    )
