"""Pinhole depth→point-cloud unprojection into the packed planar buffer:
the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``image_to_pointcloud_tpu/ops/unproject.py``: its jnp
``unproject`` (the form the JAX serving graph calls) and its Pallas
kernel ``unproject_pallas``, which the kernel here (``csrc/unproject.cu``)
replaces. The choice follows the tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes :func:`unproject_plain`. Both
compute, bit for bit:

* intrinsics ``cx = w/2``, ``cy = h/2``; focal ``f = (w/2)/tan(fov/2)``
  when a fov is given, else ``max(w, h) * 1.2``,
* density stride {"low": 4, "medium": 2, "high": 1},
* ``z = d[v,u] * depth_scale``; x and y substitute ``1e-6`` for z when
  ``z == 0`` but z itself stays 0,
* ``x = u·z / f`` divided, not multiplied by ``1/f`` as the Pallas kernel
  does (that rounds differently, and the host reconstruct shares this
  exact math),
* rows ``[x, y, z, r, g, b, 1 (valid), 0]``.

:func:`unproject_intrinsics` (metric depth with a real camera) and
:func:`num_points` are jnp in the JAX package, not the Pallas kernel, and
stay plain torch here.
"""

from __future__ import annotations

import math

import torch

from image_to_pointcloud_tpu_torch import cuda

__all__ = [
    "DENSITY_STRIDES",
    "focal_length",
    "num_points",
    "unproject",
    "unproject_cuda",
    "unproject_intrinsics",
    "unproject_plain",
]

DENSITY_STRIDES = {"low": 4, "medium": 2, "high": 1}


def focal_length(h: int, w: int, fov_deg: float | None) -> float:
    """Reference intrinsics (backend/app.py:218-223)."""
    if fov_deg and fov_deg > 0:
        return (w / 2.0) / math.tan(math.radians(fov_deg) / 2.0)
    return max(h, w) * 1.2


def num_points(h: int, w: int, step: int) -> int:
    """Point count for a strided (h, w) grid: ceil(h/step)*ceil(w/step)."""
    return -(-h // step) * -(-w // step)


def unproject_intrinsics(
    depth_metric: torch.Tensor,
    image_rgb: torch.Tensor,
    *,
    fx: "torch.Tensor | float",
    fy: "torch.Tensor | float",
    cx: "torch.Tensor | float",
    cy: "torch.Tensor | float",
    step: int = 1,
) -> torch.Tensor:
    """Metric-depth unprojection with a real camera model:
    ``x = (u - cx)·z / fx``, ``y = (v - cy)·z / fy``, z the metric depth
    itself. (..., h, w) depth and (..., h, w, 3) image → (..., 8, N) rows
    ``[x, y, z, r, g, b, z > 0, 0]``; each intrinsic is a number or a
    tensor with one value per leading index."""
    dev = depth_metric.device
    d = depth_metric[..., ::step, ::step].float()
    rgb = image_rgb[..., ::step, ::step, :].float()
    hh, ww = d.shape[-2:]
    lead = d.shape[:-2]
    n = hh * ww

    def per_image(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return v.reshape(*v.shape, 1, 1)

    fx, fy, cx, cy = (per_image(v) for v in (fx, fy, cx, cy))
    u = torch.arange(ww, dtype=torch.float32, device=dev) * step - cx
    v = (torch.arange(hh, dtype=torch.float32, device=dev) * step)[:, None] - cy
    x = u * d / fx
    y = v * d / fy
    return torch.stack(
        [
            x.reshape(*lead, n),
            y.reshape(*lead, n),
            d.reshape(*lead, n),
            rgb[..., 0].reshape(*lead, n),
            rgb[..., 1].reshape(*lead, n),
            rgb[..., 2].reshape(*lead, n),
            (d.reshape(*lead, n) > 0).float(),
            torch.zeros((*lead, n), dtype=torch.float32, device=dev),
        ],
        dim=-2,
    )


def unproject_plain(
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


def unproject_cuda(
    depth_norm: torch.Tensor,
    image_rgb: torch.Tensor,
    *,
    depth_scale: "torch.Tensor | float",
    step: int,
    h: int,
    w: int,
    fov_deg: float | None = None,
) -> torch.Tensor:
    """The CUDA kernel: (B, h, w) f32 depth and a (B, h, w, 3) u8 or f32
    image → (B, 8, N) f32, bit-identical to :func:`unproject_plain`. Both
    inputs are read through their strides (any views), the sampling step
    folded into the read index; ``depth_scale`` is a number or a (B,)
    tensor, read on the device."""
    if not (depth_norm.is_cuda and image_rgb.device == depth_norm.device):
        raise ValueError(
            f"unproject: needs CUDA tensors on one device, got {depth_norm.device} "
            f"and {image_rgb.device}"
        )
    if depth_norm.dtype != torch.float32 or image_rgb.dtype not in (torch.uint8, torch.float32):
        raise ValueError(
            f"unproject: needs f32 depth and a u8 or f32 image, got {depth_norm.dtype} "
            f"and {image_rgb.dtype}"
        )
    d, img = depth_norm, image_rgb
    if d.dim() != 3 or img.shape != (*d.shape, 3) or tuple(d.shape[1:]) != (h, w):
        raise ValueError(
            f"unproject: shapes {tuple(depth_norm.shape)}, {tuple(image_rgb.shape)} "
            f"do not match (B, {h}, {w}) and (B, {h}, {w}, 3)"
        )
    bsz = d.shape[0]
    scale = torch.as_tensor(depth_scale, dtype=torch.float32, device=d.device)
    scale = scale.expand(bsz).contiguous()
    hh, ww = -(-h // step), -(-w // step)
    out = torch.empty((bsz, 8, hh * ww), dtype=torch.float32, device=d.device)
    lib = cuda.library()
    with torch.cuda.device(d.device):
        err = lib.ipc_unproject(
            d.data_ptr(), img.data_ptr(), int(img.dtype == torch.uint8),
            scale.data_ptr(), out.data_ptr(), bsz, hh, ww, step,
            w / 2.0, h / 2.0, focal_length(h, w, fov_deg),
            *d.stride(), *img.stride(),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check(err, cuda.UNPROJECT)
    cuda.UNPROJECT.count()
    return out


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
    """Packed (B, 8, N) point buffers; the kernel on a CUDA tensor, the
    plain version (which also takes other leading shapes) on a CPU
    tensor."""
    kw = dict(depth_scale=depth_scale, step=step, h=h, w=w, fov_deg=fov_deg)
    if depth_norm.device.type == "cuda":
        return unproject_cuda(depth_norm, image_rgb, **kw)
    if depth_norm.device.type == "cpu":
        return unproject_plain(depth_norm, image_rgb, **kw)
    raise ValueError(f"unproject: unsupported device {depth_norm.device}")
