"""Model-input preprocessing with the HF image processors' semantics.

Counterpart of ``image_to_pointcloud_tpu/pipeline/preprocess.py``: the
per-family parameters read off the model config
(:func:`model_preprocess_spec`, :func:`reflect_pad_margins`), a host-side
integer size computation (:func:`processor_output_size`) and a
device-side resize + 1/255 rescale + mean/std normalization
(:func:`preprocess_for_model`).
"""

from __future__ import annotations

import math

import torch

from image_to_pointcloud_tpu_torch.models.depth_anything import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from image_to_pointcloud_tpu_torch.ops.resize import resize_batched
from image_to_pointcloud_tpu_torch.utils.constants import device_constant

__all__ = [
    "model_preprocess_spec",
    "preprocess_for_model",
    "processor_output_size",
    "reflect_pad_margins",
]


def reflect_pad_margins(cfg, h: int, w: int) -> tuple[int, int]:
    """Per-side reflect-pad margins of the working size (h, w):
    ``int(sqrt(dim/2) · pad_reflect_factor)`` for ZoeDepth, whose
    processor pads before the resize and crops the prediction back; (0, 0)
    for the families that pad nothing."""
    f = getattr(cfg, "pad_reflect_factor", 0)
    if not f:
        return 0, 0
    return int(math.sqrt(h / 2) * f), int(math.sqrt(w / 2) * f)


def model_preprocess_spec(cfg, model_target=None):
    """(target, multiple, mean, std, method, keep_aspect) of the config's
    family. The DA family has no attributes and takes the HF DPT processor
    defaults (518, multiple-of-14, ImageNet stats, PIL bicubic, keep
    aspect); DPT-classic carries a fixed square 384 with 0.5/0.5 stats,
    ZoeDepth (384, 512), multiple-of-32, 0.5/0.5 stats and align-corners
    bilinear. ``model_target`` (an int or (h, w)) overrides the target."""
    return (
        model_target if model_target is not None else getattr(cfg, "native_target", 518),
        getattr(cfg, "size_multiple", 14),
        tuple(getattr(cfg, "pixel_mean", IMAGENET_MEAN)),
        tuple(getattr(cfg, "pixel_std", IMAGENET_STD)),
        getattr(cfg, "resize_method", "bicubic_pil"),
        getattr(cfg, "keep_aspect_ratio", True),
    )


def _constrain_to_multiple_of(val: float, multiple: int, min_val: int = 0) -> int:
    x = round(val / multiple) * multiple
    if x < min_val:
        x = -(-val // multiple) * multiple
    return int(x)


def processor_output_size(
    h: int,
    w: int,
    target: int | tuple[int, int] = 518,
    multiple: int = 14,
    keep_aspect_ratio: bool = True,
) -> tuple[int, int]:
    """Resize target of the DPT-family processors (keep-aspect,
    multiple-of-N); ``target`` may be (th, tw)."""
    th, tw = (target, target) if isinstance(target, int) else target
    scale_h = th / h
    scale_w = tw / w
    if keep_aspect_ratio:
        if abs(1 - scale_w) < abs(1 - scale_h):
            scale_h = scale_w
        else:
            scale_w = scale_h
    return (
        _constrain_to_multiple_of(scale_h * h, multiple),
        _constrain_to_multiple_of(scale_w * w, multiple),
    )


def preprocess_for_model(
    images_rgb: torch.Tensor,
    out_hw: tuple[int, int],
    mean: tuple[float, ...] = IMAGENET_MEAN,
    std: tuple[float, ...] = IMAGENET_STD,
    method: str = "bicubic_pil",
) -> torch.Tensor:
    """(B, H, W, 3) uint8/float RGB → (B, mh, mw, 3) normalized f32 input."""
    x = resize_batched(images_rgb.float(), out_hw, method)
    x = x * (1.0 / 255.0)
    m = device_constant(("pixel_mean", tuple(mean)), x.device, torch.float32, lambda: mean)
    s = device_constant(("pixel_std", tuple(std)), x.device, torch.float32, lambda: std)
    return (x - m) / s
