"""Model-input preprocessing with HF DPT image-processor semantics.

Counterpart of ``image_to_pointcloud_tpu/pipeline/preprocess.py`` for the
Depth-Anything family: a host-side integer size computation
(:func:`processor_output_size`: keep aspect, multiples of 14, target 518)
and a device-side PIL-bicubic resize + 1/255 rescale + ImageNet
normalization (:func:`preprocess_for_model`).
"""

from __future__ import annotations

import torch

from image_to_pointcloud_tpu_torch.models.depth_anything import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from image_to_pointcloud_tpu_torch.ops.resize import resize_batched

__all__ = ["model_preprocess_spec", "preprocess_for_model", "processor_output_size"]


def model_preprocess_spec(cfg, model_target=None):
    """(target, multiple, mean, std, method, keep_aspect) of the DA family:
    the HF DPT processor defaults (518, multiple-of-14, ImageNet stats,
    PIL-bicubic resize, keep aspect ratio); ``model_target`` overrides the
    518 target."""
    return (
        518 if model_target is None else model_target,
        cfg.backbone.patch_size,
        IMAGENET_MEAN,
        IMAGENET_STD,
        "bicubic_pil",
        True,
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
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s
