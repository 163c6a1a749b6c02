"""Depth models in PyTorch: the DINOv2 / ViT / BEiT backbones, the DPT
necks, ZoeDepth's metric bins, the SegFormer matte, and the checkpoint
converters.

Counterpart of ``image_to_pointcloud_tpu/models/__init__.py``: the same
package-level names, with ``build_model`` and ``convert_checkpoint``
defined in ``depth_anything.py`` and ``convert.py``. Every submodule
imports torch and the port's ``ops`` only, so importing this package
pulls in no pipeline or server module.
"""

from image_to_pointcloud_tpu_torch.models.attention import flash_attention, multi_head_attention
from image_to_pointcloud_tpu_torch.models.beit import BeitBackbone, BeitConfig
from image_to_pointcloud_tpu_torch.models.convert import (
    convert_checkpoint,
    convert_depth_anything,
    convert_dpt_classic,
    convert_segformer,
    convert_zoedepth,
    load_safetensors,
)
from image_to_pointcloud_tpu_torch.models.depth_anything import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    PRESETS,
    DepthAnything,
    DepthAnythingConfig,
    build_model,
    normalize_pixels,
    preset,
)
from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Backbone, DinoV2Config
from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig, DPTNeckHead
from image_to_pointcloud_tpu_torch.models.dpt_classic import DPTClassic, DPTClassicConfig
from image_to_pointcloud_tpu_torch.models.segformer import (
    SegformerConfig,
    SegformerMatte,
    segformer_b0,
)
from image_to_pointcloud_tpu_torch.models.vit import ViTBackbone, ViTConfig
from image_to_pointcloud_tpu_torch.models.zoedepth import ZoeDepth, ZoeDepthConfig

__all__ = [
    "flash_attention",
    "multi_head_attention",
    "convert_depth_anything",
    "load_safetensors",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "PRESETS",
    "DepthAnything",
    "DepthAnythingConfig",
    "normalize_pixels",
    "preset",
    "DinoV2Backbone",
    "DinoV2Config",
    "DPTConfig",
    "DPTNeckHead",
    "BeitBackbone",
    "BeitConfig",
    "ZoeDepth",
    "ZoeDepthConfig",
    "convert_zoedepth",
    "SegformerConfig",
    "SegformerMatte",
    "segformer_b0",
    "convert_segformer",
    "DPTClassic",
    "DPTClassicConfig",
    "convert_dpt_classic",
    "ViTBackbone",
    "ViTConfig",
    "build_model",
    "convert_checkpoint",
]
