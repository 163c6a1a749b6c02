"""The depth-model presets, the Depth-Anything-V2 model, the family
dispatch and the deterministic random initialization.

Counterpart of ``image_to_pointcloud_tpu/models/depth_anything.py`` and of
``build_model`` in ``image_to_pointcloud_tpu/models/__init__.py``: every
preset of the JAX package, in three families (Depth-Anything-V2,
classic DPT = MiDaS 3.0, ZoeDepth). The model's dtype and device are the
torch module's own: ``.to(device, dtype)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from image_to_pointcloud_tpu_torch.models.beit import BeitConfig
from image_to_pointcloud_tpu_torch.models.dinov2 import DinoV2Backbone, DinoV2Config
from image_to_pointcloud_tpu_torch.models.dpt import DPTConfig, DPTNeckHead
from image_to_pointcloud_tpu_torch.models.dpt_classic import DPTClassic, DPTClassicConfig
from image_to_pointcloud_tpu_torch.models.vit import ViTConfig
from image_to_pointcloud_tpu_torch.models.zoedepth import ZoeDepth, ZoeDepthConfig
from image_to_pointcloud_tpu_torch.utils.constants import device_constant

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "PRESETS",
    "DepthAnything",
    "DepthAnythingConfig",
    "ModelConfig",
    "build_model",
    "init_weights",
    "normalize_pixels",
    "preset",
]

# ImageNet normalization used by the HF processor (backend/app.py:109).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    backbone: DinoV2Config = DinoV2Config()
    neck: DPTConfig = DPTConfig()

    def with_flash_attention(self, on: bool = True) -> "DepthAnythingConfig":
        """K1 in the encoder's attention (``on``), or the plain version on
        every device."""
        return dataclasses.replace(
            self, backbone=dataclasses.replace(self.backbone, use_flash_attention=on))

    def with_quantized(self, on: bool = True) -> "DepthAnythingConfig":
        """Int8 W8A8 encoder matmuls; convert a f32 model's weights with
        ``models.quantize.quantize_encoder_params``."""
        return dataclasses.replace(self, backbone=dataclasses.replace(self.backbone, quantized=on))


def _cfg(
    hidden: int,
    layers: int,
    heads: int,
    out_layers: Sequence[int],
    neck_sizes: Sequence[int],
    fusion: int,
    *,
    metric: bool = False,
    max_depth: float = 20.0,
) -> DepthAnythingConfig:
    return DepthAnythingConfig(
        backbone=DinoV2Config(
            hidden_size=hidden,
            num_layers=layers,
            num_heads=heads,
            out_layers=tuple(out_layers),
        ),
        neck=DPTConfig(
            hidden_size=hidden,
            neck_hidden_sizes=tuple(neck_sizes),
            fusion_hidden_size=fusion,
            metric_depth=metric,
            max_depth=max_depth,
        ),
    )


# DA-V2 intermediate-layer choices: S/B use blocks [2,5,8,11],
# L uses [4,11,17,23] (0-indexed).
PRESETS: dict[str, "ModelConfig"] = {
    "depth-anything-v2-small": _cfg(384, 12, 6, (2, 5, 8, 11), (48, 96, 192, 384), 64),
    "depth-anything-v2-base": _cfg(768, 12, 12, (2, 5, 8, 11), (96, 192, 384, 768), 128),
    "depth-anything-v2-large": _cfg(1024, 24, 16, (4, 11, 17, 23), (256, 512, 1024, 1024), 256),
    "depth-anything-v2-metric-small": _cfg(
        384, 12, 6, (2, 5, 8, 11), (48, 96, 192, 384), 64, metric=True
    ),
    "depth-anything-v2-metric-base": _cfg(
        768, 12, 12, (2, 5, 8, 11), (96, 192, 384, 768), 128, metric=True
    ),
}
# Canonical alias used by the reference API (`model=depth-anything-v2`).
PRESETS["depth-anything-v2"] = PRESETS["depth-anything-v2-small"]
# A labelled stand-in, as in the JAX package: MiDaS-small (v2.1,
# EfficientNet-lite) is served by the DA-class model of matching size.
PRESETS["midas-small"] = PRESETS["depth-anything-v2-small"]
# Classic DPT: 'dpt-large' is the released Intel/dpt-large layout (ViT-L/16
# at 384²), which MiDaS 3.0 is; 'dpt-base' the same at ViT-B scale.
PRESETS["dpt-large"] = DPTClassicConfig()
PRESETS["dpt-base"] = DPTClassicConfig(
    backbone=ViTConfig(hidden_size=768, num_layers=12, num_heads=12, out_layers=(2, 5, 8, 11)),
    neck_hidden_sizes=(96, 192, 384, 768),
)
PRESETS["midas"] = PRESETS["dpt-large"]
# ZoeDepth: 'zoedepth' is the released Intel/zoedepth-nyu-kitti layout
# (BEiT-L/16-384); 'zoedepth-small' the same at BEiT-base scale.
PRESETS["zoedepth"] = ZoeDepthConfig()
PRESETS["zoedepth-small"] = ZoeDepthConfig(
    backbone=BeitConfig(
        hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
        out_layers=(3, 6, 9, 12),
    ),
)

ModelConfig = DepthAnythingConfig | DPTClassicConfig | ZoeDepthConfig


def preset(name: str) -> ModelConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"Unknown model preset: {name!r}; available: {sorted(PRESETS)}"
        ) from None


class DepthAnything(nn.Module):
    """(B, H, W, 3) normalized pixels → (B, H, W) float32 relative inverse
    depth (or metric depth).

    Every family's model splits its forward the same way, for the meshed
    runners of ``parallel/``: :meth:`embed`, the backbone's blocks (its
    ``tap_blocks``, ``block_args``), :meth:`finish`."""

    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = DinoV2Backbone(cfg.backbone)
        self.neck = DPTNeckHead(cfg.neck)

    def embed(self, pixels: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """Pixels → (the encoder's input tokens, the patch grid)."""
        p = self.cfg.backbone.patch_size
        return self.backbone.embed(pixels), (pixels.shape[1] // p, pixels.shape[2] // p)

    def finish(self, taps: list[torch.Tensor], grid: tuple[int, int]) -> torch.Tensor:
        """The tap blocks' outputs → depth: everything after the encoder."""
        return self.neck(self.backbone.finalize(taps, *grid)).float()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.neck(self.backbone(pixels)).float()


def normalize_pixels(rgb01: torch.Tensor) -> torch.Tensor:
    """ImageNet mean/std normalization of (…, 3) RGB in [0, 1]."""
    mean = device_constant(("pixel_mean", tuple(IMAGENET_MEAN)), rgb01.device, torch.float32,
                           lambda: IMAGENET_MEAN)
    std = device_constant(("pixel_std", tuple(IMAGENET_STD)), rgb01.device, torch.float32,
                          lambda: IMAGENET_STD)
    return (rgb01 - mean) / std


def build_model(cfg: ModelConfig) -> nn.Module:
    """The model of the family that ``cfg`` selects."""
    if isinstance(cfg, ZoeDepthConfig):
        return ZoeDepth(cfg)
    if isinstance(cfg, DPTClassicConfig):
        return DPTClassic(cfg)
    return DepthAnything(cfg)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    # Flax's lecun_normal: a normal truncated at ±2σ, rescaled so the
    # variance is 1/fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Deterministic random init with the JAX models' initializer
    distributions (Flax's; the numbers differ, the statistics do not):
    lecun-normal matmul/conv weights, zero biases, unit LayerNorm and
    LayerScale, N(0, 0.02) CLS token and position embeddings, and for
    BEiT a zero CLS token and zero relative-position tables.

    One deviation: the relative-depth head's last 1×1 conv (``head_conv3``,
    ZoeDepth's ``rel_conv3``) takes the absolute value of its draw. Its
    inputs are ReLU outputs, so a random sign pattern makes most of the
    map negative or positive at once, and the final ReLU then flattens
    what is negative: with seed 0 it flattened nearly all of DA-V2-Small's
    and DPT-Large's maps on one torch build and less on another (torch's
    ``trunc_normal_`` draws other numbers from one seed across builds).
    Non-negative weights keep an untrained model's depth varied, so a
    flat map on a device is a fault, not luck."""
    zero_cls = isinstance(model, ZoeDepth)
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "rel_pos_table" or (leaf == "cls_token" and zero_cls):
            nn.init.zeros_(prm)
        elif leaf in ("cls_token", "pos_embed"):
            nn.init.normal_(prm, std=0.02, generator=gen)
        elif leaf in ("ls1", "ls2"):
            nn.init.ones_(prm)
        elif leaf == "bias":
            nn.init.zeros_(prm)
    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
        elif isinstance(mod, nn.ConvTranspose2d):  # weight (in, out, k, k)
            _lecun_normal_(mod.weight, mod.weight.shape[0] * mod.weight[0, 0].numel(), gen)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):  # weight (out, in, ...)
            _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
    for name, mod in model.named_modules():
        if name.rsplit(".", 1)[-1] in ("head_conv3", "rel_conv3"):
            mod.weight.abs_()
    return model
