"""Classic DPT (= MiDaS 3.0): plain ViT encoder + readout-project DPT
neck + monodepth head.

Counterpart of ``image_to_pointcloud_tpu/models/dpt_classic.py`` (HF
``modeling_dpt``, the layout of the released ``Intel/dpt-large``). Against
the Depth-Anything neck (:mod:`.dpt`):

* readout "project": each tap keeps its CLS token; per stage the CLS is
  concatenated to every patch token and projected back to the hidden
  width, Linear(2D→D) + exact GELU,
* every fusion step is an exact ×2 (align_corners=True) of the
  accumulated map, 1×1 projection after (``_FusionLayer`` with
  ``out_hw=None``),
* head: 3×3 conv (F→F/2) → exact ×2 align-corners bilinear → 3×3 conv
  (→32) → ReLU → 1×1 conv (→1) → ReLU.

The preprocess attributes are the ``Intel/dpt-large`` processor's: a
fixed 384² PIL-bicubic resize (aspect ratio not kept), mean = std = 0.5.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_to_pointcloud_tpu_torch.models.dpt import _conv3, _FusionLayer
from image_to_pointcloud_tpu_torch.models.vit import ViTBackbone, ViTConfig
from image_to_pointcloud_tpu_torch.ops.resize import resize_planes

__all__ = ["DPTClassic", "DPTClassicConfig"]


@dataclasses.dataclass(frozen=True)
class _RelativeNeckInfo:
    """The ``cfg.neck`` view of a relative-depth model, for readers of
    ``cfg.neck.metric_depth`` (the CLI, ``MetricPipeline``)."""

    metric_depth: bool = False
    max_depth: float = 1.0


@dataclasses.dataclass(frozen=True)
class DPTClassicConfig:
    backbone: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    neck_hidden_sizes: Sequence[int] = (256, 512, 1024, 1024)
    fusion_hidden_size: int = 256
    head_hidden_size: int = 32
    pixel_mean: Sequence[float] = (0.5, 0.5, 0.5)
    pixel_std: Sequence[float] = (0.5, 0.5, 0.5)
    native_target: int = 384
    size_multiple: int = 16
    keep_aspect_ratio: bool = False
    resize_method: str = "bicubic_pil"

    @property
    def neck(self) -> _RelativeNeckInfo:
        """Relative depth: ``metric_depth`` is False, as a DA-V2 config's
        neck says."""
        return _RelativeNeckInfo()

    def with_flash_attention(self, on: bool = True) -> "DPTClassicConfig":
        """K1 in the encoder's attention (``on``), or the plain version on
        every device."""
        return dataclasses.replace(
            self, backbone=dataclasses.replace(self.backbone, use_flash_attention=on))

    def with_quantized(self, on: bool = True) -> "DPTClassicConfig":
        """Int8 W8A8 encoder matmuls (``models.quantize``)."""
        return dataclasses.replace(self, backbone=dataclasses.replace(self.backbone, quantized=on))


class _ClassicNeckHead(nn.Module):
    """Tap token sequences (CLS included) → relative inverse depth."""

    def __init__(self, cfg: DPTClassicConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.backbone.hidden_size
        c = cfg.neck_hidden_sizes
        f = cfg.fusion_hidden_size
        for i in range(4):
            setattr(self, f"readout{i}", nn.Linear(2 * d, d))
            setattr(self, f"proj{i}", nn.Conv2d(d, c[i], 1))
            setattr(self, f"conv{i}", _conv3(c[i], f, bias=False))
        self.up0 = nn.ConvTranspose2d(c[0], c[0], 4, stride=4)
        self.up1 = nn.ConvTranspose2d(c[1], c[1], 2, stride=2)
        self.down3 = nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)
        for j in range(4):
            setattr(self, f"fusion{j}", _FusionLayer(f, has_residual=j > 0))
        self.head_conv1 = _conv3(f, f // 2)
        self.head_conv2 = _conv3(f // 2, cfg.head_hidden_size)
        self.head_conv3 = nn.Conv2d(cfg.head_hidden_size, 1, 1)

    def forward(self, taps: list[torch.Tensor], grid_hw: tuple[int, int]) -> torch.Tensor:
        ph, pw = grid_hw
        resize = {0: self.up0, 1: self.up1, 3: self.down3}
        stages = []
        for i, t in enumerate(taps):
            cls, tok = t[:, :1], t[:, 1:]
            x = torch.cat([tok, cls.expand_as(tok)], dim=-1)
            x = F.gelu(getattr(self, f"readout{i}")(x))
            x = x.transpose(1, 2).reshape(x.shape[0], -1, ph, pw)
            x = getattr(self, f"proj{i}")(x)
            if i in resize:
                x = resize[i](x)
            stages.append(getattr(self, f"conv{i}")(x))

        fused = None
        for idx, hs in enumerate(stages[::-1]):
            layer = getattr(self, f"fusion{idx}")
            fused = layer(hs) if fused is None else layer(fused, hs)

        x = self.head_conv1(fused)
        x = resize_planes(x, (x.shape[-2] * 2, x.shape[-1] * 2), "linear_ac")
        x = self.head_conv3(torch.relu(self.head_conv2(x)))
        return torch.relu(x)[:, 0]


class DPTClassic(nn.Module):
    """(B, H, W, 3) normalized pixels → (B, H, W) f32 relative inverse
    depth (H, W multiples of the patch size, even patch grids)."""

    def __init__(self, cfg: DPTClassicConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViTBackbone(cfg.backbone)
        self.neck = _ClassicNeckHead(cfg)

    def embed(self, pixels: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        p = self.cfg.backbone.patch_size
        return self.backbone.embed(pixels), (pixels.shape[1] // p, pixels.shape[2] // p)

    def finish(self, taps: list[torch.Tensor], grid: tuple[int, int]) -> torch.Tensor:
        return self.neck(taps, grid).float()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        p = self.cfg.backbone.patch_size
        return self.finish(self.backbone(pixels), (pixels.shape[1] // p, pixels.shape[2] // p))
