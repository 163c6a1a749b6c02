"""DPT neck + depth head (Depth-Anything variant).

Counterpart of ``image_to_pointcloud_tpu/models/dpt.py``. Feature maps
come in NHWC as the encoder returns them and run NCHW inside:

* reassemble: 1×1 projection to the per-stage widths, then ×4 / ×2
  transposed convolutions with kernel == stride (the JAX package's
  ``_UpsampleMatmul``: weight ``K.transpose(2, 3, 0, 1)``), identity, or
  a stride-2 3×3 downsample,
* per-stage 3×3 convs (no bias) to the fusion width,
* RefineNet fusion: pre-activation residual units, align-corners
  bilinear upsampling (the separable resampler), 1×1 projection,
* head: 3×3 conv → upsample to patch_size×grid → 3×3 conv → ReLU →
  1×1 conv → ReLU (relative) or sigmoid·max_depth (metric).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from image_to_pointcloud_tpu_torch.ops.resize import resize_planes

__all__ = ["DPTConfig", "DPTNeckHead"]


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    hidden_size: int = 384
    neck_hidden_sizes: Sequence[int] = (48, 96, 192, 384)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    patch_size: int = 14
    metric_depth: bool = False  # metric (ZoeDepth-class) vs relative output
    max_depth: float = 1.0


def _conv3(cin: int, cout: int, **kw) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, **kw)


class _PreActResidual(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = _conv3(c, c)
        self.conv2 = _conv3(c, c)

    def forward(self, x):
        h = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        return x + h


class _FusionLayer(nn.Module):
    def __init__(self, c: int, has_residual: bool):
        super().__init__()
        if has_residual:
            self.res1 = _PreActResidual(c)
        self.res2 = _PreActResidual(c)
        self.projection = nn.Conv2d(c, c, 1)

    def forward(self, x, residual=None, out_hw=None):
        if residual is not None:
            if residual.shape[-2:] != x.shape[-2:]:
                residual = resize_planes(residual, tuple(x.shape[-2:]), "linear")
            x = x + self.res1(residual)
        x = self.res2(x)
        if out_hw is None:
            out_hw = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.projection(resize_planes(x, tuple(out_hw), "linear_ac"))


class DPTNeckHead(nn.Module):
    """Feature maps (4× (B, h, w, D) NHWC, shallow→deep) → depth (B, H, W)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.neck_hidden_sizes
        f = cfg.fusion_hidden_size
        for i in range(4):
            setattr(self, f"proj{i}", nn.Conv2d(cfg.hidden_size, c[i], 1))
            setattr(self, f"conv{i}", _conv3(c[i], f, bias=False))
        self.up0 = nn.ConvTranspose2d(c[0], c[0], 4, stride=4)
        self.up1 = nn.ConvTranspose2d(c[1], c[1], 2, stride=2)
        self.down3 = nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)
        for j in range(4):
            setattr(self, f"fusion{j}", _FusionLayer(f, has_residual=j > 0))
        self.head_conv1 = _conv3(f, f // 2)
        self.head_conv2 = _conv3(f // 2, cfg.head_hidden_size)
        self.head_conv3 = nn.Conv2d(cfg.head_hidden_size, 1, 1)

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        ph, pw = feats[0].shape[1], feats[0].shape[2]
        resize = {0: self.up0, 1: self.up1, 3: self.down3}
        stages = []
        for i, f in enumerate(feats):
            x = getattr(self, f"proj{i}")(f.permute(0, 3, 1, 2))
            if i in resize:
                x = resize[i](x)
            stages.append(getattr(self, f"conv{i}")(x))

        # Fusion: deepest → shallowest, each upsampled to the next size.
        deep_to_shallow = stages[::-1]
        fused = None
        for idx, hs in enumerate(deep_to_shallow):
            last = idx == len(deep_to_shallow) - 1
            out_hw = None if last else deep_to_shallow[idx + 1].shape[-2:]
            layer = getattr(self, f"fusion{idx}")
            fused = layer(hs, out_hw=out_hw) if fused is None else layer(
                fused, hs, out_hw=out_hw
            )

        x = self.head_conv1(fused)
        x = resize_planes(x, (ph * cfg.patch_size, pw * cfg.patch_size), "linear_ac")
        x = self.head_conv3(torch.relu(self.head_conv2(x)))
        if cfg.metric_depth:
            x = torch.sigmoid(x) * cfg.max_depth
        else:
            x = torch.relu(x)
        return x[:, 0]
