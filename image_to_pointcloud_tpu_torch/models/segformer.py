"""SegFormer (MiT encoder + all-MLP decode head) — the learned
background-matting model of the v2 processor.

Counterpart of ``image_to_pointcloud_tpu/models/segformer.py``, with its
module names (so :func:`.bridge.state_dict_from_flax` carries a Flax tree
across by name) and its arithmetic, in f32. Pixels come in NHWC and the
logits go out NHWC, as in the JAX package; inside, convolutions run NCHW
and the transformer blocks on (B, N, D) tokens in row-major (h, w) order:

* 4 stages of overlapped patch-embed convs (padding p // 2, stride s) +
  LayerNorm (eps 1e-6),
* pre-norm blocks: spatially reduced attention (an sr×sr, stride-sr,
  VALID conv + ``sr_norm`` on the keys and values when sr > 1), then
  Mix-FFN (dense → 3×3 depthwise conv, ``groups=hidden`` → exact GELU →
  dense), and a final LayerNorm per stage,
* the decode head: each stage projected to a common width, resized to
  stage 1's (H/4, W/4) with the port's ``"linear"`` resampler, the
  stages concatenated deepest first, a bias-free 1×1 fuse conv, a frozen
  BatchNorm in f32, ReLU and a 1×1 classifier.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_to_pointcloud_tpu_torch.ops.resize import resize_planes

__all__ = ["SegformerConfig", "SegformerMatte", "segformer_b0"]


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    hidden_sizes: Sequence[int] = (32, 64, 160, 256)
    depths: Sequence[int] = (2, 2, 2, 2)
    num_heads: Sequence[int] = (1, 2, 5, 8)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    patch_sizes: Sequence[int] = (7, 3, 3, 3)
    strides: Sequence[int] = (4, 2, 2, 2)
    mlp_ratios: Sequence[int] = (4, 4, 4, 4)
    decoder_hidden_size: int = 256
    num_labels: int = 1
    layer_norm_eps: float = 1e-6
    batch_norm_eps: float = 1e-5


def segformer_b0(num_labels: int = 1) -> SegformerConfig:
    """MiT-B0 (the 3.7M-param small trunk; nvidia/mit-b0 layout)."""
    return SegformerConfig(num_labels=num_labels)


def _tokens_to_grid(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(B, h·w, C) row-major tokens → (B, C, h, w)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *hw)


def _grid_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) → (B, h·w, C)."""
    return x.flatten(2).transpose(1, 2)


class _EfficientAttention(nn.Module):
    def __init__(self, cfg: SegformerConfig, stage: int):
        super().__init__()
        d = cfg.hidden_sizes[stage]
        self.heads = cfg.num_heads[stage]
        self.q, self.k, self.v, self.proj = (nn.Linear(d, d) for _ in range(4))
        sr = cfg.sr_ratios[stage]
        if sr > 1:
            self.sr = nn.Conv2d(d, d, sr, stride=sr)  # VALID
            self.sr_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        b, n, d = x.shape
        dh = d // self.heads
        q = self.q(x)
        kv_in = x
        if hasattr(self, "sr"):
            kv_in = self.sr_norm(_grid_to_tokens(self.sr(_tokens_to_grid(x, hw))))
        k, v = self.k(kv_in), self.v(kv_in)
        m = kv_in.shape[1]
        q = q.reshape(b, n, self.heads, dh).transpose(1, 2)
        k = k.reshape(b, m, self.heads, dh).transpose(1, 2)
        v = v.reshape(b, m, self.heads, dh).transpose(1, 2)
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, d)
        return self.proj(out)


class _MixFFN(nn.Module):
    def __init__(self, cfg: SegformerConfig, stage: int):
        super().__init__()
        d = cfg.hidden_sizes[stage]
        hidden = int(d * cfg.mlp_ratios[stage])
        self.fc1 = nn.Linear(d, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        x = _grid_to_tokens(self.dwconv(_tokens_to_grid(self.fc1(x), hw)))
        return self.fc2(F.gelu(x))


class _Block(nn.Module):
    def __init__(self, cfg: SegformerConfig, stage: int):
        super().__init__()
        d = cfg.hidden_sizes[stage]
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = _EfficientAttention(cfg, stage)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _MixFFN(cfg, stage)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x), hw)


class _FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over NCHW channels: ``x·inv + (bias −
    mean·inv)`` with ``inv = weight·rsqrt(var + eps)``, in f32. The running
    statistics are buffers named as the Flax leaves (``mean``, ``var``)."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight.float() * torch.rsqrt(self.var.float() + self.eps)
        shift = self.bias.float() - self.mean.float() * inv
        return x.float() * inv[:, None, None] + shift[:, None, None]


class SegformerMatte(nn.Module):
    """(B, H, W, 3) normalized pixels → (B, H/4, W/4, num_labels) f32
    logits."""

    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        self.cfg = cfg
        cin = 3
        for s in range(4):
            d, p = cfg.hidden_sizes[s], cfg.patch_sizes[s]
            self.add_module(f"embed{s}", nn.Conv2d(cin, d, p, stride=cfg.strides[s], padding=p // 2))
            self.add_module(f"embed_norm{s}", nn.LayerNorm(d, eps=cfg.layer_norm_eps))
            for j in range(cfg.depths[s]):
                self.add_module(f"stage{s}_block{j}", _Block(cfg, s))
            self.add_module(f"stage_norm{s}", nn.LayerNorm(d, eps=cfg.layer_norm_eps))
            self.add_module(f"linear_c{s}", nn.Linear(d, cfg.decoder_hidden_size))
            cin = d
        dec = cfg.decoder_hidden_size
        self.linear_fuse = nn.Conv2d(4 * dec, dec, 1, bias=False)
        self.bn = _FrozenBatchNorm(dec, cfg.batch_norm_eps)
        self.classifier = nn.Conv2d(dec, cfg.num_labels, 1)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = pixels.float().permute(0, 3, 1, 2)
        feats = []
        for s in range(4):
            x = getattr(self, f"embed{s}")(x)
            hw = tuple(x.shape[2:])
            t = getattr(self, f"embed_norm{s}")(_grid_to_tokens(x))
            for j in range(cfg.depths[s]):
                t = getattr(self, f"stage{s}_block{j}")(t, hw)
            x = _tokens_to_grid(getattr(self, f"stage_norm{s}")(t), hw)
            feats.append(x)

        # All-MLP decode head at stage 1's resolution (H/4, W/4).
        out_hw = tuple(feats[0].shape[2:])
        proj = []
        for s, f in enumerate(feats):
            p = getattr(self, f"linear_c{s}")(f.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            if tuple(p.shape[2:]) != out_hw:
                p = resize_planes(p, out_hw, "linear")
            proj.append(p)
        # torch concatenates reversed (deepest stage first).
        fused = self.linear_fuse(torch.cat(proj[::-1], dim=1))
        fused = torch.relu(self.bn(fused))
        return self.classifier(fused).permute(0, 2, 3, 1).float()
