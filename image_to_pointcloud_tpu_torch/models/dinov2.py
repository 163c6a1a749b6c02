"""DINOv2 ViT backbone — the encoder of the Depth-Anything family.

Counterpart of ``image_to_pointcloud_tpu/models/dinov2.py``: NHWC pixels
in, patchify + one matrix product as the 14×14/stride-14 patch embedding
(weights laid out (p·p·3) → D in (row, col, channel) order), bicubic
(torch a=-0.75) resampling of the position embeddings for non-native
grids, pre-norm blocks with LayerScale and exact GELU, the final
LayerNorm applied to each tap layer, CLS stripped from the returned
feature maps. Attention goes through :mod:`.attention` (the CUDA flash
kernel on the GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_to_pointcloud_tpu_torch.models.attention import multi_head_attention
from image_to_pointcloud_tpu_torch.models.quantize import block_dense
from image_to_pointcloud_tpu_torch.ops.resize import resample_matrix

__all__ = ["DinoV2Config", "DinoV2Backbone"]


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    pos_embed_size: int = 37  # side of the native position-embedding grid
    layer_norm_eps: float = 1e-6
    out_layers: Sequence[int] = (2, 5, 8, 11)  # 0-indexed block outputs
    quantized: bool = False  # int8 W8A8 block matmuls (models/quantize.py)


class Mlp(nn.Module):
    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        d, q = cfg.hidden_size, cfg.quantized
        self.fc1 = block_dense(q, d, d * cfg.mlp_ratio)
        self.fc2 = block_dense(q, d * cfg.mlp_ratio, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.q, self.k, self.v, self.proj = (block_dense(cfg.quantized, d, d) for _ in range(4))
        self.ls1 = nn.Parameter(torch.ones(d))
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(cfg)
        self.ls2 = nn.Parameter(torch.ones(d))

    def forward(self, x):
        h = self.norm1(x)
        h = multi_head_attention(
            self.q(h), self.k(h), self.v(h), num_heads=self.num_heads
        )
        x = x + self.ls1 * self.proj(h)
        return x + self.ls2 * self.mlp(self.norm2(x))


class DinoV2Backbone(nn.Module):
    """(B, H, W, 3) normalized pixels → feature maps (B, h, w, D), one per
    configured output layer."""

    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = nn.Linear(p * p * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.pos_embed_size * cfg.pos_embed_size + 1, d)
        )
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def _pos_embed(self, ph: int, pw: int) -> torch.Tensor:
        cfg = self.cfg
        pos = self.pos_embed
        if ph == cfg.pos_embed_size and pw == cfg.pos_embed_size:
            return pos
        # Resampled in f32 whatever the model dtype, CLS slot untouched.
        grid = pos[0, 1:].float().reshape(cfg.pos_embed_size, cfg.pos_embed_size, -1)
        wr = torch.from_numpy(resample_matrix(cfg.pos_embed_size, ph, "bicubic_torch"))
        wc = torch.from_numpy(resample_matrix(cfg.pos_embed_size, pw, "bicubic_torch"))
        grid = torch.einsum("oi,iwc->owc", wr.to(grid.device), grid)
        grid = torch.einsum("oj,hjc->hoc", wc.to(grid.device), grid)
        return torch.cat(
            [pos[:, :1].float(), grid.reshape(1, ph * pw, cfg.hidden_size)], dim=1
        ).to(pos.dtype)

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels → (B, 1+ph·pw, D) tokens."""
        b, h, w, _ = pixels.shape
        p = self.cfg.patch_size
        ph, pw = h // p, w // p
        x = pixels.reshape(b, ph, p, pw, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, ph * pw, p * p * 3).to(self.patch_embed.weight.dtype)
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
        return x + self._pos_embed(ph, pw)

    def forward(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        cfg = self.cfg
        b = pixels.shape[0]
        ph, pw = pixels.shape[1] // cfg.patch_size, pixels.shape[2] // cfg.patch_size
        x = self.embed(pixels)
        taps = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cfg.out_layers:
                taps[i] = x
        return [
            self.norm(taps[i])[:, 1:].reshape(b, ph, pw, cfg.hidden_size)
            for i in cfg.out_layers
        ]
