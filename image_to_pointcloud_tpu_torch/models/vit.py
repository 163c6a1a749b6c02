"""Plain ViT backbone — the encoder of classic DPT (MiDaS 3.0).

Counterpart of ``image_to_pointcloud_tpu/models/vit.py`` (HF
``modeling_dpt``'s internal ViT). It differs from
:class:`~image_to_pointcloud_tpu_torch.models.dinov2.DinoV2Backbone` in
exactly these places:

* no LayerScale (plain residual adds),
* LayerNorm eps 1e-12,
* position embeddings resampled with torch *bilinear* (align_corners
  False) over the patch grid, the CLS slot left as it is,
* the tap layers return the raw token sequence, CLS included and with no
  final LayerNorm: classic DPT's readout projection consumes the CLS.

Attention goes through :func:`.attention.multi_head_attention`, the CUDA
flash kernel on the GPU (head dim 64 for ViT-L/16 and ViT-B/16).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from image_to_pointcloud_tpu_torch.models.dinov2 import Block, Mlp, run_blocks, tp_width
from image_to_pointcloud_tpu_torch.models.quantize import block_dense
from image_to_pointcloud_tpu_torch.ops.resize import resample_weights

__all__ = ["ViTBackbone", "ViTBlock", "ViTConfig"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 16
    pos_embed_size: int = 24  # side of the native position-embedding grid
    layer_norm_eps: float = 1e-12
    out_layers: Sequence[int] = (5, 11, 17, 23)  # 0-indexed block outputs
    quantized: bool = False  # int8 W8A8 block matmuls (models/quantize.py)
    # K1 on a CUDA tensor; False runs the plain attention on any device
    # (the trainer's models: K1 has no backward).
    use_flash_attention: bool = True
    # torch.utils.checkpoint around each block while grad is on (the
    # trainer's remat): one block's activations live at a time.
    remat_blocks: bool = False


class ViTBlock(nn.Module):
    """Pre-LN block (``modeling_dpt.DPTViTLayer``): LN → MHA → +residual,
    LN → MLP → +residual. ``tp`` as :class:`.dinov2.Block`'s."""

    ls1 = ls2 = None  # no LayerScale

    def __init__(self, cfg: ViTConfig, tp: int = 1):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = tp_width(cfg.num_heads, tp, "heads")
        dl = tp_width(d, tp, "hidden size")
        self.use_flash = cfg.use_flash_attention
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.q, self.k, self.v = (block_dense(cfg.quantized, d, dl) for _ in range(3))
        self.proj = block_dense(cfg.quantized, dl, d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(cfg, tp)

    attn_out = Block.attn_out
    mlp_out = Block.mlp_out
    attend = Block.attend
    mlp_hidden = Block.mlp_hidden

    def forward(self, x):
        x = x + self.proj(self.attend(self.norm1(x)))
        return x + self.mlp.fc2(self.mlp_hidden(self.norm2(x)))


class ViTBackbone(nn.Module):
    """(B, H, W, 3) normalized pixels → one (B, 1+ph·pw, D) token
    sequence per configured tap layer, CLS included."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = nn.Linear(p * p * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.pos_embed_size * cfg.pos_embed_size + 1, d)
        )
        self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.num_layers))

    def _pos_embed(self, ph: int, pw: int) -> torch.Tensor:
        cfg = self.cfg
        pos = self.pos_embed
        if ph == cfg.pos_embed_size and pw == cfg.pos_embed_size:
            return pos
        # Resampled in f32 whatever the model dtype, CLS slot untouched.
        grid = pos[0, 1:].float().reshape(cfg.pos_embed_size, cfg.pos_embed_size, -1)
        wr, wc = (resample_weights(cfg.pos_embed_size, n, "linear", grid) for n in (ph, pw))
        grid = torch.einsum("oi,iwc->owc", wr, grid)
        grid = torch.einsum("oj,hjc->hoc", wc, grid)
        return torch.cat(
            [pos[:, :1].float(), grid.reshape(1, ph * pw, cfg.hidden_size)], dim=1
        ).to(pos.dtype)

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels → (B, 1+ph·pw, D) tokens."""
        b, h, w, _ = pixels.shape
        p = self.cfg.patch_size
        ph, pw = h // p, w // p
        x = pixels.reshape(b, ph, p, pw, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(b, ph * pw, p * p * 3).to(self.patch_embed.weight.dtype))
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
        return x + self._pos_embed(ph, pw)

    @property
    def tap_blocks(self) -> tuple[int, ...]:
        return tuple(self.cfg.out_layers)

    def block_args(self, grid: tuple[int, int], device: torch.device) -> tuple:
        return ()

    def forward(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        p = self.cfg.patch_size
        grid = (pixels.shape[1] // p, pixels.shape[2] // p)
        return run_blocks(self, self.embed(pixels), grid)
