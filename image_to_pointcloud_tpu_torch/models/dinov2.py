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
from torch.utils.checkpoint import checkpoint

from image_to_pointcloud_tpu_torch.models.attention import multi_head_attention
from image_to_pointcloud_tpu_torch.models.quantize import block_dense
from image_to_pointcloud_tpu_torch.ops.resize import resample_weights

__all__ = ["Block", "DinoV2Backbone", "DinoV2Config", "residual", "run_blocks", "tp_width"]


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
    # K1 on a CUDA tensor; False runs the plain attention on any device
    # (the trainer's models: K1 has no backward).
    use_flash_attention: bool = True
    # torch.utils.checkpoint around each block while grad is on (the
    # trainer's remat): one block's activations live at a time.
    remat_blocks: bool = False


def tp_width(n: int, tp: int, what: str) -> int:
    """``n / tp``: one model slot's share of ``n`` heads or features."""
    if n % tp:
        raise ValueError(f"{what} {n} does not split over {tp} model slots")
    return n // tp


def residual(x: torch.Tensor, y: torch.Tensor, ls: torch.Tensor | None) -> torch.Tensor:
    """``x + ls · y`` (LayerScale), or ``x + y`` where the block has none."""
    return x + (y if ls is None else ls * y)


class Mlp(nn.Module):
    def __init__(self, cfg: DinoV2Config, tp: int = 1):
        super().__init__()
        d, q = cfg.hidden_size, cfg.quantized
        hidden = tp_width(d * cfg.mlp_ratio, tp, "MLP width")
        self.fc1 = block_dense(q, d, hidden)
        self.fc2 = block_dense(q, hidden, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm block with LayerScale. ``tp > 1`` builds one of ``tp``
    megatron shards (``parallel/sharding.py``): ``num_heads / tp`` heads
    and ``mlp_width / tp`` MLP features, whose ``proj`` and ``fc2`` give
    partial sums over the model slots; :meth:`attend` and
    :meth:`mlp_hidden` are the column-parallel halves between each norm
    and those row-parallel products."""

    def __init__(self, cfg: DinoV2Config, tp: int = 1):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = tp_width(cfg.num_heads, tp, "heads")
        dl = tp_width(d, tp, "hidden size")
        self.use_flash = cfg.use_flash_attention
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.q, self.k, self.v = (block_dense(cfg.quantized, d, dl) for _ in range(3))
        self.proj = block_dense(cfg.quantized, dl, d)
        self.ls1 = nn.Parameter(torch.ones(d))
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(cfg, tp)
        self.ls2 = nn.Parameter(torch.ones(d))

    @property
    def attn_out(self) -> nn.Module:
        return self.proj

    @property
    def mlp_out(self) -> nn.Module:
        return self.mlp.fc2

    def attend(self, h):
        """Attention of ``norm1``'s output over this block's heads, before
        ``proj``."""
        return multi_head_attention(
            self.q(h), self.k(h), self.v(h), num_heads=self.num_heads,
            use_flash=self.use_flash,
        )

    def mlp_hidden(self, h):
        """The MLP's hidden activations of ``norm2``'s output, before ``fc2``."""
        return F.gelu(self.mlp.fc1(h))

    def forward(self, x):
        x = residual(x, self.proj(self.attend(self.norm1(x))), self.ls1)
        return residual(x, self.mlp.fc2(self.mlp_hidden(self.norm2(x))), self.ls2)


def run_blocks(backbone: nn.Module, x: torch.Tensor, grid: tuple[int, int]) -> list[torch.Tensor]:
    """Every encoder block of ``backbone`` in order (each under
    ``torch.utils.checkpoint`` when the config's ``remat_blocks`` is on and
    grad is enabled); the tap blocks' outputs, in tap order."""
    remat = getattr(backbone.cfg, "remat_blocks", False) and torch.is_grad_enabled()
    args = backbone.block_args(grid, x.device)
    want = set(backbone.tap_blocks)
    taps = {}
    for i, blk in enumerate(backbone.blocks):
        x = checkpoint(blk, x, *args, use_reentrant=False) if remat else blk(x, *args)
        if i in want:
            taps[i] = x
    return [taps[i] for i in backbone.tap_blocks]


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
        wr, wc = (resample_weights(cfg.pos_embed_size, n, "bicubic_torch", grid) for n in (ph, pw))
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
        x = x.reshape(b, ph * pw, p * p * 3).to(self.patch_embed.weight.dtype)
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
        return x + self._pos_embed(ph, pw)

    @property
    def tap_blocks(self) -> tuple[int, ...]:
        """0-indexed blocks whose outputs feed the neck, in its order."""
        return tuple(self.cfg.out_layers)

    def block_args(self, grid: tuple[int, int], device: torch.device) -> tuple:
        return ()

    def finalize(self, taps: list[torch.Tensor], ph: int, pw: int) -> list[torch.Tensor]:
        """Tap token sequences → (B, ph, pw, D) maps: final LayerNorm, CLS
        stripped."""
        return [
            self.norm(t)[:, 1:].reshape(t.shape[0], ph, pw, self.cfg.hidden_size) for t in taps
        ]

    def forward(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        p = self.cfg.patch_size
        grid = (pixels.shape[1] // p, pixels.shape[2] // p)
        return self.finalize(run_blocks(self, self.embed(pixels), grid), *grid)
