"""BEiT vision transformer — ZoeDepth's encoder.

Counterpart of ``image_to_pointcloud_tpu/models/beit.py`` (HF
``modeling_beit``, the layout of the released ``Intel/zoedepth-nyu-kitti``):
pre-norm blocks with LayerScale, a query/value-biased and key-unbiased
attention, and a per-layer relative position bias added to the logits
(no absolute position embeddings). Off the native window the bias table
is resampled with HF's bilinear re-interpolation, its (width, height)
reshape quirk included.

The attention with its additive bias is plain torch ops on every device:
the JAX package computes it outside any Pallas kernel, and the flash
kernel (K1) takes no bias. It rounds where the JAX code rounds: f32
logits plus the f32 bias, an f32 softmax, the probabilities rounded to
the model dtype, P·V accumulated in f32 and then rounded.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_to_pointcloud_tpu_torch.models.dinov2 import residual, run_blocks, tp_width
from image_to_pointcloud_tpu_torch.models.quantize import block_dense
from image_to_pointcloud_tpu_torch.ops.resize import resize_batched

__all__ = ["BeitBackbone", "BeitConfig", "relative_position_index"]


@dataclasses.dataclass(frozen=True)
class BeitConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    # Native patch-grid side of the relative-position tables (24 for the
    # released BEiT-L/16-384).
    window_size: int = 24
    layer_norm_eps: float = 1e-12
    layer_scale: bool = True  # ls1 / ls2 (HF's lambda_1 / lambda_2)
    out_layers: Sequence[int] = (6, 12, 18, 24)  # 1-indexed stage outputs
    quantized: bool = False  # int8 W8A8 block matmuls (models/quantize.py)


@functools.lru_cache(maxsize=16)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww+1, wh*ww+1) int32 index into a (2wh-1)(2ww-1)+3 table.

    HF ``BeitRelativePositionBias.generate_relative_position_index``:
    entry [i, j] is the bucket of the relative offset between patches i
    and j; the last 3 buckets are cls→token, token→cls and cls→cls.
    """
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(
        np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    idx = np.zeros((wh * ww + 1, wh * ww + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, :] = num_rel - 3
    idx[:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx.astype(np.int32)


def _interp_bias_table(
    table: torch.Tensor, old_w: tuple[int, int], new_w: tuple[int, int]
) -> torch.Tensor:
    """HF's table re-interpolation for another window: the (2wh-1)(2ww-1)
    spatial part resampled bilinearly (align_corners=False) in f32, the 3
    CLS buckets kept. HF reshapes the flat table as (width, height),
    transposed against the index layout, and resizes that to
    (new_height, new_width); so does this."""
    oh, ow = 2 * old_w[0] - 1, 2 * old_w[1] - 1
    nh, nw = 2 * new_w[0] - 1, 2 * new_w[1] - 1
    heads = table.shape[-1]
    spatial = table[: oh * ow].float().reshape(1, ow, oh, heads)
    spatial = resize_batched(spatial, (nh, nw), "linear").reshape(nh * nw, heads)
    return torch.cat([spatial, table[oh * ow :].float()], dim=0)


class _BeitAttention(nn.Module):
    def __init__(self, cfg: BeitConfig, tp: int = 1):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = tp_width(cfg.num_heads, tp, "heads")
        dl = tp_width(d, tp, "hidden size")
        self.window = (cfg.window_size, cfg.window_size)
        q = cfg.quantized
        self.q = block_dense(q, d, dl)
        self.k = block_dense(q, d, dl, bias=False)  # BEiT's key has no bias
        self.v = block_dense(q, d, dl)
        self.proj = block_dense(q, dl, d)
        num_rel = (2 * cfg.window_size - 1) ** 2 + 3
        # A model slot's table holds its own heads' columns.
        self.rel_pos_table = nn.Parameter(torch.zeros(num_rel, self.num_heads))
        self._table_cache: tuple | None = None

    def _bias(self, grid: tuple[int, int], index: torch.Tensor) -> torch.Tensor:
        """(1, H, N, N) f32 relative position bias for a patch grid.

        Without autograd the (H, buckets) table for the grid is cached,
        keyed on the parameter's storage and version, so a served model
        resamples it once per grid; the gather runs every forward."""
        t = self.rel_pos_table
        key = (grid, t.data_ptr(), t._version)
        if self._table_cache is not None and self._table_cache[0] == key:
            table = self._table_cache[1]
        else:
            table = t.float()
            if grid != self.window:
                table = _interp_bias_table(table, self.window, grid)
            table = table.T.contiguous()
            if not torch.is_grad_enabled():
                self._table_cache = (key, table)
        return table[:, index][None]

    def attend(self, x: torch.Tensor, grid: tuple[int, int], index: torch.Tensor):
        """Biased attention over this module's heads, before ``proj``."""
        b, n, _ = x.shape
        h = self.num_heads
        q, k, v = self.q(x), self.k(x), self.v(x)
        dl = q.shape[-1]
        dh = dl // h

        def split(y):
            return y.reshape(b, n, h, dh).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
        probs = torch.softmax(scores + self._bias(grid, index), dim=-1).to(x.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        return out.transpose(1, 2).reshape(b, n, dl)

    def forward(self, x: torch.Tensor, grid: tuple[int, int], index: torch.Tensor):
        return self.proj(self.attend(x, grid, index))


class BeitBlock(nn.Module):
    """Pre-norm block with LayerScale (none, ``ls1 = ls2 = None``, where
    ``cfg.layer_scale`` is off); ``tp`` as :class:`.dinov2.Block`'s (the
    relative-position table split on its head dim)."""

    def __init__(self, cfg: BeitConfig, tp: int = 1):
        super().__init__()
        d = cfg.hidden_size
        hidden = tp_width(cfg.intermediate_size, tp, "MLP width")
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = _BeitAttention(cfg, tp)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = block_dense(cfg.quantized, d, hidden)
        self.fc2 = block_dense(cfg.quantized, hidden, d)
        ls = cfg.layer_scale
        self.ls1 = nn.Parameter(torch.ones(d)) if ls else None
        self.ls2 = nn.Parameter(torch.ones(d)) if ls else None

    @property
    def attn_out(self) -> nn.Module:
        return self.attn.proj

    @property
    def mlp_out(self) -> nn.Module:
        return self.fc2

    def attend(self, h, grid, index):
        return self.attn.attend(h, grid, index)

    def mlp_hidden(self, h):
        return F.gelu(self.fc1(h))

    def forward(self, x, grid, index):
        x = residual(x, self.attn(self.norm1(x), grid, index), self.ls1)
        return residual(x, self.fc2(self.mlp_hidden(self.norm2(x))), self.ls2)


class BeitBackbone(nn.Module):
    """(B, H, W, 3) normalized pixels → one (B, 1+gh·gw, D) f32 token
    sequence per configured stage, CLS included."""

    def __init__(self, cfg: BeitConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = nn.Linear(p * p * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.blocks = nn.ModuleList(BeitBlock(cfg) for _ in range(cfg.num_layers))
        self._index: dict = {}

    def _rel_index(self, grid: tuple[int, int], device: torch.device) -> torch.Tensor:
        key = (grid, device)
        if key not in self._index:
            self._index[key] = torch.from_numpy(
                relative_position_index(*grid).astype(np.int64)
            ).to(device)
        return self._index[key]

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels → (B, 1+gh·gw, D) tokens."""
        cfg = self.cfg
        b, hh, ww, _ = pixels.shape
        p = cfg.patch_size
        grid = (hh // p, ww // p)
        dtype = self.patch_embed.weight.dtype
        x = pixels.reshape(b, grid[0], p, grid[1], p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, grid[0] * grid[1], p * p * 3).to(dtype)
        # The patch matmul accumulates in f32 and adds the bias before the
        # one rounding to the model dtype.
        x = torch.matmul(x.float(), self.patch_embed.weight.float().T)
        x = (x + self.patch_embed.bias.float()).to(dtype)
        return torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)

    @property
    def tap_blocks(self) -> tuple[int, ...]:
        # 1-indexed stages → blocks, each once and in block order, as the
        # JAX backbone collects them (a set of wanted blocks).
        return tuple(sorted({i - 1 for i in self.cfg.out_layers}))

    def block_args(self, grid: tuple[int, int], device: torch.device) -> tuple:
        return grid, self._rel_index(grid, device)

    def forward(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        p = self.cfg.patch_size
        grid = (pixels.shape[1] // p, pixels.shape[2] // p)
        return [t.float() for t in run_blocks(self, self.embed(pixels), grid)]
