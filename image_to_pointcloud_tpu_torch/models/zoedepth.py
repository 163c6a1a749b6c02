"""ZoeDepth metric depth: BEiT encoder + DPT neck + relative-depth head +
adaptive metric-bins head.

Counterpart of ``image_to_pointcloud_tpu/models/zoedepth.py`` (HF
``modeling_zoedepth``, the layout of the released
``Intel/zoedepth-nyu-kitti``): seed-bin regressor → four unnormed
attractor refinements over the fusion pyramid → conditional log-binomial
softmax over the bin centres, conditioned on the relative-depth features.
Feature maps run NCHW.

Bug-compatible with HF: the attractors use alpha=300, gamma=2 (the
config's ``attractor_alpha`` is stored but never passed on in
``AttractorLayerUnnormed.forward``). The computation leaves the model
dtype for f32 exactly where the JAX code does: the three softplus, the
relative depth, and the bin-centre arithmetic through the final sum.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_to_pointcloud_tpu_torch.models.beit import BeitBackbone, BeitConfig
from image_to_pointcloud_tpu_torch.models.dpt import _conv3, _FusionLayer
from image_to_pointcloud_tpu_torch.ops.resize import resize_planes

__all__ = ["ZoeDepth", "ZoeDepthConfig"]


@dataclasses.dataclass(frozen=True)
class _MetricNeckInfo:
    """The ``cfg.neck`` view of a metric model, for readers of
    ``cfg.neck.metric_depth`` and ``max_depth`` (the CLI,
    ``MetricPipeline``)."""

    metric_depth: bool
    max_depth: float


@dataclasses.dataclass(frozen=True)
class ZoeDepthConfig:
    backbone: BeitConfig = dataclasses.field(default_factory=BeitConfig)
    neck_hidden_sizes: Sequence[int] = (96, 192, 384, 768)
    fusion_hidden_size: int = 256
    reassemble_factors: Sequence[float] = (4, 2, 1, 0.5)
    bottleneck_features: int = 256
    num_relative_features: int = 32
    bin_embedding_dim: int = 128
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 10.0
    num_attractors: Sequence[int] = (16, 8, 4, 1)
    min_temp: float = 0.0212
    max_temp: float = 50.0
    # The ZoeDepth processor: mean = std = 0.5, a resize toward 384×512 in
    # multiples of 32 keeping the aspect ratio, torch bilinear with
    # align_corners=True, after a reflect pad of int(sqrt(dim/2)·3) per
    # side that the pipeline crops from the prediction.
    pixel_mean: Sequence[float] = (0.5, 0.5, 0.5)
    pixel_std: Sequence[float] = (0.5, 0.5, 0.5)
    native_target: tuple[int, int] = (384, 512)
    size_multiple: int = 32
    pad_reflect_factor: int = 3
    resize_method: str = "linear_ac"

    @property
    def neck(self) -> _MetricNeckInfo:
        """Metric depth up to ``max_depth``."""
        return _MetricNeckInfo(metric_depth=True, max_depth=self.max_depth)

    def with_flash_attention(self, on: bool = True) -> "ZoeDepthConfig":
        """A no-op, as in the JAX package: BEiT's attention adds a relative
        position bias, which K1 does not take, so it is plain torch ops on
        every device."""
        return self

    def with_quantized(self, on: bool = True) -> "ZoeDepthConfig":
        """Int8 W8A8 encoder matmuls (``models.quantize``)."""
        return dataclasses.replace(self, backbone=dataclasses.replace(self.backbone, quantized=on))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` in f32. ``F.softplus`` returns x itself above
    its threshold of 20, where log1p(exp(-x)) < 2.1e-9 is below half an
    f32 ulp of x (≥ 9.5e-7): the same f32 value."""
    return F.softplus(x.float())


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """HF's ``interpolate(..., mode="bilinear", align_corners=True)``."""
    return resize_planes(x, tuple(hw), "linear_ac")


class _Reassemble(nn.Module):
    """Tap token sequences (B, N+1, D) → four NCHW maps at 4×, 2×, 1× and
    0.5× the patch grid (readout "project")."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        d = cfg.backbone.hidden_size
        self.factors = tuple(cfg.reassemble_factors)
        for i, (c, f) in enumerate(zip(cfg.neck_hidden_sizes, self.factors)):
            setattr(self, f"readout{i}", nn.Linear(2 * d, d))
            setattr(self, f"proj{i}", nn.Conv2d(d, c, 1))
            if f in (2, 4):
                setattr(self, f"up{i}", nn.ConvTranspose2d(c, c, int(f), stride=int(f)))
            elif f == 0.5:
                setattr(self, f"down{i}", nn.Conv2d(c, c, 3, stride=2, padding=1))

    def forward(self, taps: list[torch.Tensor], grid: tuple[int, int]) -> list[torch.Tensor]:
        dtype = self.readout0.weight.dtype
        out = []
        for i, (t, f) in enumerate(zip(taps, self.factors)):
            cls, tok = t[:, :1], t[:, 1:]
            x = torch.cat([tok, cls.expand_as(tok)], dim=-1).to(dtype)
            x = F.gelu(getattr(self, f"readout{i}")(x))
            x = getattr(self, f"proj{i}")(x.transpose(1, 2).reshape(x.shape[0], -1, *grid))
            if f in (2, 4):
                x = getattr(self, f"up{i}")(x)
            elif f == 0.5:
                x = getattr(self, f"down{i}")(x)
            out.append(x)
        return out


class _Projector(nn.Module):
    """1×1-conv MLP (ZoeDepthProjector)."""

    def __init__(self, cin: int, cout: int, mlp_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mlp_dim, 1)
        self.conv2 = nn.Conv2d(mlp_dim, cout, 1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


def _inv_attractor(dx: torch.Tensor, alpha: float = 300.0, gamma: int = 2) -> torch.Tensor:
    """dc = dx / (1 + alpha·dx^gamma), HF's effective constants."""
    return dx / (1.0 + alpha * dx**gamma)


class _AttractorUnnormed(nn.Module):
    """ZoeDepthAttractorLayerUnnormed (bin_centers_type='softplus')."""

    def __init__(self, cfg: ZoeDepthConfig, n_attractors: int):
        super().__init__()
        e = cfg.bin_embedding_dim
        self.conv1 = nn.Conv2d(e, e, 1)
        self.conv2 = nn.Conv2d(e, n_attractors, 1)

    def forward(self, x, prev_bin, prev_bin_embedding):
        hw = x.shape[-2:]
        x = x + _resize(prev_bin_embedding, hw)
        attractors = _softplus(self.conv2(torch.relu(self.conv1(x))))  # (B, A, H, W)
        centers = _resize(prev_bin, hw)  # (B, n_bins, H, W) f32
        delta = _inv_attractor(attractors[:, :, None] - centers[:, None]).mean(dim=1)
        return centers + delta


class _ConditionalLogBinomial(nn.Module):
    """ZoeDepthConditionalLogBinomialSoftmax: per-pixel MLP → (p, t) →
    a binomial distribution over the bins → softmax(y / t)."""

    def __init__(self, cfg: ZoeDepthConfig, in_features: int, condition_dim: int):
        super().__init__()
        self.cfg = cfg
        bottleneck = (in_features + condition_dim) // 2
        self.mlp1 = nn.Conv2d(in_features + condition_dim, bottleneck, 1)
        self.mlp2 = nn.Conv2d(bottleneck, 4, 1)
        # log C(k-1, i) by HF's Stirling formula, folded on the host in
        # numpy f32 as the JAX package folds it.
        k = cfg.n_bins
        e = np.float32(1e-7)
        n = np.float32(k - 1) + e
        kk = np.arange(k, dtype=np.float32) + e
        # Kept off the module's buffers, which ``.to(dtype)`` would round.
        self._log_binom = n * np.log(n) - kk * np.log(kk) - (n - kk) * np.log(n - kk + e)
        self._log_binom_dev: dict = {}

    def forward(self, main, condition):
        cfg = self.cfg
        x = torch.cat([main, condition], dim=1).to(self.mlp1.weight.dtype)
        x = _softplus(self.mlp2(F.gelu(self.mlp1(x))))
        eps = 1e-4
        p2, t2 = x[:, :2] + eps, x[:, 2:] + eps
        prob = p2[:, 0] / (p2[:, 0] + p2[:, 1])  # (B, H, W)
        temp = t2[:, 0] / (t2[:, 0] + t2[:, 1])
        temp = (cfg.max_temp - cfg.min_temp) * temp + cfg.min_temp
        k = cfg.n_bins
        k_idx = torch.arange(k, dtype=torch.float32, device=x.device).reshape(k, 1, 1)
        p = prob.clamp(eps, 1.0)[:, None]
        omp = (1.0 - prob).clamp(eps, 1.0)[:, None]
        if x.device not in self._log_binom_dev:
            self._log_binom_dev[x.device] = torch.from_numpy(self._log_binom).to(x.device)
        lb = self._log_binom_dev[x.device].reshape(k, 1, 1)
        y = lb + k_idx * torch.log(p) + (k - 1 - k_idx) * torch.log(omp)
        return torch.softmax(y / temp[:, None], dim=1)  # (B, k, H, W)


class ZoeDepth(nn.Module):
    """(B, H, W, 3) normalized pixels → (B, H, W) f32 metric depth (m)."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.fusion_hidden_size
        e = cfg.bin_embedding_dim
        self.backbone = BeitBackbone(cfg.backbone)
        self.reassemble = _Reassemble(cfg)
        for i, c in enumerate(cfg.neck_hidden_sizes):
            setattr(self, f"conv{i}", _conv3(c, f, bias=False))
        for j in range(4):
            setattr(self, f"fusion{j}", _FusionLayer(f, has_residual=j > 0))
        self.rel_conv1 = _conv3(f, f // 2)
        self.rel_conv2 = _conv3(f // 2, cfg.num_relative_features)
        self.rel_conv3 = nn.Conv2d(cfg.num_relative_features, 1, 1)
        self.mh_conv2 = nn.Conv2d(f, cfg.bottleneck_features, 1)
        self.seed_conv1 = nn.Conv2d(cfg.bottleneck_features, 256, 1)
        self.seed_conv2 = nn.Conv2d(256, cfg.n_bins, 1)
        self.seed_projector = _Projector(cfg.bottleneck_features, e)
        for i in range(4):
            setattr(self, f"projector{i}", _Projector(f, e))
            setattr(self, f"attractor{i}", _AttractorUnnormed(cfg, cfg.num_attractors[i]))
        self.cond_log_binomial = _ConditionalLogBinomial(
            cfg, cfg.num_relative_features + 1, e
        )

    def embed(self, pixels: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        p = self.cfg.backbone.patch_size
        return self.backbone.embed(pixels), (pixels.shape[1] // p, pixels.shape[2] // p)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        p = self.cfg.backbone.patch_size
        return self.finish(self.backbone(pixels), (pixels.shape[1] // p, pixels.shape[2] // p))

    def finish(self, taps: list[torch.Tensor], grid: tuple[int, int]) -> torch.Tensor:
        stages = self.reassemble([t.float() for t in taps], grid)
        feats = [getattr(self, f"conv{i}")(s) for i, s in enumerate(stages)]
        bottleneck = feats[-1]

        # Fusion, deepest → shallowest, every step an exact ×2.
        fused_list = []
        fused = None
        for idx, hs in enumerate(feats[::-1]):
            layer = getattr(self, f"fusion{idx}")
            fused = layer(hs) if fused is None else layer(fused, hs)
            fused_list.append(fused)

        # Relative-depth head on the shallowest fused map.
        x = self.rel_conv1(fused_list[-1])
        x = _resize(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        rel_features = torch.relu(self.rel_conv2(x))
        relative_depth = torch.relu(self.rel_conv3(rel_features).float())  # (B, 1, H, W)

        # Metric bins head.
        xb = self.mh_conv2(bottleneck)
        prev_bin = _softplus(self.seed_conv2(torch.relu(self.seed_conv1(xb))))
        prev_emb = self.seed_projector(xb)
        bin_centers, bin_emb = prev_bin, prev_emb
        for i, feat in enumerate(fused_list):
            bin_emb = getattr(self, f"projector{i}")(feat)
            bin_centers = getattr(self, f"attractor{i}")(bin_emb, prev_bin, prev_emb)
            prev_bin, prev_emb = bin_centers, bin_emb

        last_hw = rel_features.shape[-2:]
        last = torch.cat([rel_features.float(), _resize(relative_depth, last_hw)], dim=1)
        probs = self.cond_log_binomial(last, _resize(bin_emb, last_hw))
        return (probs * _resize(bin_centers, last_hw)).sum(dim=1)
