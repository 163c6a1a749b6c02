"""Fine-tuning on one device: the train config and the trainer.

Counterpart of ``image_to_pointcloud_tpu/train/trainer.py`` on a
one-device mesh (where its ``shard_params`` and ``batch_sharding`` are
identities). The step is the JAX package's optax chain,
``clip_by_global_norm(grad_clip)`` → ``adamw(lr, weight_decay)``:

* the clip as optax computes it: the global norm √Σ‖g‖², and when it is
  not below ``grad_clip`` every gradient becomes ``(g / norm) · grad_clip``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``, another
  update);
* AdamW with betas (0.9, 0.999), eps 1e-8 and decoupled weight decay on
  every parameter (optax's ``adamw`` without a mask); a parameter the
  loss does not reach gets a zero gradient, so it still decays.

The model is f32 with ``use_flash_attention=False`` (K1 has no
backward), and ``remat`` checkpoints each DINOv2 or ViT block
(``torch.utils.checkpoint``, ``use_reentrant=False``); BEiT's blocks
train without it, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from image_to_pointcloud_tpu_torch.models.depth_anything import ModelConfig, build_model
from image_to_pointcloud_tpu_torch.train.losses import (
    affine_invariant_loss,
    gradient_matching_loss,
    silog_loss,
)

__all__ = ["TrainConfig", "Trainer", "train_model_config"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-6
    weight_decay: float = 1e-2
    grad_clip: float = 1.0
    loss: str = "affine_invariant"  # or "silog"
    gradient_weight: float = 0.5
    remat: bool = True  # checkpoint encoder blocks to trade FLOPs for memory


def _loss_fn_for(cfg: TrainConfig) -> Callable:
    base = {"affine_invariant": affine_invariant_loss, "silog": silog_loss}[cfg.loss]

    def loss(pred, target, mask):
        l = base(pred, target, mask)
        if cfg.gradient_weight:
            l = l + cfg.gradient_weight * gradient_matching_loss(pred, target, mask)
        return l

    return loss


def train_model_config(model_cfg: ModelConfig, remat: bool) -> ModelConfig:
    """The config the trainer builds: plain attention, and per-block remat
    where the backbone has the knob (DINOv2, ViT)."""
    bb = model_cfg.backbone
    if not hasattr(bb, "use_flash_attention"):  # BEiT: no K1, no remat
        return model_cfg
    return dataclasses.replace(
        model_cfg,
        backbone=dataclasses.replace(bb, use_flash_attention=False, remat_blocks=remat),
    )


class Trainer:
    """Owns the f32 model, the optimizer state and the train step."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        state_dict: dict[str, torch.Tensor],
        device: "str | torch.device" = "cuda",
        cfg: TrainConfig = TrainConfig(),
        opt_state: Any = None,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(train_model_config(model_cfg, cfg.remat))
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device, torch.float32)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.opt = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay,
        )
        if opt_state is not None:
            self.opt.load_state_dict(opt_state)
        self._loss = _loss_fn_for(cfg)

    def _clip_by_global_norm(self) -> None:
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.cfg.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * self.cfg.grad_clip))

    def train_step(self, pixels: torch.Tensor, target: torch.Tensor, mask=None) -> torch.Tensor:
        """One optimization step on (B, H, W, 3) pixels and (B, H, W) depth
        targets (mask: all valid by default); returns the loss (0-d,
        detached)."""
        pixels = torch.as_tensor(pixels, device=self.device, dtype=torch.float32)
        target = torch.as_tensor(target, device=self.device, dtype=torch.float32)
        if mask is None:
            mask = torch.ones(target.shape, dtype=torch.bool, device=self.device)
        self.opt.zero_grad(set_to_none=True)
        loss = self._loss(self.model(pixels), target, mask)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._clip_by_global_norm()
        self.opt.step()
        return loss.detach()

    def state_dict(self) -> dict[str, torch.Tensor]:
        return self.model.state_dict()

    @torch.no_grad()
    def predict(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.model(torch.as_tensor(pixels, device=self.device, dtype=torch.float32))
