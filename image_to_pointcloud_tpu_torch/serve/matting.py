"""Learned background matting for the v2 processor.

Counterpart of ``image_to_pointcloud_tpu/serve/matting.py``. The
reference composites its input onto white using a learned alpha matte
(``transparent_background.Remover``, spar3d_processor.py:88). Here the
matte model is the port's SegFormer (``models/segformer.py``): put a
SegFormer matting or salient-object checkpoint at
``<IPC_TPU_CHECKPOINT_DIR>/matting/model.safetensors`` (1-channel sigmoid
head or 2-class softmax head) and :class:`MatteModel` serves it, in f32
on the model manager's device; with no checkpoint the processor falls
back to the classical border-statistics matte
(``serve/processor3d.estimate_background_matte``).

As the JAX package jits the matte's forward, the port keeps one callable
per input shape (:meth:`MatteModel._fn`; ``alpha`` has one, (1, 512, 512,
3)): on CUDA a CUDA graph of the normalization, the SegFormer forward,
the sigmoid or softmax and the resize to 512², captured on first use and
replayed as one launch (``pipeline/graph.py``'s ``_CompiledGraph``), the
pixels its input; on the CPU its eager body. ``alpha``'s PIL resizes stay
on the host.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.models.convert import convert_segformer, load_safetensors
from image_to_pointcloud_tpu_torch.models.segformer import SegformerMatte, segformer_b0
from image_to_pointcloud_tpu_torch.ops.resize import resize_planes
from image_to_pointcloud_tpu_torch.pipeline.graph import (
    _CompiledGraph,
    _GraphOwner,
    exact_f32,
    wants_exact_f32,
)

__all__ = ["MatteModel", "load_matte_model"]

logger = logging.getLogger(__name__)

# Internal inference resolution: SegFormer's native fine-tune size.
_MATTE_SIZE = 512
# ImageNet stats — the SegformerImageProcessor defaults.
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class MatteModel(_GraphOwner):
    """Alpha matte from a SegFormer checkpoint: ``alpha(rgb) -> (H, W)``."""

    def __init__(
        self,
        state_dict: dict[str, torch.Tensor],
        num_labels: int,
        device: "str | torch.device" = "cuda",
    ):
        if num_labels not in (1, 2):
            raise ValueError(
                "matting head must be 1-channel (sigmoid) or 2-class "
                f"(softmax); got {num_labels} channels"
            )
        self.num_labels = num_labels
        model = SegformerMatte(segformer_b0(num_labels=num_labels))
        model.load_state_dict(state_dict, strict=True)
        device = torch.device(device)
        super().__init__(device, device.type == "cuda")
        self.model = model.to(self.device).eval()
        # f32 on CUDA runs without TF32 (``pipeline/graph.py``).
        self.exact_f32 = wants_exact_f32(self.device, torch.float32)
        self._mean = torch.from_numpy(_MEAN).to(self.device)
        self._std = torch.from_numpy(_STD).to(self.device)

    def _fn(self, b: int, h: int, w: int) -> _CompiledGraph:
        """The callable of one input shape: ``fn(pixels_u8)``, (b, h, w, 3)
        u8 → :meth:`_forward`'s output."""
        return self._signature((b, h, w), self._forward)

    @torch.inference_mode()
    def _forward(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """The eager body: (B, S, S, 3) pixels on the model's device →
        (B, 512, 512) f32 foreground probability."""
        x = pixels_u8.float() / 255.0
        with exact_f32(self.exact_f32):
            logits = self.model((x - self._mean) / self._std)  # (B, S/4, S/4, C)
        if self.num_labels == 1:
            prob = torch.sigmoid(logits[..., 0])
        else:
            prob = torch.softmax(logits, dim=-1)[..., 1]
        return resize_planes(prob, (_MATTE_SIZE, _MATTE_SIZE), "linear")

    def prob(self, pixels_u8: np.ndarray) -> np.ndarray:
        """(B, S, S, 3) uint8 → (B, 512, 512) f32 foreground probability,
        resized back to the matte working resolution on the device."""
        pixels_u8 = np.asarray(pixels_u8)
        return self._fn(*pixels_u8.shape[:3])(pixels_u8).cpu().numpy()

    def alpha(self, rgb_u8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 → (H, W) float32 alpha in [0, 1]."""
        from PIL import Image

        h, w = rgb_u8.shape[:2]
        im = Image.fromarray(rgb_u8).resize((_MATTE_SIZE, _MATTE_SIZE), Image.BILINEAR)
        prob = self.prob(np.asarray(im)[None])[0]
        out = Image.fromarray((np.clip(prob, 0.0, 1.0) * 255).astype(np.uint8)).resize(
            (w, h), Image.BILINEAR
        )
        return np.asarray(out).astype(np.float32) / 255.0


def load_matte_model(
    checkpoint_dir: str | os.PathLike | None = None,
    device: "str | torch.device" = "cuda",
) -> MatteModel | None:
    """MatteModel from ``<dir>/matting/model.safetensors`` or None.

    The head width (1 vs 2 channels) is inferred from the checkpoint's
    classifier shape, so both matting conventions drop in unmodified. A
    checkpoint that does not load is logged and gives None: the
    processor then uses the classical matte."""
    root = checkpoint_dir or os.environ.get("IPC_TPU_CHECKPOINT_DIR")
    if not root:
        return None
    path = Path(root) / "matting" / "model.safetensors"
    if not path.exists():
        return None
    try:
        sd = load_safetensors(str(path))
        num_labels = sd["decode_head.classifier.weight"].shape[0]
        model = MatteModel(convert_segformer(sd), int(num_labels), device)
        logger.info("Loaded learned matting model from %s (%d-channel head)", path, num_labels)
        return model
    except Exception as e:  # noqa: BLE001
        logger.warning(
            "Failed to load matting checkpoint %s (%s); falling back to the classical matte",
            path, e,
        )
        return None
