"""Model manager: lazily build and memoize one pipeline per model name.

Counterpart of ``image_to_pointcloud_tpu/serve/models.py``. Models run in
bf16 on CUDA and f32 on the CPU, as the JAX server runs bf16 on an
accelerator and f32 on the CPU. Every preset of every family is served
(:func:`~image_to_pointcloud_tpu_torch.models.depth_anything.build_model`).
Weights come from an HF-layout safetensors checkpoint under
``checkpoint_dir`` (or ``IPC_TPU_CHECKPOINT_DIR``), as
``<dir>/<name>/model.safetensors`` or ``<dir>/<name>.safetensors``,
converted on load; otherwise from a deterministic random init with a
seeded ``torch.Generator`` (made on the CPU, so every device gets the same
numbers), recorded in :attr:`ModelManager.random_weights`.
``triposr``/``instantmesh`` are the reference's capability stubs and have
no pipeline.

``int8=True`` (or ``IPC_TPU_INT8=1``) serves the int8 W8A8 encoder
(``models/quantize.py``): the f32 weights are quantized before the model
moves to its device and dtype, as the JAX package quantizes its f32
params. Not ported, and refused with an error rather than served as
something else: orbax checkpoints (``<dir>/<name>/orbax``, written by the
JAX package's ``train/``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path

import torch

from image_to_pointcloud_tpu_torch.models.convert import convert_checkpoint, load_safetensors
from image_to_pointcloud_tpu_torch.models.depth_anything import (
    build_model,
    init_weights,
    preset,
)
from image_to_pointcloud_tpu_torch.models.quantize import quantize_encoder_params
from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

__all__ = ["CHECKPOINT_ENV", "DUMMY_MODELS", "ModelManager"]

logger = logging.getLogger(__name__)

DUMMY_MODELS = {"triposr", "instantmesh"}
CHECKPOINT_ENV = "IPC_TPU_CHECKPOINT_DIR"
_SEED = 0


class ModelManager:
    def __init__(
        self,
        device: "str | torch.device" = "cuda",
        checkpoint_dir: str | None = None,
        model_target: "int | tuple[int, int] | None" = None,
        int8: bool | None = None,
    ):
        # Int8 W8A8 encoder matmuls: by argument, else IPC_TPU_INT8 (1,
        # true or yes), as the JAX server reads it.
        if int8 is None:
            int8 = os.environ.get("IPC_TPU_INT8", "").lower() in ("1", "true", "yes")
        self.int8 = int8
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.checkpoint_dir = checkpoint_dir or os.environ.get(CHECKPOINT_ENV)
        # The family's native target when None (518 for DA, 384 for
        # classic DPT, (384, 512) for ZoeDepth).
        self.model_target = model_target
        # name -> True when the model was served from the random init.
        self.random_weights: dict[str, bool] = {}
        self._cache: dict[str, DepthPipeline] = {}
        # Per-name build locks: a warmup thread and the first request
        # racing one cache miss build once; other names do not wait.
        self._locks: dict[str, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    def get(self, name: str) -> DepthPipeline:
        """Build and cache a depth pipeline (raises ValueError on unknown)."""
        if name in self._cache:
            return self._cache[name]
        with self._locks_guard:
            lock = self._locks.setdefault(name, threading.Lock())
        with lock:
            if name not in self._cache:
                self._cache[name] = self._build(name)
            return self._cache[name]

    def _checkpoint(self, name: str) -> Path | None:
        if not self.checkpoint_dir:
            return None
        root = Path(self.checkpoint_dir)
        if (root / name / "orbax").exists():
            raise RuntimeError(
                f"{root / name / 'orbax'} is an orbax checkpoint, which the "
                "PyTorch package does not read yet (train/ is not ported); "
                "provide model.safetensors instead"
            )
        for cand in (root / name / "model.safetensors", root / f"{name}.safetensors"):
            if cand.exists():
                return cand
        return None

    def _build(self, name: str) -> DepthPipeline:
        if name in DUMMY_MODELS:
            raise ValueError(f"{name} is a dummy model with no pipeline")
        cfg = preset(name)  # raises ValueError for unsupported names
        model = build_model(cfg)
        ckpt = self._checkpoint(name)
        t0 = time.perf_counter()
        if ckpt is not None:
            model.load_state_dict(convert_checkpoint(cfg, load_safetensors(str(ckpt))), strict=True)
            logger.info("Loaded %s weights from %s in %.1f s", name, ckpt, time.perf_counter() - t0)
        else:
            init_weights(model, torch.Generator().manual_seed(_SEED))
            logger.warning(
                "No checkpoint for %s (set %s or --checkpoint-dir); deterministic "
                "random init took %.1f s", name, CHECKPOINT_ENV, time.perf_counter() - t0,
            )
        self.random_weights[name] = ckpt is None
        if self.int8:
            # Quantized from the f32 weights, before the cast to the
            # compute dtype; the scales and biases stay f32.
            sd = quantize_encoder_params(model.state_dict(), cfg.backbone.num_layers)
            cfg = cfg.with_quantized(True)
            model = build_model(cfg)
            model.load_state_dict(sd, strict=True)
        return DepthPipeline(model.to(self.device, self.dtype), model_target=self.model_target)
