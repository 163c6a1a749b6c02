"""Model manager: lazily build and memoize one pipeline per model name.

Counterpart of ``image_to_pointcloud_tpu/serve/models.py``. Models run in
bf16 on CUDA and f32 on the CPU, as the JAX server runs bf16 on an
accelerator and f32 on the CPU. Weights are a deterministic random init
from a seeded ``torch.Generator`` (made on the CPU, so every device gets
the same numbers): no checkpoint can be downloaded, and checkpoint
loading is not ported yet. ``triposr``/``instantmesh`` are the
reference's capability stubs and have no pipeline.
"""

from __future__ import annotations

import logging
import threading

import torch

from image_to_pointcloud_tpu_torch.models.depth_anything import (
    DepthAnything,
    init_weights,
    preset,
)
from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline

__all__ = ["DUMMY_MODELS", "ModelManager"]

logger = logging.getLogger(__name__)

DUMMY_MODELS = {"triposr", "instantmesh"}
_SEED = 0


class ModelManager:
    def __init__(self, device: "str | torch.device" = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
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

    def _build(self, name: str) -> DepthPipeline:
        cfg = preset(name)  # raises ValueError for unsupported names
        logger.warning("No checkpoint for %s; using deterministic random init", name)
        model = init_weights(DepthAnything(cfg), torch.Generator().manual_seed(_SEED))
        return DepthPipeline(model.to(self.device, self.dtype))
