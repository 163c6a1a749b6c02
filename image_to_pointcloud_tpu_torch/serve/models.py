"""Model manager: lazily build and memoize one pipeline per model name.

Counterpart of ``image_to_pointcloud_tpu/serve/models.py``, with its
``use_bf16`` and ``use_flash_attention``. Models run in bf16 on CUDA when
``use_bf16`` (the default) and in f32 otherwise, on the CPU always, as the
JAX server runs bf16 only on an accelerator. An f32 model on CUDA is f32
through and through: its pipeline turns TF32 off around each forward
(:func:`~..pipeline.graph.exact_f32`), and its attention is K1's f32
(3xTF32) kernel. ``use_flash_attention=None`` means K1 on CUDA (and the
plain version on the CPU, by the tensor's device); ``False`` builds the
encoders with ``use_flash_attention=False``, the plain attention on every
device; ZoeDepth's BEiT has no K1 either way. Every preset of every
family is served
(:func:`~image_to_pointcloud_tpu_torch.models.depth_anything.build_model`).
Weights come from ``checkpoint_dir`` (or ``IPC_TPU_CHECKPOINT_DIR``): the
port's own checkpoint ``<dir>/<name>/torch/checkpoint.pt`` (written by the
CLI's ``train`` or ``convert-ckpt``, ``train/checkpoint.py``) first, as the
JAX server prefers its ``<dir>/<name>/orbax``; else an HF-layout
safetensors checkpoint, ``<dir>/<name>/model.safetensors`` or
``<dir>/<name>.safetensors``, converted on load; otherwise from a
deterministic random init with a
seeded ``torch.Generator`` (made on the CPU, so every device gets the same
numbers), recorded in :attr:`ModelManager.random_weights`. ``mesh`` (a
mesh of ``parallel/``, or ``"auto"``) serves every model on a grid of
device slots (:class:`~..pipeline.graph.DepthPipeline`'s ``mesh``).
``triposr``/``instantmesh`` are the reference's capability stubs and have
no pipeline.

``int8=True`` (or ``IPC_TPU_INT8=1``) serves the int8 W8A8 encoder
(``models/quantize.py``): the f32 weights are quantized before the model
moves to its device and dtype, as the JAX package quantizes its f32
params; with ``use_bf16=False`` its activations around the int8 GEMMs are
f32. The mesh path takes the same dtype. Refused with an error rather
than served as something else:
orbax checkpoints (``<dir>/<name>/orbax``, written by the JAX package's
``train/``), which PyTorch cannot read.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path

import torch
from torch import nn

from image_to_pointcloud_tpu_torch.models.convert import convert_checkpoint, load_safetensors
from image_to_pointcloud_tpu_torch.models.depth_anything import (
    build_model,
    init_weights,
    preset,
)
from image_to_pointcloud_tpu_torch.models.quantize import quantize_encoder_params
from image_to_pointcloud_tpu_torch.pipeline.graph import DepthPipeline
from image_to_pointcloud_tpu_torch.train.checkpoint import CHECKPOINT_FILE, restore_params

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
        mesh=None,
        *,
        use_bf16: bool = True,
        use_flash_attention: bool | None = None,
    ):
        # Int8 W8A8 encoder matmuls: by argument, else IPC_TPU_INT8 (1,
        # true or yes), as the JAX server reads it.
        if int8 is None:
            int8 = os.environ.get("IPC_TPU_INT8", "").lower() in ("1", "true", "yes")
        self.int8 = int8
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        # The serving mesh (parallel/): "auto" is DP over every visible
        # device of ``device``'s type, and no mesh where there is one.
        if mesh == "auto":
            from image_to_pointcloud_tpu_torch.parallel.sharding import make_mesh, visible_devices

            devs = visible_devices(self.device)
            mesh = make_mesh(devices=devs) if len(devs) > 1 else None
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.device()  # the first slot: where results gather
        # bf16 only where asked and on CUDA, as the JAX server's use_bf16
        # holds only on an accelerator.
        self.use_bf16 = use_bf16 and self.device.type == "cuda"
        self.dtype = torch.bfloat16 if self.use_bf16 else torch.float32
        # None: K1 wherever the tensors are on CUDA; False: the plain
        # attention on every device.
        self.use_flash = use_flash_attention is not False
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

    def loaded(self) -> list[str]:
        """The names of the models built so far, sorted."""
        return sorted(self._cache)

    def _checkpoint(self, name: str) -> Path | None:
        if not self.checkpoint_dir:
            return None
        root = Path(self.checkpoint_dir)
        if (root / name / "torch" / CHECKPOINT_FILE).exists():
            return root / name / "torch"
        if (root / name / "orbax").exists():
            raise RuntimeError(
                f"{root / name / 'orbax'} is an orbax checkpoint, which the "
                "PyTorch package cannot read; convert the HF weights with "
                "`python -m image_to_pointcloud_tpu_torch convert-ckpt`, or "
                "provide model.safetensors"
            )
        for cand in (root / name / "model.safetensors", root / f"{name}.safetensors"):
            if cand.exists():
                return cand
        return None

    def load_model(self, name: str, cfg=None) -> nn.Module:
        """The f32 model of preset ``name`` on the CPU, with its
        checkpoint's weights or the seeded random init (recorded in
        :attr:`random_weights`)."""
        cfg = preset(name) if cfg is None else cfg  # raises ValueError for unsupported names
        model = build_model(cfg)
        ckpt = self._checkpoint(name)
        t0 = time.perf_counter()
        if ckpt is not None:
            sd = (restore_params(ckpt) if ckpt.name == "torch"
                  else convert_checkpoint(cfg, load_safetensors(str(ckpt))))
            model.load_state_dict(sd, strict=True)
            logger.info("Loaded %s weights from %s in %.1f s", name, ckpt, time.perf_counter() - t0)
        else:
            init_weights(model, torch.Generator().manual_seed(_SEED))
            logger.warning(
                "No checkpoint for %s (set %s or --checkpoint-dir); deterministic "
                "random init took %.1f s", name, CHECKPOINT_ENV, time.perf_counter() - t0,
            )
        self.random_weights[name] = ckpt is None
        return model

    def _build(self, name: str) -> DepthPipeline:
        if name in DUMMY_MODELS:
            raise ValueError(f"{name} is a dummy model with no pipeline")
        cfg = preset(name).with_flash_attention(self.use_flash)
        model = self.load_model(name, cfg)
        if self.int8:
            # Quantized from the f32 weights, before the cast to the
            # compute dtype; the scales and biases stay f32.
            sd = quantize_encoder_params(model.state_dict(), cfg.backbone.num_layers)
            cfg = cfg.with_quantized(True)
            model = build_model(cfg)
            model.load_state_dict(sd, strict=True)
        # On a mesh the model stays on the CPU: the pipeline places each
        # slot's piece, so no slot holds the whole encoder.
        model = model.to(self.dtype) if self.mesh is not None else model.to(
            self.device, self.dtype)
        return DepthPipeline(model, model_target=self.model_target, mesh=self.mesh)
