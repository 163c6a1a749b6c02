"""Fine-tuning: the train config and the trainer, on one device or a mesh.

Counterpart of ``image_to_pointcloud_tpu/train/trainer.py``. The trainer
runs on a mesh (``parallel/sharding.py``; one device is the one-slot mesh
``make_mesh(data=1, devices=[device])``): the batch is split over the
``data`` slots and the encoder blocks are megatron-sharded over the ``model``
slots (:class:`~..parallel.sharding.MeshedModel`, ``live``): each
parameter exists once per model slot and the data slots read it through
differentiable copies, so its gradient sums in that one tensor, and the
clip and AdamW see each parameter once. The loss is taken on the
predictions gathered on the first slot, as JAX takes it on the global
batch (``silog_loss`` and ``affine_invariant_loss`` are not means of
per-slot losses). :meth:`Trainer.state_dict` gathers the shards back into
the one-device layout, so the checkpoint format is the same. The step is
the JAX package's optax chain,
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

As the JAX package jits the step (``params`` and ``opt_state`` donated),
the port captures it: on a CUDA mesh whose slots are all one device (one
slot, or data and model slots sharing a card) each signature (pixels'
shape and dtype, the target's shape, the mask's) is one CUDA graph
(``pipeline/graph.py``'s ``_CompiledGraph``) of the whole step, in place
on the trainer's parameters, gradients and optimizer state. The warm-up
pass before a capture is undone (:meth:`Trainer._warm_up`), so each call
takes one step, the first call's too. The gradients are None when the
capture starts, so the captured backward makes them in the graph's pool
(PyTorch's whole-network capture); after each replay every ``p.grad`` is
that signature's, the step's clipped gradient. AdamW on CUDA is
``capturable`` (its step count on the device), eagerly too, so that the
graph and the eager body do the same arithmetic; the CPU keeps the
default AdamW. On the CPU, and on a mesh over several devices (whose
gradient sum across devices is inside the step), the step runs eagerly
through the same callable (on such a mesh the trainer logs so once).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Any, Callable

import torch

from image_to_pointcloud_tpu_torch.models.depth_anything import ModelConfig, build_model
from image_to_pointcloud_tpu_torch.pipeline.graph import _GraphOwner, exact_f32, wants_exact_f32
from image_to_pointcloud_tpu_torch.train.losses import (
    affine_invariant_loss,
    gradient_matching_loss,
    silog_loss,
)

__all__ = ["TrainConfig", "Trainer", "train_model_config"]

logger = logging.getLogger(__name__)


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


class Trainer(_GraphOwner):
    """Owns the f32 model, the optimizer state and the train step, on
    ``mesh`` (default: the one slot ``device``; ``device`` is then the
    first slot's). ``state_dict`` may come placed (``restore_params(mesh=)``).
    Without model slots :attr:`model` is the one-device module, whose
    parameters are the ones trained (in its order, so an optimizer state
    resumes); with them it is None (the blocks are sharded: :attr:`net`).
    ``cuda_graphs`` (a CUDA mesh whose slots are all one device, by
    :func:`~..parallel.sharding.captures_graphs`) says whether the step
    replays a CUDA graph a signature, held in ``_compiled`` under the JAX
    jit's retrace key; a mesh over several devices steps eagerly, as the
    CPU does. An optimizer state loaded later (``opt.load_state_dict``)
    drops the graphs, which held the old state's tensors."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        state_dict: dict[str, torch.Tensor],
        device: "str | torch.device" = "cuda",
        cfg: TrainConfig = TrainConfig(),
        opt_state: Any = None,
        mesh=None,
    ):
        from image_to_pointcloud_tpu_torch.parallel.sharding import (
            MODEL_AXIS,
            MeshedModel,
            Sharded,
            captures_graphs,
            gather_params,
            make_mesh,
            visible_devices,
        )

        if mesh is None:
            mesh = make_mesh(data=1, devices=visible_devices(device)[:1])
        self.cfg = cfg
        self.mesh = mesh
        first = mesh.device()
        graphs = captures_graphs(mesh, one_device=True)
        if first.type == "cuda" and not graphs:
            logger.warning("Trainer on %r: the mesh spans several devices, so the step runs "
                           "eagerly (no CUDA graph)", mesh)
        super().__init__(first, graphs)
        # The model is f32: on CUDA its forward and backward run without
        # TF32 (``pipeline/graph.py``).
        self.exact_f32 = wants_exact_f32(self.device, torch.float32)
        if any(isinstance(v, Sharded) for v in state_dict.values()):
            state_dict = gather_params(state_dict, torch.device("cpu"))
        # Built on the CPU and placed by MeshedModel, slot by slot.
        model = build_model(train_model_config(model_cfg, cfg.remat))
        model.load_state_dict(state_dict, strict=True)
        self.net = MeshedModel(model.float(), mesh, live=True)
        if mesh.shape[MODEL_AXIS] == 1:
            self.model = model
            self.params = [p for p in model.parameters() if p.requires_grad]
        elif opt_state is not None:
            raise ValueError("optimizer state resumes on a mesh without model slots only")
        else:
            self.model = None
            self.params = [p for p in self.net.parameters() if p.requires_grad]
        # The zero gradient of each parameter the loss does not reach, made
        # once; and each signature's gradients (the graph's, in its pool).
        self._zero_grads: dict[int, torch.Tensor] = {}
        self._grads: dict[tuple, list] = {}
        self.opt = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay, capturable=self.device.type == "cuda",
        )
        # An eager step of a capturable AdamW is meant here (a capture's
        # warm-up, a mesh): AdamW's warning that it impairs speed is not.
        self.opt._warned_capturable_if_run_uncaptured = True
        self.opt.register_load_state_dict_post_hook(self._loaded)
        if opt_state is not None:
            self.opt.load_state_dict(opt_state)
        self._loss = _loss_fn_for(cfg)

    def _loaded(self, opt) -> None:
        """After ``opt.load_state_dict``: the trainer's AdamW settings (a
        state saved elsewhere brings its own ``capturable``), each step
        count on its parameter's device where capturable, and no graph
        (each replayed into the state tensors just replaced)."""
        capturable = self.device.type == "cuda"
        for group in opt.param_groups:
            group["capturable"] = capturable
        if capturable:
            for p, st in opt.state.items():
                st["step"] = torch.as_tensor(st["step"], dtype=torch.float32).to(p.device)
        self._compiled.clear()
        self._grads.clear()

    def _clip_by_global_norm(self) -> None:
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g).to(self.device) for g in grads))
        keep = norm < self.cfg.grad_clip
        for g in grads:
            n, k = norm.to(g.device), keep.to(g.device)
            g.copy_(torch.where(k, g, (g / n) * self.cfg.grad_clip))

    def _global(self, x, dtype) -> torch.Tensor:
        from image_to_pointcloud_tpu_torch.parallel.sharding import Sharded

        if isinstance(x, Sharded):
            return x.gather(self.device).to(dtype)
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _predict(self, pixels) -> torch.Tensor:
        """Depth of the whole batch on the first slot; each data slot
        predicts its rows (``pixels`` may come placed, as
        ``prefetch_to_device(sharding=...)`` gives them)."""
        from image_to_pointcloud_tpu_torch.parallel.sharding import Sharded, split_rows

        if isinstance(pixels, Sharded):
            rows = pixels.data_shards()
        else:
            rows = split_rows(self._global(pixels, torch.float32), self.mesh)
        with exact_f32(self.exact_f32):
            return torch.cat([self.net.forward_slot(d, r.float()).to(self.device)
                              for d, r in enumerate(rows)])

    def train_step(self, pixels, target, mask=None) -> torch.Tensor:
        """One optimization step on (B, H, W, 3) pixels and (B, H, W) depth
        targets (mask: all valid by default, made here as JAX makes it, so
        that no mask is no signature of its own); returns the loss (0-d,
        detached). The step is the callable of its signature
        (:meth:`_step`, eagerly or as its CUDA graph)."""
        from image_to_pointcloud_tpu_torch.parallel.sharding import Sharded

        target = self._global(target, torch.float32)
        if mask is None:
            mask = torch.ones(target.shape, dtype=torch.bool, device=self.device)
        else:
            mask = self._global(mask, torch.bool)
        if isinstance(pixels, Sharded) and self.cuda_graphs:
            # The graph's one static input: every slot is on this device, and
            # the step splits it back into the same rows (``split_rows``).
            pixels = pixels.gather(self.device)
        elif not isinstance(pixels, (Sharded, torch.Tensor)):
            pixels = torch.as_tensor(pixels)
        if isinstance(pixels, Sharded):  # its rows over the data slots
            rows = pixels.data_shards()
            shape, dtype = (sum(r.shape[0] for r in rows), *rows[0].shape[1:]), rows[0].dtype
        else:
            shape, dtype = tuple(pixels.shape), pixels.dtype
        key = ("train", shape, dtype, tuple(target.shape), tuple(mask.shape))
        loss = self._signature(key, self._step)(pixels, target, mask)
        if self.cuda_graphs:  # the gradients of the signature just replayed
            grads = self._grads.setdefault(key, [p.grad for p in self.params])
            for p, g in zip(self.params, grads):
                p.grad = g
        return loss

    def _step(self, pixels, target, mask) -> torch.Tensor:
        """The step's body: zero gradients, the forward, the loss and the
        backward under :func:`exact_f32`, the clip, AdamW; returns the
        loss (0-d, detached)."""
        self.opt.zero_grad(set_to_none=True)  # a no-op in a capture (:meth:`_warm_up`)
        with exact_f32(self.exact_f32):  # the forward, the loss and the backward
            loss = self._loss(self._predict(pixels), target, mask)
            loss.backward()
        for p in self.params:
            if p.grad is None:
                z = self._zero_grads.get(id(p))
                if z is None:
                    z = self._zero_grads[id(p)] = torch.zeros_like(p)
                p.grad = z
        self._clip_by_global_norm()
        self.opt.step()
        return loss.detach()

    @contextlib.contextmanager
    def _warm_up(self):
        """Around a capture's warm-up pass, a real step: the trained
        parameters (every model slot's shards on a mesh with model slots)
        and AdamW's state come back as they were (a state the pass made, AdamW's
        lazy init, back to its zeros), and every gradient goes to None, so
        that the captured backward makes them in the graph's pool."""
        with torch.no_grad():
            params = [p.clone() for p in self.params]
            state = {p: {k: v.clone() for k, v in st.items()} for p, st in self.opt.state.items()}
        try:
            yield
        finally:
            with torch.no_grad():
                for p, saved in zip(self.params, params):
                    p.copy_(saved)
                for p, st in self.opt.state.items():
                    for k, v in st.items():
                        if p in state:
                            v.copy_(state[p][k])
                        else:
                            v.zero_()
            self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The model's ``state_dict`` in the one-device layout."""
        return self.net.gathered_state_dict()

    @torch.no_grad()
    def predict(self, pixels) -> torch.Tensor:
        return self._predict(pixels)
