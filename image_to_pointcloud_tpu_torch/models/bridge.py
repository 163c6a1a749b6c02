"""Flax parameter tree → the port's ``state_dict``.

The JAX package's parameters of any depth family (DepthAnything,
DPTClassic, ZoeDepth) and of the v2 matte (``SegformerMatte``), given as
a nested dict of numpy arrays (e.g. ``jax.tree_util.tree_map(np.asarray,
params)``, or :mod:`.convert`'s HF mapping), map onto the port's model of
the same family by name, with these layout changes:

* Dense kernel ``(in, out)`` → Linear weight ``(out, in)`` (the DA and
  ViT ``q``/``k``/``v``, BEiT's bias-less ``k``, the ``readout{i}``
  projections, SegFormer's ``q``/``k``/``v``/``proj``, ``fc1``/``fc2`` and
  ``linear_c{i}``),
* an int8 ``QuantDense`` (a quantized encoder block's matmul):
  ``kernel_q`` int8 ``(in, out)`` → ``weight_q`` int8 ``(out, in)``,
  ``kernel_scale`` f32 ``(out,)`` → ``weight_scale``, ``bias`` f32
  ``(out,)`` kept (absent on BEiT's ``k``): :class:`.quantize.QuantLinear`'s
  buffers. The int8 codes stay int8; every other leaf becomes float32,
* Conv kernel HWIO → Conv2d weight OIHW (``proj{i}``, ``down3``, the
  fusion and head convs, ZoeDepth's ``mh_conv2``, ``seed_*``,
  ``projector{i}``, ``attractor{i}``, ``cond_log_binomial/mlp{1,2}``;
  SegFormer's ``embed{s}``, ``sr``, ``linear_fuse``, ``classifier``, and
  its depthwise ``dwconv``, whose (3, 3, 1, C) kernel becomes the
  ``groups=C`` weight (C, 1, 3, 3)),
* ``up0``/``up1`` matmul kernels ``(k, k, in, out)`` → ConvTranspose2d
  weight ``(in, out, k, k)``, under ``neck`` or ZoeDepth's
  ``reassemble`` alike,
* LayerNorm ``scale`` → ``weight``, and so SegFormer's frozen BatchNorm
  ``bn/scale``; its running statistics ``bn/mean`` and ``bn/var`` keep
  their names (the module's buffers),
* ``block{i}`` → ``blocks.{i}``; ``patch_embed``/``patch_bias`` → the
  ``patch_embed`` Linear; ``ls1``/``ls2``, ``cls_token``, ``pos_embed``
  and BEiT's ``rel_pos_table`` carried across as they are (a BEiT tree
  with ``layer_scale=False`` has no ``ls1``/``ls2``, and neither has the
  port's model of that config).

It imports no JAX, so it takes plain numpy.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_flax"]

_RENAMES = {
    ("backbone", "patch_embed"): "backbone.patch_embed.weight",
    ("backbone", "patch_bias"): "backbone.patch_embed.bias",
}


def _leaves(tree: Mapping, path=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), np.asarray(val)


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested numpy tree (``{"backbone": ..., "neck": ...}`` or ZoeDepth's
    flat head) → state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        if path in _RENAMES:
            name = _RENAMES[path]
            if path[-1] == "patch_embed":
                arr = arr.T
        else:
            parts = [re.sub(r"^block(\d+)$", r"blocks.\1", p) for p in path]
            leaf = parts[-1]
            if leaf == "kernel_q":
                parts[-1] = "weight_q"
                sd[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(arr.T).astype(np.int8))
                continue
            if leaf == "kernel_scale":
                parts[-1] = "weight_scale"
            elif leaf == "kernel":
                parts[-1] = "weight"
                if arr.ndim == 2:
                    arr = arr.T
                elif parts[-2] in ("up0", "up1"):
                    arr = arr.transpose(2, 3, 0, 1)
                else:
                    arr = arr.transpose(3, 2, 0, 1)
            elif leaf == "scale":
                parts[-1] = "weight"
            name = ".".join(parts)
        sd[name] = torch.tensor(np.asarray(arr, dtype=np.float32))
    return sd
