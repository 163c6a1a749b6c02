"""The reference of one upload's point cloud: the family's input handling
→ its model → its output handling (``portbench/reference/families/``),
then one tail for every family: depth upscale → robust normalization →
strided unprojection → outlier keep → the bundle's quantized depth → the
host's reconstruction. The points it keeps are the served PLY's, in grid
order.

Runs in f32 with TF32 off on CUDA; ``fp8=True`` is the control (the model
in float8 e4m3, :class:`portbench.reference.vit_dpt.Ops`). Imports
nothing of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.reference.model import family
from portbench.reference.ops import (
    dequantized_points,
    normalize_depth,
    outlier_keep,
    quantize_depth,
    resize_planes,
    unproject_grid,
)

DENSITY_STEP = {"low": 4, "medium": 2, "high": 1}


@dataclasses.dataclass
class Cloud:
    """One upload's reference cloud on its (hh, ww) strided grid."""

    keep: np.ndarray  # (hh, ww) bool
    margin: np.ndarray  # (hh, ww) f32: distance of the outlier rule's mean from its threshold, relative
    points: np.ndarray  # (hh, ww, 3) f32, from the quantized depth
    colors: np.ndarray  # (hh, ww, 3) u8
    h: int
    w: int
    step: int


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.inference_mode()
def reference_cloud(image: np.ndarray, sd: dict, cfg: dict, *, depth_scale: float,
                    density: str, fp8: bool = False) -> Cloud:
    """(H, W, 3) u8 RGB upload → its reference :class:`Cloud`. ``sd`` holds
    f32 weights on the device the reference runs on."""
    fam = family(cfg["arch"])
    dev = next(iter(sd.values())).device
    h, w = image.shape[:2]
    if max(h, w) > 3072:
        raise ValueError("the reference covers uploads of at most 3072 pixels a side")
    x = fam.model_input(torch.from_numpy(np.array(image)).to(dev).float(), cfg)
    with exact_f32():
        depth = fam.forward(sd, cfg["arch"], x[None], fp8=fp8)[0]
    depth = fam.model_output(depth, cfg, h, w)
    dn = normalize_depth(resize_planes(depth, (h, w), "linear"), invert=True)
    step = DENSITY_STEP[density]
    dn_s = dn[::step, ::step]
    keep, margin = outlier_keep(unproject_grid(dn_s, depth_scale, step, h, w))
    d12 = quantize_depth(dn_s)
    return Cloud(keep=keep.cpu().numpy(), margin=margin.cpu().numpy(), points=dequantized_points(d12, depth_scale, step, h, w),
                 colors=np.ascontiguousarray(image[::step, ::step]), h=h, w=w, step=step)
