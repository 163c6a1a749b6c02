"""The reference of one upload's point cloud: preprocess → model →
depth upscale → robust normalization → strided unprojection → outlier
keep → the bundle's quantized depth → the host's reconstruction. The
points it keeps are the served PLY's, in grid order.

Runs in f32 with TF32 off on CUDA; ``fp8=True`` is the control (the model
in float8 e4m3, see :mod:`.model`). Imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.reference import model as ref_model
from portbench.reference.ops import (
    dequantized_points,
    normalize_depth,
    outlier_keep,
    processor_size,
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
    arch, pre = cfg["arch"], cfg["preprocess"]
    dev = next(iter(sd.values())).device
    h, w = image.shape[:2]
    if max(h, w) > 3072:
        raise ValueError("the reference covers uploads of at most 3072 pixels a side")
    mh, mw = processor_size(h, w, pre["target"], pre["multiple"], pre["keep_aspect_ratio"])
    img = torch.from_numpy(np.array(image)).to(dev).float()
    x = resize_planes(img.permute(2, 0, 1), (mh, mw), pre["resize"]).permute(1, 2, 0)
    mean = torch.tensor(pre["mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(pre["std"], dtype=torch.float32, device=dev)
    x = (x * (1.0 / 255.0) - mean) / std
    with exact_f32():
        depth = ref_model.forward(sd, arch, x[None], fp8=fp8)[0]
    dn = normalize_depth(resize_planes(depth, (h, w), "linear"), invert=True)
    step = DENSITY_STEP[density]
    dn_s = dn[::step, ::step]
    keep, margin = outlier_keep(unproject_grid(dn_s, depth_scale, step, h, w))
    d12 = quantize_depth(dn_s)
    return Cloud(keep=keep.cpu().numpy(), margin=margin.cpu().numpy(), points=dequantized_points(d12, depth_scale, step, h, w),
                 colors=np.ascontiguousarray(image[::step, ::step]), h=h, w=w, step=step)
