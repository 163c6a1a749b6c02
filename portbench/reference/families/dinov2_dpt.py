"""Depth Anything V2: a DINOv2 ViT (LayerScale, a final norm, the position
embedding resampled bicubic) and the DPT neck of Depth Anything, at the
DPT processor's keep-aspect, multiple-of-14 input (arXiv:2406.09414)."""

from __future__ import annotations

from portbench.reference import vit_dpt
from portbench.reference.vit_dpt import (  # noqa: F401
    model_grid, model_input, model_output, model_target, port_fields)


def param_specs(arch: dict) -> list:
    return vit_dpt.param_specs(arch, classic=False)


def forward(sd: dict, arch: dict, pixels, *, fp8: bool = False):
    return vit_dpt.forward(sd, arch, pixels, classic=False, fp8=fp8)


def flops_per_image(cfg: dict, h: int, w: int) -> float:
    return vit_dpt.flops_per_image(cfg, h, w, classic=False)
