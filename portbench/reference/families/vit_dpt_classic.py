"""Classic DPT (MiDaS 3.0, DPT-Large): a plain ViT (no LayerScale, the
position embedding resampled bilinear), the readout projection, the
classic neck (every fusion ×2) and the monodepth head, at the DPT
processor's fixed square input (arXiv:2103.13413)."""

from __future__ import annotations

from portbench.reference import vit_dpt
from portbench.reference.vit_dpt import (  # noqa: F401
    model_grid, model_input, model_output, model_target, port_fields)


def param_specs(arch: dict) -> list:
    return vit_dpt.param_specs(arch, classic=True)


def forward(sd: dict, arch: dict, pixels, *, fp8: bool = False):
    return vit_dpt.forward(sd, arch, pixels, classic=True, fp8=fp8)


def flops_per_image(cfg: dict, h: int, w: int) -> float:
    return vit_dpt.flops_per_image(cfg, h, w, classic=True)
