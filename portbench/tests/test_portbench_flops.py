"""``portbench/flops.py`` against a count by hand from the published
widths (2 FLOPs a multiply-add; matrix products and convolutions only)."""

import json

import pytest

from portbench import spec
from portbench.flops import flops_per_image


def _cfg(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


def test_dav2_small_at_518():
    # DINOv2 ViT-S/14: 37×37 patches + CLS = 1370 tokens, width 384, 12 layers, MLP 1536.
    t, d, g = 1370, 384, 1369
    enc = 12 * (2 * t * d * d * 4 + 2 * t * d * 1536 * 2 + 4 * t * t * d) + 2 * g * 588 * d
    # DPT neck (48, 96, 192, 384), fusion 64, head 32; stage maps 148², 74², 37², 19².
    neck = 2 * g * d * (48 + 96 + 192 + 384)                      # 1×1 projections at 37²
    neck += 2 * g * 48 * 48 * 16 + 2 * g * 96 * 96 * 4            # ×4 and ×2 transposed convs
    neck += 2 * 19 * 19 * 384 * 384 * 9                           # stride-2 3×3 to 19²
    neck += 2 * 9 * 64 * (148**2 * 48 + 74**2 * 96 + 37**2 * 192 + 19**2 * 384)
    conv64 = 2 * 64 * 64 * 9                                      # a 3×3 fusion conv, per pixel
    neck += conv64 * (2 * 19**2 + 4 * 37**2 + 4 * 74**2 + 4 * 148**2)
    neck += 2 * 64 * 64 * (37**2 + 74**2 + 148**2 + 296**2)       # fusion 1×1 projections
    neck += 2 * 296**2 * 64 * 32 * 9 + 2 * 518**2 * 32 * 32 * 9 + 2 * 518**2 * 32
    assert flops_per_image(_cfg("dav2-small-bf16"), 518, 518) == pytest.approx(enc + neck, rel=1e-12)


def test_dpt_large_at_384():
    # ViT-L/16 at 384² (any upload resizes there): 24×24 + CLS = 577 tokens, width 1024, 24 layers.
    t, d, g = 577, 1024, 576
    enc = 24 * (2 * t * d * d * 4 + 2 * t * d * 4096 * 2 + 4 * t * t * d) + 2 * g * 768 * d
    neck = 4 * 2 * g * 2 * d * d                                  # readout projections
    neck += 2 * g * d * (256 + 512 + 1024 + 1024)
    neck += 2 * g * 256 * 256 * 16 + 2 * g * 512 * 512 * 4
    neck += 2 * 12 * 12 * 1024 * 1024 * 9
    neck += 2 * 9 * 256 * (96**2 * 256 + 48**2 * 512 + 24**2 * 1024 + 12**2 * 1024)
    conv256 = 2 * 256 * 256 * 9
    neck += conv256 * (2 * 12**2 + 4 * 24**2 + 4 * 48**2 + 4 * 96**2)
    neck += 2 * 256 * 256 * (24**2 + 48**2 + 96**2 + 192**2)
    neck += 2 * 192**2 * 256 * 128 * 9 + 2 * 384**2 * 128 * 32 * 9 + 2 * 384**2 * 32
    total = enc + neck
    assert flops_per_image(_cfg("dpt-large-bf16"), 518, 518) == pytest.approx(total, rel=1e-12)
    assert 5.1e11 < total < 5.2e11
