"""Device half of the hybrid JPEG decode: dequant + scaled IDCT + chroma
upsample + YCbCr→RGB in torch.

Counterpart of ``image_to_pointcloud_tpu/ops/jpeg.py``. The host does only
the Huffman entropy decode (``image_to_pointcloud_tpu.native``, reused);
everything after the quantized DCT coefficients is dense block math:

- dequantization: one elementwise multiply,
- IDCT: two small f32 matmuls per k×k block, batched over every block,
- chroma upsampling: libjpeg's "fancy" separable triangular filter
  ((3/4, 1/4) per axis) as one small constant matmul per axis,
- YCbCr→RGB: the BT.601 full-range affine transform (ITU-T T.871).

These were XLA formulations on the TPU, not Pallas kernels, so they stay
torch ops here. They run in f32 (the decode feeds the model f32 pixels);
the package never enables TF32.

**Scaled decode.** Decoding can target k/8 scale (k ∈ {1..8}) by keeping
only the top-left k×k of each coefficient block and applying a k-point
inverse DCT scaled by ``sqrt(k/8)`` (which preserves the block mean).

Fidelity: at k=8 the output matches libjpeg (PIL/cv2) within ±3 levels.
The decode functions take any leading batch dims.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.utils.constants import device_constant

__all__ = [
    "JpegSpec",
    "decode_jpeg_to_rgb",
    "host_truncate_coeffs",
    "idct_matrix",
    "plan_scale",
]


@dataclasses.dataclass(frozen=True)
class JpegSpec:
    """Static shape/layout of one entropy-decoded JPEG (hashable: it is
    the serving batch-bucket key of the hybrid ingest)."""

    width: int
    height: int
    ncomp: int  # 1 (grayscale) or 3 (YCbCr)
    h: tuple[int, ...]  # per-component horizontal sampling factors
    v: tuple[int, ...]
    k: int  # scaled-decode factor: output is ~k/8 of full resolution

    @property
    def hmax(self) -> int:
        return max(self.h)

    @property
    def vmax(self) -> int:
        return max(self.v)

    @property
    def out_hw(self) -> tuple[int, int]:
        """Decoded output size at scale k/8 (libjpeg jpeg_calc_output_
        dimensions semantics: ceil(dim·k/8))."""
        return (-(-self.height * self.k // 8), -(-self.width * self.k // 8))

    def block_grid(self, c: int) -> tuple[int, int]:
        """(rows, cols) of 8×8 blocks for component c, incl. MCU padding."""
        mcus_x = -(-self.width // (8 * self.hmax))
        mcus_y = -(-self.height // (8 * self.vmax))
        return mcus_y * self.v[c], mcus_x * self.h[c]


def plan_scale(width: int, height: int, target_hw: tuple[int, int]) -> int:
    """Smallest k ∈ {1..8} whose k/8-scale decode still covers the target
    processing size on both axes (the downstream area resize then only
    ever shrinks)."""
    th, tw = target_hw
    for k in range(1, 8):
        if -(-height * k // 8) >= th and -(-width * k // 8) >= tw:
            return k
    return 8


def idct_matrix(k: int) -> np.ndarray:
    """M[u, x]: k-point inverse-DCT basis over the first k of 8 DCT-II
    coefficients, scaled by sqrt(k/8) so the block mean is preserved."""
    u = np.arange(k)[:, None]
    x = np.arange(k)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / (2 * k))
    a = np.full((k, 1), np.sqrt(2.0 / k))
    a[0, 0] = np.sqrt(1.0 / k)
    return (a * m * np.sqrt(k / 8.0)).astype(np.float32)


def host_truncate_coeffs(coeffs_natural: np.ndarray, k: int) -> np.ndarray:
    """(BH, BW, 64) natural-order host coefficients → the (BH, BW, k, k)
    top-left corner actually transferred for a k/8-scale decode."""
    bh, bw, _ = coeffs_natural.shape
    return np.ascontiguousarray(coeffs_natural.reshape(bh, bw, 8, 8)[:, :, :k, :k])


def _idct_plane(coeffs_kk: torch.Tensor, qtable_kk: torch.Tensor, k: int) -> torch.Tensor:
    """(..., BH, BW, k, k) quantized coefficients and (..., k, k) tables →
    (..., BH·k, BW·k) plane, level-shifted to [0, 255]-ish (unclipped)."""
    m = device_constant(("idct", k), coeffs_kk.device, None, lambda: idct_matrix(k))
    deq = coeffs_kk.float() * qtable_kk.float()[..., None, None, :, :]
    # out[x, y] = Σ_{u,v} M[u,x]·deq[u,v]·M[v,y], batched over blocks,
    # as two products whose right operand is the 2-D M, so that each is
    # one GEMM over all blocks: t = deq·M, outᵀ = tᵀ·M.
    t = torch.matmul(deq, m)  # [..., u, y]
    pxt = torch.matmul(t.transpose(-1, -2), m)  # [..., y, x]
    *lead, bh, bw, _, _ = pxt.shape
    nd = pxt.dim()
    plane = pxt.permute(*range(nd - 4), nd - 4, nd - 1, nd - 3, nd - 2)
    return plane.reshape(*lead, bh * k, bw * k) + 128.0


@functools.lru_cache(maxsize=32)
def _fancy_upsample_matrix(n: int) -> np.ndarray:
    """(n, 2n) matrix form of libjpeg's "fancy" 2× triangular filter:
    out[2i] = (3·c[i] + c[i-1])/4, out[2i+1] = (3·c[i] + c[i+1])/4 with
    edge replication (jdsample.c h2v1/h2v2)."""
    m = np.zeros((n, 2 * n), np.float32)
    idx = np.arange(n)
    m[idx, 2 * idx] += 0.75
    m[np.maximum(idx - 1, 0), 2 * idx] += 0.25
    m[idx, 2 * idx + 1] += 0.75
    m[np.minimum(idx + 1, n - 1), 2 * idx + 1] += 0.25
    return m


def _fancy_upsample_axis(p: torch.Tensor, axis: int) -> torch.Tensor:
    """libjpeg "fancy" 2× upsampling of a (..., H, W) plane along its row
    (``axis=0``) or column (``axis=1``) axis, as one constant matmul."""
    n = p.shape[-2 + axis]
    m = device_constant(("fancy_upsample", n), p.device, None, lambda: _fancy_upsample_matrix(n))
    if axis == 0:
        return torch.matmul(p.transpose(-1, -2), m).transpose(-1, -2)
    return torch.matmul(p, m)


def _upsample_to(
    plane: torch.Tensor, out_h: int, out_w: int, ry: int, rx: int
) -> torch.Tensor:
    """(..., H, W) chroma plane → luma grid. Factors of 2 use the fancy
    filter; anything else nearest-replicates (libjpeg's int_upsample)."""
    # Crop to the component's valid region first so MCU padding blocks
    # never bleed into the filter at the right/bottom edge.
    ch = -(-out_h // ry)
    cw = -(-out_w // rx)
    plane = plane[..., :ch, :cw]
    for axis, r in ((0, ry), (1, rx)):
        if r == 2:
            plane = _fancy_upsample_axis(plane, axis)
        elif r != 1:
            plane = plane.repeat_interleave(r, dim=plane.dim() - 2 + axis)
    return plane[..., :out_h, :out_w]


def _decode_planes(
    coeffs: "tuple[torch.Tensor, ...]", qtables: torch.Tensor, spec: JpegSpec
) -> torch.Tensor:
    """Per-component (..., BH, BW, k, k) int16 coefficients + (..., ncomp,
    64) natural-order tables → (..., out_h, out_w, 3) f32 RGB in
    [0, 255], rounded to the uint8 grid."""
    out_h, out_w = spec.out_hw
    k = spec.k
    planes = []
    for c in range(spec.ncomp):
        q = qtables[..., c, :].reshape(*qtables.shape[:-2], 8, 8)[..., :k, :k]
        p = _idct_plane(coeffs[c], q, k)
        ry = spec.vmax // spec.v[c]
        rx = spec.hmax // spec.h[c]
        if ry == 1 and rx == 1:
            p = p[..., :out_h, :out_w]
        else:
            p = _upsample_to(p, out_h, out_w, ry, rx)
        planes.append(p)
    if spec.ncomp == 1:
        y = planes[0]
        rgb = torch.stack([y, y, y], -1)
    else:
        y, cb, cr = planes
        cb = cb - 128.0
        cr = cr - 128.0
        # BT.601 full-range (ITU-T T.871), libjpeg's constants.
        rgb = torch.stack(
            [
                y + 1.402 * cr,
                y - 0.344136286 * cb - 0.714136286 * cr,
                y + 1.772 * cb,
            ],
            -1,
        )
    # libjpeg rounds to uint8; stay f32 on the uint8 grid.
    return torch.clamp(torch.round(rgb), 0.0, 255.0)


def decode_jpeg_to_rgb(
    coeffs: "tuple[torch.Tensor, ...]", qtables: torch.Tensor, spec: JpegSpec
) -> torch.Tensor:
    """(per-component (..., BH, BW, k, k) int16 coefficient grids,
    (..., ncomp, 64) natural-order quant tables) → (..., out_h, out_w, 3)
    f32 RGB in [0, 255], rounded to the uint8 grid."""
    lead = qtables.shape[:-2]
    for c in range(spec.ncomp):
        bh, bw = spec.block_grid(c)
        if tuple(coeffs[c].shape) != (*lead, bh, bw, spec.k, spec.k):
            raise ValueError(
                f"component {c}: expected {(*lead, bh, bw, spec.k, spec.k)}, "
                f"got {tuple(coeffs[c].shape)}"
            )
    return _decode_planes(coeffs, qtables, spec)
