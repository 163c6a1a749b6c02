"""The quantized device→host transfer: depth codecs, keep bits, and the
host-side reconstruction of points and colours.

Counterpart of ``image_to_pointcloud_tpu/pipeline/graph.py:109-362``. The
device halves (:func:`pack_depth12`, :func:`pack_depth8t`,
:func:`pack_keep_bits`) are torch and give the JAX package's bytes; the
host halves (:func:`unpack_depth12`, :func:`unpack_depth8t`,
:func:`depth16_to_xyz`, :func:`ycc420_to_rgb_f32`) are numpy copies,
because importing the JAX module would pull in JAX.

The codec arithmetic runs in int32 (shifts and masks on ``torch.uint16``
are thin on both the CPU and CUDA) and casts to uint8 at the end.
Rounding is ``torch.round``'s half-to-even, as ``jnp.round``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.utils.constants import device_constant

__all__ = [
    "depth16_to_xyz",
    "depth8t_section_len",
    "pack_depth12",
    "pack_depth16",
    "pack_depth8t",
    "pack_keep_bits",
    "unpack_depth12",
    "unpack_depth8t",
    "ycc420_to_rgb_f32",
]

_D8T_SIDE_FRAC = 8  # 12-bit side-list capacity = ceil(tiles / 8)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8)


def _nibble_pack(a: torch.Tensor, b: torch.Tensor) -> list[torch.Tensor]:
    """Two int32 12-bit planes → [lo_a | lo_b | hi] uint8 planes (a's high
    nibble in bits 0-3 of ``hi``, b's in bits 4-7)."""
    return [_u8(a & 0xFF), _u8(b & 0xFF), _u8((a >> 8) | ((b >> 8) << 4))]


def pack_depth16(dn_s: torch.Tensor) -> torch.Tensor:
    """The full u16 contract (``IPC_TPU_DEPTH16=1``): (B, hh, ww)
    normalized depth → (B, 2·hh·ww) u8, little-endian u16 per point."""
    d16 = torch.round(dn_s * 65535.0).to(torch.int32).reshape(dn_s.shape[0], -1)
    return torch.stack([_u8(d16 & 0xFF), _u8(d16 >> 8)], dim=-1).reshape(dn_s.shape[0], -1)


def pack_depth12(dn_s: torch.Tensor) -> torch.Tensor:
    """Device half of the 12-bit depth transfer: (B, hh, ww) normalized
    depth in [0, 1] → (B, 3·ceil(n/2)) u8 planar pack
    ``[lo_a | lo_b | hi]``: the flat grid splits into halves a/b, the low
    bytes ship as two planes and ``hi`` carries both 4-bit high nibbles.
    1.5 bytes/point; quantization RMSE depth_scale/4095/√12."""
    bq = dn_s.shape[0]
    d12 = torch.round(dn_s * 4095.0).to(torch.int32).reshape(bq, -1)
    n = d12.shape[1]
    half = -(-n // 2)
    d12 = torch.nn.functional.pad(d12, (0, 2 * half - n))
    return torch.cat(_nibble_pack(d12[:, :half], d12[:, half:]), dim=1)


def unpack_depth12(sec: np.ndarray, n: int) -> np.ndarray:
    """Host half of :func:`pack_depth12`: (B, 3·ceil(n/2)) u8 → (B, n)
    u16 with values in [0, 4095] (dequantize with denom=4095)."""
    half = -(-n // 2)
    lo_a = sec[:, :half].astype(np.uint16)
    lo_b = sec[:, half : 2 * half].astype(np.uint16)
    hi = sec[:, 2 * half : 3 * half].astype(np.uint16)
    da = lo_a | ((hi & 0xF) << 8)
    db = lo_b | ((hi >> 4) << 8)
    return np.concatenate([da, db], axis=1)[:, :n]


def _d8t_geometry(hh: int, ww: int) -> tuple[int, int, int, int]:
    """(tiles_h, tiles_w, tile_count, side_capacity) for an (hh, ww)
    strided depth grid under the 8×8-tile sub-byte codec."""
    th, tw = -(-hh // 8), -(-ww // 8)
    t = th * tw
    return th, tw, t, -(-t // _D8T_SIDE_FRAC)


def depth8t_section_len(hh: int, ww: int) -> int:
    """Bundle-section bytes for :func:`pack_depth8t` on an (hh, ww) grid:
    4 B/tile headers + 1 B/pt codes + (2 + 96) B per side-list slot. Only
    small on large, roughly 8-aligned grids; the pipeline falls back to
    :func:`pack_depth12` whenever this is not below ``3·ceil(n/2)``."""
    _, _, t, k = _d8t_geometry(hh, ww)
    return 4 * t + 64 * t + 2 * k + 96 * k


def pack_depth8t(dn_s: torch.Tensor) -> torch.Tensor:
    """Sub-byte tiled depth transfer: (B, hh, ww) normalized depth in
    [0, 1] → one u8 row per image.

    Quantize to the 12-bit grid (d12 = round(dn·4095)), split into 8×8
    tiles (edge-replicated padding), and ship per-tile u16 ``min``/
    ``range`` headers plus one u8 code per point
    (``code = round((d12 − min)·255/max(range, 1))``). The ``ceil(T/8)``
    tiles of largest range also ship their exact d12 values in a 12-bit
    side list with u16 tile indices; among equal ranges the lower tile
    index comes first, as ``lax.top_k`` orders them (a stable descending
    sort, so the bytes equal the JAX package's). Row layout:
    ``[min_lo | min_hi | range_lo | range_hi | codes(tile-major) |
    side_idx_lo | side_idx_hi | side_12bit]``. Host half:
    :func:`unpack_depth8t` (dequantize with denom=4095)."""
    bq, hh, ww = dn_s.shape
    th, tw, t, k = _d8t_geometry(hh, ww)
    d12 = torch.round(dn_s.clamp(0.0, 1.0) * 4095.0).to(torch.int32)
    dev = d12.device
    rows = torch.arange(th * 8, device=dev).clamp_max(hh - 1)
    cols = torch.arange(tw * 8, device=dev).clamp_max(ww - 1)
    d12 = d12[:, rows][:, :, cols]  # edge padding
    tiles = d12.reshape(bq, th, 8, tw, 8).permute(0, 1, 3, 2, 4).reshape(bq, t, 64)
    mn = tiles.amin(dim=-1)
    rng = tiles.amax(dim=-1) - mn
    denom = rng.clamp_min(1).to(torch.float32)
    # A tensor numerator: a Python scalar over a tensor is computed as
    # reciprocal·scalar, which rounds differently from the f32 division.
    ratio = torch.full((), 255.0, dtype=torch.float32, device=dev) / denom
    codes = torch.round((tiles - mn[..., None]).to(torch.float32) * ratio[..., None])
    idx = torch.sort(rng, dim=-1, descending=True, stable=True).indices[:, :k]
    side = torch.gather(tiles, 1, idx[..., None].expand(bq, k, 64))
    side_pack = torch.cat(_nibble_pack(side[..., :32], side[..., 32:]), dim=-1)
    idx = idx.to(torch.int32)
    return torch.cat(
        [
            _u8(mn & 0xFF),
            _u8(mn >> 8),
            _u8(rng & 0xFF),
            _u8(rng >> 8),
            _u8(codes).reshape(bq, 64 * t),
            _u8(idx & 0xFF),
            _u8(idx >> 8),
            side_pack.reshape(bq, 96 * k),
        ],
        dim=1,
    )


def unpack_depth8t(sec: np.ndarray, hh: int, ww: int) -> np.ndarray:
    """Host half of :func:`pack_depth8t`: (B, depth8t_section_len) u8 →
    (B, hh, ww) u16 with values in [0, 4095] (dequantize with
    denom=4095)."""
    th, tw, t, k = _d8t_geometry(hh, ww)
    b = sec.shape[0]
    u16 = lambda lo, hi: lo.astype(np.uint16) | (hi.astype(np.uint16) << 8)  # noqa: E731
    mn = u16(sec[:, 0:t], sec[:, t : 2 * t])
    rng = u16(sec[:, 2 * t : 3 * t], sec[:, 3 * t : 4 * t])
    o = 4 * t
    codes = sec[:, o : o + 64 * t].reshape(b, t, 64).astype(np.float32)
    o += 64 * t
    idx = u16(sec[:, o : o + k], sec[:, o + k : o + 2 * k]).astype(np.int64)
    o += 2 * k
    sp = sec[:, o : o + 96 * k].reshape(b, k, 96)
    lo_a = sp[..., :32].astype(np.uint16)
    lo_b = sp[..., 32:64].astype(np.uint16)
    hi = sp[..., 64:].astype(np.uint16)
    side = np.concatenate([lo_a | ((hi & 0xF) << 8), lo_b | ((hi >> 4) << 8)], axis=-1)
    denom = np.maximum(rng, 1).astype(np.float32)
    tiles = (
        mn.astype(np.float32)[..., None] + np.round(codes * (denom[..., None] / 255.0))
    ).astype(np.uint16)
    np.put_along_axis(tiles, idx[..., None], side, axis=1)
    d = tiles.reshape(b, th, tw, 8, 8).transpose(0, 1, 3, 2, 4).reshape(b, th * 8, tw * 8)
    return np.ascontiguousarray(d[:, :hh, :ww])


def pack_keep_bits(mask: torch.Tensor) -> torch.Tensor:
    """Bit-pack a boolean keep mask along its last axis (8 points/byte,
    little-endian bit order: ``np.unpackbits(..., bitorder="little")``
    on the host)."""
    n = mask.shape[-1]
    kb = torch.nn.functional.pad(mask.to(torch.int32), (0, (-n) % 8))
    kb = kb.reshape(*mask.shape[:-1], -1, 8)
    weights = device_constant(("keep_bit_weights",), mask.device, torch.int32,
                              lambda: [1, 2, 4, 8, 16, 32, 64, 128])
    return _u8((kb * weights).sum(dim=-1))


def depth16_to_xyz(
    d16: np.ndarray,
    depth_scales: np.ndarray,
    *,
    step: int,
    f: float,
    cx: float,
    cy: float,
    denom: float = 65535.0,
) -> np.ndarray:
    """Host half of the depth transfer: (B, hh, ww) u16 quantized
    normalized depth → (B, 3, hh·ww) f32 XYZ, the unprojection's exact
    math (the z == 0 epsilon included). ``denom`` is the quantization
    denominator (65535 for the u16 contract, 4095 for the 12-bit and
    tiled codecs)."""
    b, hh, ww = d16.shape
    n = hh * ww
    dn = d16.astype(np.float32) * np.float32(1.0 / denom)
    z = dn * np.asarray(depth_scales, np.float32).reshape(b, 1, 1)
    zs = np.where(z != 0.0, z, np.float32(1e-6))
    u = (np.arange(ww, dtype=np.float32) * step - np.float32(cx))[None, None, :]
    v = (np.arange(hh, dtype=np.float32) * step - np.float32(cy))[None, :, None]
    return np.stack(
        [
            (u * zs / np.float32(f)).reshape(b, n),
            (v * zs / np.float32(f)).reshape(b, n),
            z.reshape(b, n),
        ],
        axis=1,
    )


def ycc420_to_rgb_f32(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Host half of the hybrid-JPEG 4:2:0 colour ride-along: (B, hh, ww)
    u8 luma + (B, ceil(hh/2), ceil(ww/2)) u8 chroma → (B, hh, ww, 3) f32
    RGB (integer-valued, BT.601 full-range inverse, ties-to-even).
    Bit-identical to ``native.reconstruct_points_ycc420``'s per-point
    math."""
    hh, ww = y.shape[1], y.shape[2]
    yf = y.astype(np.float32)
    up = lambda p: np.repeat(np.repeat(p, 2, axis=1), 2, axis=2)[:, :hh, :ww].astype(np.float32)  # noqa: E731
    cbf = up(cb) - np.float32(128.0)
    crf = up(cr) - np.float32(128.0)
    rgb = np.stack(
        [
            yf + np.float32(1.402) * crf,
            yf - np.float32(0.344136286) * cbf - np.float32(0.714136286) * crf,
            yf + np.float32(1.772) * cbf,
        ],
        axis=-1,
    )
    return np.clip(np.rint(rgb), 0.0, 255.0)
