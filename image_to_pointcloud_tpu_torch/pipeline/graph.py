"""The batched image→point-cloud pipeline over one depth model.

Counterpart of ``image_to_pointcloud_tpu/pipeline/graph.py``'s
``DepthPipeline``. One batch runs, on the model's device:

  [JPEG: sparse or dense DCT payload → scatter → dequant + IDCT +
  chroma upsample + colour] or uint8 RGB pixels → [area-downscale] →
  [ZoeDepth: reflect pad] → resize + normalize → depth forward (any
  family: DA-V2, classic DPT, ZoeDepth) → [ZoeDepth: bicubic back to the
  padded size, crop] → linear depth upscale → robust normalize →
  [gaussian blur] → gray preview → pinhole unprojection → packed
  (B, 8, N) point buffer → windowed grid-kNN outlier mask (row 6; the
  exact O(N²) kNN with ``exact_outlier``) →
  [quantized bundle: depth codec + keep bits + optional colours]

Two ingests: decoded pixels (:meth:`DepthPipeline.submit_batch`), and the
hybrid JPEG device decode (:meth:`DepthPipeline.submit_batch_jpeg`), whose
host half is :func:`plan_jpeg_input`. Two device→host returns, as in the
JAX package: the f32 packed buffer, and the quantized bundle, which is the
default on any device but the CPU (:func:`default_quantized_transfer`);
the host then reconstructs the points (``pipeline/transfer.py``, the
native reconstruct).

The JAX package compiles one graph per shape signature; PyTorch runs
eagerly, so there is no compile cache. :meth:`DepthPipeline.submit_batch`
enqueues the work (asynchronous on CUDA) and :meth:`DepthPipeline.collect`
brings the result to the host and splits it per image.

The dummy models' graphs (:func:`dummy_point_cloud_graph`,
:func:`demo_depth_map_graph`) are plain torch ops on the service's device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_to_pointcloud_tpu_torch.ops.colormap import PLASMA_RGB
from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth
from image_to_pointcloud_tpu_torch.ops.gaussian import gaussian_blur
from image_to_pointcloud_tpu_torch.ops.jpeg import (
    JpegSpec,
    _decode_planes,
    host_truncate_coeffs,
    plan_scale,
)
from image_to_pointcloud_tpu_torch.ops.jpeg_sparse import (
    block_pack,
    capacity_bucket,
    coeff_layout,
    exception_bucket,
    scatter_from_blocks,
    sparse_payload_bytes,
    sparse_row_sections,
)
from image_to_pointcloud_tpu_torch.ops.outlier import (
    grid_knn_mean_distances,
    outlier_keep_from_means,
    statistical_outlier_mask,
)
from image_to_pointcloud_tpu_torch.ops.resize import resize_batched, resize_planes
from image_to_pointcloud_tpu_torch.ops.unproject import (
    DENSITY_STRIDES,
    focal_length,
    unproject,
)
from image_to_pointcloud_tpu_torch.pipeline.preprocess import (
    model_preprocess_spec,
    preprocess_for_model,
    processor_output_size,
    reflect_pad_margins,
)
from image_to_pointcloud_tpu_torch.pipeline.transfer import (
    depth16_to_xyz,
    depth8t_section_len,
    pack_depth12,
    pack_depth16,
    pack_depth8t,
    pack_keep_bits,
    unpack_depth12,
    unpack_depth8t,
    ycc420_to_rgb_f32,
)

__all__ = [
    "DepthPipeline",
    "JpegInput",
    "PipelineOptions",
    "PipelineResult",
    "default_quantized_transfer",
    "demo_depth_map_graph",
    "dummy_point_cloud_graph",
    "plan_jpeg_input",
    "plan_sparse_batch",
]

MAX_IMAGE_DIM = 3072  # reference backend/app.py:43
DEPTH_PREVIEW_MAX = 2048  # reference backend/app.py:44


@dataclasses.dataclass(frozen=True)
class PipelineOptions:
    """Per-request knobs (the ``ProcessingRequest`` fields that shape the
    work; reference backend/app.py:47-56)."""

    density: str = "medium"
    invert_depth: bool = True
    smooth_depth: bool = False
    smooth_ksize: int = 5
    fov: float | None = None
    refine: bool = True  # statistical outlier removal on/off
    # Exact O(N²) kNN (Open3D-identical) instead of the windowed grid
    # search (K2; exact on smooth surfaces, ~1000× faster).
    exact_outlier: bool = False


@dataclasses.dataclass
class PipelineResult:
    points: np.ndarray  # (M, 3) float32, outliers removed
    colors: np.ndarray  # (M, 3) float32 RGB 0-255
    depth_preview_rgb: np.ndarray | None  # (ph, pw, 3) uint8
    raw_point_count: int
    kept_point_count: int
    packed: np.ndarray | None = None  # (8, N) planar buffer (grid-ordered)
    grid_hw: tuple[int, int] | None = None  # strided grid shape (hh, ww)
    # Pre-LUT normalized depth (u8), for paletted PNG previews.
    depth_preview_gray: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class _Handle:
    out: torch.Tensor  # (B, 8, N) f32 packed points, or (B, nbytes) u8 bundle
    preview: torch.Tensor | None  # (B, ph, pw) gray or (B, ph, pw, 3) RGB u8
    quantized: bool
    grid_hw: tuple[int, int]
    work_hw: tuple[int, int]  # (h, w): the working size, for the intrinsics
    step: int
    fov: float | None
    depth_scales: np.ndarray  # (B,) f32
    imgs: np.ndarray | None  # host pixels; None on the JPEG ingest
    host_rgb: np.ndarray | None  # (B, hh, ww, 3) u8 host-reconstructed colours


def default_quantized_transfer(device: "str | torch.device") -> bool:
    """The quantized bundle on an accelerator, the f32 packed buffer on
    the CPU (where the copy is free and f32 keeps tests bit-simple).
    ``IPC_TPU_QUANTIZED=1|0`` overrides either way."""
    forced = os.environ.get("IPC_TPU_QUANTIZED")
    if forced in ("0", "1"):
        return forced == "1"
    return torch.device(device).type != "cpu"


def _preview_hw(h: int, w: int) -> tuple[int, int]:
    m = max(h, w)
    if m <= DEPTH_PREVIEW_MAX:
        return h, w
    s = DEPTH_PREVIEW_MAX / float(m)
    return int(round(h * s)), int(round(w * s))


def _proc_hw(h: int, w: int) -> tuple[int, int]:
    """Post-downscale working size (reference backend/app.py:438-445)."""
    m = max(h, w)
    if m <= MAX_IMAGE_DIM:
        return h, w
    s = MAX_IMAGE_DIM / float(m)
    return int(round(h * s)), int(round(w * s))


def _smooth_ksize(ksize: int) -> int:
    """Reference odd-kernel clamp (backend/app.py:210-212)."""
    return max(3, int(ksize) // 2 * 2 + 1)


def _normalize_each(depth: torch.Tensor, invert: bool) -> torch.Tensor:
    return torch.stack([normalize_depth(d, invert) for d in depth])


def _view(payload: torch.Tensor, off: int, size: int, dtype: torch.dtype) -> torch.Tensor:
    """Bytes [off, off+size) of every payload row, reinterpreted as
    ``dtype`` (little-endian, as the host packed them)."""
    return payload[:, off : off + size].contiguous().view(dtype)


# ---------- hybrid JPEG ingest ----------


def _unpack_jpeg_batch(
    payload_u8: torch.Tensor, spec: JpegSpec
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense hybrid-ingest payload rows → ((B, oh, ow, 3) f32 RGB in
    [0, 255], (B,) f32 depth scales). Row layout (little-endian, matching
    :meth:`DepthPipeline.pack_jpeg_payload`): [per-component
    (BH·BW·k·k) int16 coeffs | (ncomp·64) f32 qtables | f32 depth_scale]."""
    b = payload_u8.shape[0]
    k = spec.k
    off = 0
    coeffs = []
    for c in range(spec.ncomp):
        bh, bw = spec.block_grid(c)
        n = bh * bw * k * k * 2
        coeffs.append(_view(payload_u8, off, n, torch.int16).reshape(b, bh, bw, k, k))
        off += n
    nq = spec.ncomp * 64 * 4
    qt = _view(payload_u8, off, nq, torch.float32).reshape(b, spec.ncomp, 64)
    scales = _view(payload_u8, off + nq, 4, torch.float32).reshape(-1)
    return _decode_planes(tuple(coeffs), qt, spec), scales


def _unpack_jpeg_sparse_fields(
    payload_u8: torch.Tensor, spec: JpegSpec, cap: int, exc_cap: int
) -> tuple[torch.Tensor, ...]:
    """Slice one batch of split-sparse payload rows into its typed
    fields: (counts i32, dc i32, pos i32, val i8, exc_idx i32, exc_val
    i16, qtables f32, scales f32). Layout from
    ``ops.jpeg_sparse.sparse_row_sections``, shared with the host packer."""
    sections, _ = sparse_row_sections(spec, cap, exc_cap)
    b = payload_u8.shape[0]

    def sl(name, dtype=torch.uint8):
        return _view(payload_u8, *sections[name], dtype)

    counts = sl("counts").to(torch.int32)
    # Signed i16 DC from planar bytes: signed high byte · 256 + low.
    dc = sl("dc_hi", torch.int8).to(torch.int32) * 256 + sl("dc_lo").to(torch.int32)
    return (
        counts,
        dc,
        sl("pos").to(torch.int32),
        sl("val", torch.int8),
        sl("exc_idx", torch.int32),
        sl("exc_val", torch.int16),
        sl("qt", torch.float32).reshape(b, spec.ncomp, 64),
        sl("scale", torch.float32).reshape(-1),
    )


def _unpack_jpeg_sparse_batch(
    payload_u8: torch.Tensor, spec: JpegSpec, cap: int, exc_cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse hybrid-ingest payload rows → ((B, oh, ow, 3) f32 RGB, (B,)
    f32 depth scales), the whole batch in one scatter and one decode."""
    counts, dc, pos, val, exc_idx, exc_val, qt, scales = _unpack_jpeg_sparse_fields(
        payload_u8, spec, cap, exc_cap
    )
    grids = scatter_from_blocks(counts, dc, pos, val, exc_idx, exc_val, spec)
    return _decode_planes(grids, qt, spec), scales


@dataclasses.dataclass
class JpegInput:
    """Host-side product of :func:`plan_jpeg_input`: one JPEG
    entropy-decoded and truncated for a k/8-scale device decode. Stands
    in for the decoded RGB array on the hybrid ingest (serving groups
    these by ``spec`` the way pixel items group by shape)."""

    spec: JpegSpec
    coeffs: list  # per-component (BH, BW, k, k) int16, natural order
    qtables: np.ndarray  # (ncomp, 64) float32, natural order
    # Split sparse blocked encoding (ops/jpeg_sparse.py), lazy:
    counts: "np.ndarray | None" = None  # (nblocks,) u8 AC counts
    dc: "np.ndarray | None" = None  # (nblocks,) i16
    pos: "np.ndarray | None" = None  # (nnz_ac,) u8
    val: "np.ndarray | None" = None  # (nnz_ac,) i8
    exc_idx: "np.ndarray | None" = None  # (nexc,) i32 slots into pos/val
    exc_val: "np.ndarray | None" = None  # (nexc,) i16
    # Host-reconstructed grid colours per stride (lazy, see grid_colors).
    _gc_cache: dict = dataclasses.field(default_factory=dict)

    @property
    def orig_hw(self) -> tuple[int, int]:
        return self.spec.height, self.spec.width

    def grid_colors(self, step: int) -> "np.ndarray | None":
        """(ceil(h/step), ceil(w/step), 3) u8 RGB at the strided grid,
        reconstructed on the host from the coefficients
        (``native.jpeg_grid_colors``): replaces the 4:2:0 colour ride-along
        of the device→host bundle. None when the layout is unsupported
        (k<8, a pending device resize, exotic sampling factors, no native
        library); the bundle then keeps the ride-along. Cached per step."""
        if step not in self._gc_cache:
            from image_to_pointcloud_tpu_torch import native

            colors = None
            # The device samples colours after its area resize to the
            # working size; the host's match only when nothing resizes.
            if self.spec.out_hw == _proc_hw(self.spec.height, self.spec.width):
                colors = native.jpeg_grid_colors(self.coeffs, self.qtables, self.spec, step)
            self._gc_cache[step] = colors
        return self._gc_cache[step]

    def sparse(self) -> tuple[np.ndarray, ...]:
        """(counts, dc, pos, val, exc_idx, exc_val) of the split sparse
        encoding, packed on first use and cached."""
        if self.counts is None:
            (
                self.counts, self.dc, self.pos, self.val, self.exc_idx, self.exc_val,
            ) = block_pack(self.coeffs)
        return self.counts, self.dc, self.pos, self.val, self.exc_idx, self.exc_val

    @property
    def dense_bytes(self) -> int:
        return sum(c.nbytes for c in self.coeffs)


def plan_jpeg_input(data: bytes) -> "JpegInput | None":
    """Entropy-decode ``data`` for the hybrid device-decode ingest, or
    None when the path does not apply: not a supported JPEG (sequential
    and progressive Huffman streams qualify), the native library is
    missing, or the sparse coefficient payload would not ship
    meaningfully fewer bytes than the pixels it replaces (e.g.
    quality-100 noise keeps the host decode).

    Scale: k<8 engages for images the reference would area-downscale
    (>~3510 px max dim). At k=8 the device decode is full resolution and
    matches libjpeg within ±3 levels. The 0.75 margin charges the hybrid
    path for its colour ride-along on the device→host side."""
    from image_to_pointcloud_tpu_torch import native

    r = native.jpeg_coefficients(data)
    if r is None:
        return None
    h, w = _proc_hw(r["height"], r["width"])
    k = plan_scale(r["width"], r["height"], (h, w))
    spec = JpegSpec(r["width"], r["height"], r["ncomp"], tuple(r["h"]), tuple(r["v"]), k)
    coeffs = [host_truncate_coeffs(c, k) for c in r["coeffs"]]
    # Gate on cheap counts before building the pos/val arrays: a declined
    # JPEG falls back to the full host decode.
    if k >= 8:
        _, total = coeff_layout(spec)
        nnz_ac = 0
        nexc = 0
        for c in coeffs:
            nnz_ac += int(np.count_nonzero(c)) - int(np.count_nonzero(c[:, :, 0, 0]))
            wide = (c < -128) | (c > 127)
            wide[:, :, 0, 0] = False  # DC ships dense i16 regardless
            nexc += int(np.count_nonzero(wide))
        if sparse_payload_bytes(nnz_ac, nexc, total) >= 0.75 * h * w * 3:
            return None
    counts, dc, pos, val, exc_idx, exc_val = block_pack(coeffs)
    return JpegInput(
        spec=spec,
        coeffs=coeffs,
        qtables=r["qtables"].astype(np.float32),
        counts=counts,
        dc=dc,
        pos=pos,
        val=val,
        exc_idx=exc_idx,
        exc_val=exc_val,
    )


def plan_sparse_batch(jpegs: "list[JpegInput]") -> "tuple[int, int] | None":
    """(AC capacity, exception capacity) buckets for one hybrid batch, or
    None when the dense int16 payload ships fewer bytes (the batch then
    takes the dense payload)."""
    spec = jpegs[0].spec
    _, total = coeff_layout(spec)
    nblocks = total // (spec.k * spec.k)
    cap = capacity_bucket(max(len(j.sparse()[2]) for j in jpegs), total)
    exc_cap = exception_bucket(max(len(j.sparse()[4]) for j in jpegs))
    if 3 * nblocks + 2 * cap + 6 * exc_cap < 2 * total:
        return cap, exc_cap
    return None


class DepthPipeline:
    """The depth→point-cloud pipeline over one model of any family on one
    device (the model's own device and dtype: bf16 on CUDA for serving,
    f32 on CPU).

    ``quantized_transfer=None`` follows :func:`default_quantized_transfer`
    for the model's device. The bundle's depth codec is the 8×8-tiled
    sub-byte one; ``IPC_TPU_DEPTH12=1`` selects the flat 12-bit pack and
    ``IPC_TPU_DEPTH16=1`` the u16 contract. On the JPEG ingest the host
    rebuilds the grid colours from the coefficients when it can;
    ``IPC_TPU_HOST_COLORS=0`` keeps the device's 4:2:0 ride-along."""

    def __init__(
        self,
        model: nn.Module,
        *,
        model_target: "int | tuple[int, int] | None" = None,
        quantized_transfer: bool | None = None,
    ):
        self.model = model.eval()
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        (
            self.model_target,
            self.size_multiple,
            self.pixel_mean,
            self.pixel_std,
            self.resize_method,
            self.keep_aspect,
        ) = model_preprocess_spec(self.cfg, model_target)
        if quantized_transfer is None:
            quantized_transfer = default_quantized_transfer(self.device)
        self.quantized_transfer = quantized_transfer
        self.depth_bits = (
            16
            if os.environ.get("IPC_TPU_DEPTH16") == "1"
            else (12 if os.environ.get("IPC_TPU_DEPTH12") == "1" else 8)
        )
        self.host_colors_enabled = os.environ.get("IPC_TPU_HOST_COLORS", "1") != "0"

    def _depth_codec_bits(self, hh: int, ww: int) -> int:
        """Effective depth codec for an (hh, ww) strided grid: the tiled
        codec only wins on large, roughly 8-aligned grids, so fall back
        to 12-bit whenever its section would not be strictly smaller.
        Deterministic in (hh, ww): pack and unpack always agree."""
        if self.depth_bits == 8 and depth8t_section_len(hh, ww) >= 3 * (-(-(hh * ww) // 2)):
            return 12
        return self.depth_bits

    @torch.inference_mode()
    def _forward(
        self,
        img: torch.Tensor,
        depth_scales: torch.Tensor,
        in_hw: tuple[int, int],
        options: PipelineOptions = PipelineOptions(),
        preview: bool = True,
        *,
        jpeg: bool = False,
        host_colors: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(B, sh, sw, 3) f32 source pixels (the upload, or its JPEG
        decode at ``spec.out_hw``) + (B,) f32 scales, on the model's
        device, of an upload of size ``in_hw`` → (the (B, 8, N) packed
        points or the (B, nbytes) u8 bundle, preview or None)."""
        opts = options
        h0, w0 = in_hw
        h, w = _proc_hw(h0, w0)
        # ZoeDepth reflect-pads the working image before the resize and
        # crops the prediction back; (0, 0) for the other families.
        pad_h, pad_w = reflect_pad_margins(self.cfg, h, w)
        hp, wp = h + 2 * pad_h, w + 2 * pad_w
        mh, mw = processor_output_size(
            hp, wp, self.model_target, multiple=self.size_multiple,
            keep_aspect_ratio=self.keep_aspect,
        )
        # The depth grid everything after the model sees: the model
        # resolution, or the unpadded working size once the pad is cropped.
        dmh, dmw = (h, w) if (pad_h or pad_w) else (mh, mw)
        step = DENSITY_STRIDES[opts.density]
        pv_h, pv_w = _preview_hw(dmh, dmw)

        if tuple(img.shape[1:3]) != (h, w):
            # cv2 resizes the uint8 image (rounding); match it.
            img = resize_batched(img, (h, w), "area").round().clamp(0, 255)
        img_in = img
        if pad_h or pad_w:
            img_in = F.pad(
                img.permute(0, 3, 1, 2), (pad_w, pad_w, pad_h, pad_h), mode="reflect"
            ).permute(0, 2, 3, 1)
        x = preprocess_for_model(
            img_in, (mh, mw), mean=self.pixel_mean, std=self.pixel_std,
            method=self.resize_method,
        )
        depth = self.model(x)  # (B, mh, mw) f32
        if pad_h or pad_w:
            # ZoeDepth's post-process: bicubic (align_corners=False) back
            # to the padded size, then the margins cropped.
            depth = resize_planes(depth, (hp, wp), "bicubic_torch")
            depth = depth[:, pad_h : hp - pad_h, pad_w : wp - pad_w]  # (B, h, w)

        # Point path: upscale to working size, re-normalize, [blur].
        dn_all = _normalize_each(resize_planes(depth, (h, w), "linear"), opts.invert_depth)
        if opts.smooth_depth:
            dn_all = gaussian_blur(dn_all, _smooth_ksize(opts.smooth_ksize))

        # Preview: normalized at model resolution (shared with the point
        # path when the sizes coincide), as gray u8; the host applies the
        # PLASMA table. Oversized previews colorize then area-resize here,
        # the reference's order.
        prev = None
        if preview:
            if (dmh, dmw) == (h, w) and not opts.smooth_depth:
                dn_prev = dn_all
            else:
                dn_prev = _normalize_each(depth, opts.invert_depth)
            prev = (dn_prev * 255.0).to(torch.uint8)
            if (pv_h, pv_w) != (dmh, dmw):
                lut = torch.from_numpy(PLASMA_RGB).to(prev.device)
                rgb = resize_batched(lut[prev.long()].float(), (pv_h, pv_w), "area")
                prev = rgb.round().clamp(0, 255).to(torch.uint8)

        packed = unproject(
            dn_all, img, depth_scale=depth_scales, step=step, h=h, w=w,
            fov_deg=opts.fov,
        )
        if opts.refine and opts.exact_outlier:
            keep = torch.stack([statistical_outlier_mask(pk[:3].T) for pk in packed])
            packed[:, 6] = keep.float()  # in place: packed is this call's own
        elif opts.refine:
            hh, ww = -(-h // step), -(-w // step)
            # A strided view of rows 0-2: the CUDA kernel reads the planar
            # buffer in place.
            grids = packed[:, :3].transpose(1, 2).reshape(-1, hh, ww, 3)
            means = grid_knn_mean_distances(grids)
            keep = outlier_keep_from_means(means, means > 0.0, 2.0)
            packed[:, 6] = keep.float()
        if not self.quantized_transfer:
            return packed, prev
        rgb_rides = (not jpeg and (h, w) != (h0, w0)) or (jpeg and not host_colors)
        return self._bundle(
            dn_all[:, ::step, ::step], packed[:, 6] > 0.5,
            img[:, ::step, ::step, :] if rgb_rides else None, ycc=jpeg,
        ), prev

    def _bundle(
        self,
        dn_s: torch.Tensor,
        keep: torch.Tensor,
        pix: torch.Tensor | None,
        *,
        ycc: bool,
    ) -> torch.Tensor:
        """The quantized device→host bundle, one u8 row per image:
        ``[depth section | keep bits | colours?]``. The points are a
        deterministic function of the strided normalized depth and the
        intrinsics, so only the quantized depth, the bit-packed keep mask
        and, where the host has no copy of the working image's colours,
        the strided colours cross: as exact u8 RGB when a pixel upload was
        downscaled on the device, as 4:2:0 YCbCr (``ycc``) on the JPEG
        ingest (the source stored chroma at half resolution to begin
        with). Host half: :meth:`collect`."""
        bq, hh, ww = dn_s.shape
        bits = self._depth_codec_bits(hh, ww)
        pack = {8: pack_depth8t, 12: pack_depth12, 16: pack_depth16}[bits]
        parts = [pack(dn_s), pack_keep_bits(keep)]
        if pix is not None and ycc:
            # BT.601 full-range forward, the exact inverse pair of the
            # host's per-point reconstruction; chroma takes the top-left
            # sample of each 2×2 strided cell.
            r_, g_, b_ = pix.unbind(-1)
            yy = 0.299 * r_ + 0.587 * g_ + 0.114 * b_
            cb = (b_ - yy) * (1.0 / 1.772) + 128.0
            cr = (r_ - yy) * (1.0 / 1.402) + 128.0
            for p in (yy, cb[:, ::2, ::2], cr[:, ::2, ::2]):
                parts.append(p.round().clamp(0, 255).to(torch.uint8).reshape(bq, -1))
        elif pix is not None:
            parts.append(pix.to(torch.uint8).reshape(bq, -1))
        return torch.cat(parts, dim=1)

    def _handle(self, out, prev, in_hw, options, depth_scales, imgs=None, host_rgb=None):
        h, w = _proc_hw(*in_hw)
        step = DENSITY_STRIDES[options.density]
        return _Handle(
            out, prev, self.quantized_transfer, (-(-h // step), -(-w // step)), (h, w),
            step, options.fov, depth_scales, imgs, host_rgb,
        )

    def submit_batch(
        self,
        images_rgb_u8: "np.ndarray | list[np.ndarray]",
        *,
        depth_scales: "np.ndarray | list[float] | float" = 10.0,
        options: PipelineOptions = PipelineOptions(),
        want_preview: bool = True,
    ) -> _Handle:
        """Enqueue one batch of same-size images; returns a handle for
        :meth:`collect`. On CUDA the work runs asynchronously."""
        imgs = np.stack(images_rgb_u8)
        b, h0, w0 = imgs.shape[:3]
        scales = np.broadcast_to(np.asarray(depth_scales, np.float32), (b,)).copy()
        out, prev = self._forward(
            torch.from_numpy(imgs).to(self.device).float(),
            torch.from_numpy(scales).to(self.device),
            (h0, w0),
            options,
            want_preview,
        )
        return self._handle(out, prev, (h0, w0), options, scales, imgs=imgs)

    @staticmethod
    def pack_jpeg_payload(jpegs: "list[JpegInput]", depth_scales: np.ndarray) -> np.ndarray:
        """Fuse entropy-decoded JPEGs + f32 scales into one (B, nbytes) u8
        host→device buffer: [per-component int16 coeffs | f32 qtables |
        f32 depth_scale] per row."""
        rows = []
        scales = np.ascontiguousarray(depth_scales, np.float32)
        for j, s in zip(jpegs, scales):
            parts = [np.ascontiguousarray(c, np.int16).view(np.uint8).ravel() for c in j.coeffs]
            parts.append(np.ascontiguousarray(j.qtables, np.float32).view(np.uint8).ravel())
            parts.append(s.reshape(1).view(np.uint8))
            rows.append(np.concatenate(parts))
        return np.stack(rows)

    @staticmethod
    def pack_jpeg_sparse_payload(
        jpegs: "list[JpegInput]", depth_scales: np.ndarray, cap: int, exc_cap: int
    ) -> np.ndarray:
        """Sparse variant of :meth:`pack_jpeg_payload`: one (B, nbytes) u8
        buffer of blocked split-sparse coefficients, laid out by
        ``ops.jpeg_sparse.sparse_row_sections`` (shared with the device
        reader). DC ships as planar lo/hi bytes; padding exception slots
        point at index ``cap`` (the device's sacrificial tail entry)."""
        sections, rowbytes = sparse_row_sections(jpegs[0].spec, cap, exc_cap)
        out = np.zeros((len(jpegs), rowbytes), np.uint8)
        scales = np.ascontiguousarray(depth_scales, np.float32)

        def put(row, name, data_u8):
            off, size = sections[name]
            # Bounds check before the write: an oversized field must not
            # corrupt the next section.
            if len(data_u8) > size:
                raise ValueError(
                    f"sparse payload field {name!r}: {len(data_u8)} bytes "
                    f"exceeds its {size}-byte section"
                )
            row[off : off + len(data_u8)] = data_u8

        for row, j, s in zip(out, jpegs, scales):
            counts, dc, pos, val, exc_idx, exc_val = j.sparse()
            if len(pos) > cap:
                raise ValueError(f"nnz {len(pos)} exceeds capacity bucket {cap}")
            if len(exc_idx) > exc_cap:
                raise ValueError(f"nexc {len(exc_idx)} exceeds exception bucket {exc_cap}")
            dcu = np.ascontiguousarray(dc, np.int16).view(np.uint16)
            put(row, "counts", np.ascontiguousarray(counts, np.uint8))
            put(row, "dc_lo", (dcu & 0xFF).astype(np.uint8))
            put(row, "dc_hi", (dcu >> 8).astype(np.uint8))
            put(row, "pos", pos)  # zero-padded to cap by the zeros row
            put(row, "val", val.view(np.uint8))
            pei = np.full(exc_cap, cap, np.int32)
            pei[: len(exc_idx)] = exc_idx
            put(row, "exc_idx", pei.view(np.uint8))
            put(row, "exc_val", np.ascontiguousarray(exc_val, np.int16).view(np.uint8))
            put(row, "qt", np.ascontiguousarray(j.qtables, np.float32).view(np.uint8).ravel())
            put(row, "scale", s.reshape(1).view(np.uint8))
        return out

    def submit_batch_jpeg(
        self,
        jpegs: "list[JpegInput]",
        *,
        depth_scales: "np.ndarray | list[float] | float" = 10.0,
        options: PipelineOptions = PipelineOptions(),
        want_preview: bool = True,
    ) -> _Handle:
        """Hybrid-ingest :meth:`submit_batch`: every item must share one
        JpegSpec (serving buckets by spec as pixel items bucket by shape).
        The payload is the sparse one whenever :func:`plan_sparse_batch`
        finds it smaller than the dense one, with capacities chosen for
        this batch alone: the JAX package ratchets them per spec only to
        bound its recompiles, and eager PyTorch compiles nothing."""
        b = len(jpegs)
        if b == 0:
            raise ValueError("empty batch")
        spec = jpegs[0].spec
        if any(j.spec != spec for j in jpegs):
            raise ValueError("submit_batch_jpeg requires one shared JpegSpec")
        scales = np.broadcast_to(np.asarray(depth_scales, np.float32), (b,)).copy()
        step = DENSITY_STRIDES[options.density]
        # Host colours: every item must reconstruct, or the whole batch
        # keeps the device ride-along (one bundle layout per batch).
        # grid_colors is cached; the server's planner precomputes it.
        host_rgb = None
        if self.quantized_transfer and self.host_colors_enabled:
            cols = [j.grid_colors(step) for j in jpegs]
            if all(c is not None for c in cols):
                host_rgb = np.stack(cols)
        caps = plan_sparse_batch(jpegs)
        if caps is not None:
            payload = self.pack_jpeg_sparse_payload(jpegs, scales, *caps)
        else:
            payload = self.pack_jpeg_payload(jpegs, scales)
        with torch.inference_mode():
            dev_payload = torch.from_numpy(payload).to(self.device)
            if caps is not None:
                img, dev_scales = _unpack_jpeg_sparse_batch(dev_payload, spec, *caps)
            else:
                img, dev_scales = _unpack_jpeg_batch(dev_payload, spec)
        in_hw = (spec.height, spec.width)
        out, prev = self._forward(
            img, dev_scales, in_hw, options, want_preview,
            jpeg=True, host_colors=host_rgb is not None,
        )
        return self._handle(out, prev, in_hw, options, scales, host_rgb=host_rgb)

    def collect(
        self,
        handle: _Handle,
        *,
        want_preview: bool = True,
        want_packed: bool = True,
        want_preview_rgb: bool = True,
    ) -> list[PipelineResult]:
        """Bring a submitted batch to the host and split it per image.
        ``want_preview_rgb=False`` skips the host PLASMA lookup for callers
        that render the gray preview themselves."""
        out = handle.out.cpu().numpy()  # the batch's one device→host copy
        prev_np = prev_gray = None
        if want_preview and handle.preview is not None:
            prev_np = handle.preview.cpu().numpy()
            if prev_np.ndim == 3:  # gray u8 → PLASMA on the host
                prev_gray = prev_np
                prev_np = PLASMA_RGB[prev_np] if want_preview_rgb else None
        if handle.quantized:
            clouds = self._unbundle(handle, out, want_packed)
        else:
            clouds = []
            for packed in out:
                keep = packed[6] > 0.5
                clouds.append((
                    np.ascontiguousarray(packed[:3].T[keep]),
                    np.ascontiguousarray(packed[3:6].T[keep]),
                    packed if want_packed else None,
                ))
        hh, ww = handle.grid_hw
        return [
            PipelineResult(
                points=points,
                colors=colors,
                depth_preview_rgb=prev_np[i] if prev_np is not None else None,
                depth_preview_gray=prev_gray[i] if prev_gray is not None else None,
                raw_point_count=hh * ww,
                kept_point_count=len(points),
                packed=packed,
                grid_hw=handle.grid_hw,
            )
            for i, (points, colors, packed) in enumerate(clouds)
        ]

    def _unbundle(
        self, handle: _Handle, bundle: np.ndarray, want_packed: bool
    ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray | None]]:
        """Host half of :meth:`_bundle`: unpack the depth and keep bits,
        take the colours from the bundle, the host's pixels or the
        host-reconstructed JPEG colours, and rebuild each image's (kept
        points, their colours, packed buffer or None); the native fused
        reconstruct when no packed buffer is wanted."""
        b = bundle.shape[0]
        hh, ww = handle.grid_hw
        n = hh * ww
        nb = -(-n // 8)
        bits = self._depth_codec_bits(hh, ww)
        if bits == 8:
            dsec, denom = depth8t_section_len(hh, ww), 4095.0
            d16 = unpack_depth8t(bundle[:, :dsec], hh, ww)
        elif bits == 12:
            dsec, denom = 3 * (-(-n // 2)), 4095.0
            d16 = unpack_depth12(bundle[:, :dsec], n).reshape(b, hh, ww)
        else:
            dsec, denom = n * 2, 65535.0
            d16 = np.ascontiguousarray(bundle[:, :dsec]).view(np.uint16).reshape(b, hh, ww)
        keep_all = np.unpackbits(
            np.ascontiguousarray(bundle[:, dsec : dsec + nb]), axis=-1, bitorder="little"
        )[:, :n].astype(bool)
        o = dsec + nb
        # JPEG handles (no host pixels) ride colours back as 4:2:0 YCbCr
        # [y (n) | cb | cr] unless the host rebuilt them; pixel handles
        # ride exact u8 RGB.
        ycc = bundle.shape[1] > o and handle.imgs is None
        ch, cw = -(-hh // 2), -(-ww // 2)
        nc = ch * cw
        step = handle.step
        if ycc:
            y_pl = bundle[:, o : o + n].reshape(b, hh, ww)
            cb_pl = bundle[:, o + n : o + n + nc].reshape(b, ch, cw)
            cr_pl = bundle[:, o + n + nc :].reshape(b, ch, cw)
        elif bundle.shape[1] > o:
            rgb_u8 = bundle[:, o:].reshape(b, hh, ww, 3)
        elif handle.host_rgb is not None:
            rgb_u8 = handle.host_rgb
        else:
            rgb_u8 = handle.imgs[:, ::step, ::step, :]
        h, w = handle.work_hw
        f = focal_length(h, w, handle.fov)
        cx, cy = w / 2.0, h / 2.0
        scales = handle.depth_scales

        from image_to_pointcloud_tpu_torch import native

        if not want_packed and native.available():
            clouds = []
            for i in range(b):
                kw = dict(step=step, depth_scale=float(scales[i]), f=f, cx=cx, cy=cy, denom=denom)
                keep = keep_all[i].reshape(hh, ww)
                if ycc:
                    pts, cols = native.reconstruct_points_ycc420(
                        d16[i], keep, y_pl[i], cb_pl[i], cr_pl[i], **kw
                    )
                else:
                    pts, cols = native.reconstruct_points(d16[i], keep, rgb_u8[i], **kw)
                clouds.append((pts, cols, None))
            return clouds

        if ycc:
            rgb = ycc420_to_rgb_f32(y_pl, cb_pl, cr_pl).reshape(b, n, 3)
        else:
            rgb = rgb_u8.reshape(b, n, 3).astype(np.float32)
        xyz = depth16_to_xyz(d16, scales, step=step, f=f, cx=cx, cy=cy, denom=denom)
        clouds = []
        for i in range(b):
            keep = keep_all[i]
            packed = None
            if want_packed:
                packed = np.concatenate(
                    [xyz[i], rgb[i].T, keep[None].astype(np.float32), np.zeros((1, n), np.float32)]
                )
            clouds.append((
                np.ascontiguousarray(xyz[i].T[keep]), np.ascontiguousarray(rgb[i][keep]), packed
            ))
        return clouds

    def run_batch(
        self,
        images_rgb_u8: "np.ndarray | list[np.ndarray]",
        *,
        depth_scales: "np.ndarray | list[float] | float" = 10.0,
        options: PipelineOptions = PipelineOptions(),
        want_preview: bool = True,
        want_packed: bool = True,
    ) -> list[PipelineResult]:
        """Run the pipeline on a batch of same-size RGB uint8 images."""
        handle = self.submit_batch(
            images_rgb_u8,
            depth_scales=depth_scales,
            options=options,
            want_preview=want_preview,
        )
        return self.collect(handle, want_preview=want_preview, want_packed=want_packed)

    def run(
        self,
        image_rgb_u8: np.ndarray,
        *,
        depth_scale: float = 10.0,
        options: PipelineOptions = PipelineOptions(),
        want_preview: bool = True,
    ) -> PipelineResult:
        """Run the pipeline on one decoded RGB uint8 image."""
        return self.run_batch(
            image_rgb_u8[None],
            depth_scales=depth_scale,
            options=options,
            want_preview=want_preview,
        )[0]

    def run_jpeg(
        self,
        jpeg: JpegInput,
        *,
        depth_scale: float = 10.0,
        options: PipelineOptions = PipelineOptions(),
        want_preview: bool = True,
        want_packed: bool = True,
    ) -> PipelineResult:
        """Run the pipeline on one entropy-decoded JPEG (hybrid
        device-decode ingest; see :func:`plan_jpeg_input`)."""
        handle = self.submit_batch_jpeg(
            [jpeg], depth_scales=depth_scale, options=options, want_preview=want_preview
        )
        return self.collect(handle, want_preview=want_preview, want_packed=want_packed)[0]


# ---------- dummy-model graphs (reference backend/app.py:567-607) ----------

_DUMMY_STRIDES = {"low": 8, "medium": 4, "high": 2}
_F32_5_OVER_255 = float(np.float32(5.0 / 255.0))
_F32_1_OVER_100 = float(np.float32(1.0 / 100.0))


def _gray(img: torch.Tensor) -> torch.Tensor:
    """cv2 BGR→GRAY of RGB f32 values, rounded half to even as cv2's
    uint8 conversion (and ``jnp.round``) round."""
    return torch.round(img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114)


@torch.inference_mode()
def dummy_point_cloud_graph(
    image_rgb_u8: np.ndarray, density: str, device: "str | torch.device" = "cpu"
) -> tuple[np.ndarray, np.ndarray]:
    """Intensity-as-depth fallback for the dummy models (reference
    backend/app.py:567-587): (N, 3) f32 points and (N, 3) f32 colours of
    the strided grid."""
    h, w = image_rgb_u8.shape[:2]
    step = _DUMMY_STRIDES[density]
    sub = torch.from_numpy(np.ascontiguousarray(image_rgb_u8[::step, ::step])).to(device).float()
    # z = (255 - gray) / 255 · 5, x = (u - w/2) / 100: XLA folds the JAX
    # graph's constant divisions into one multiply each, by f32(5/255) and
    # f32(1/100); the same multiplies give its bits.
    z = (255.0 - _gray(sub)) * _F32_5_OVER_255
    u = torch.arange(z.shape[1], dtype=torch.float32, device=z.device) * step
    v = torch.arange(z.shape[0], dtype=torch.float32, device=z.device) * step
    x = ((u - w / 2.0) * _F32_1_OVER_100).expand_as(z)
    y = ((v - h / 2.0) * _F32_1_OVER_100)[:, None].expand_as(z)
    pts = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=1)
    return pts.cpu().numpy(), sub.reshape(-1, 3).cpu().numpy()


@torch.inference_mode()
def demo_depth_map_graph(
    image_rgb_u8: np.ndarray, device: "str | torch.device" = "cpu"
) -> np.ndarray:
    """Fake depth-map preview for the dummy models (reference
    backend/app.py:589-607): gray → 15×15 Gaussian blur → inverted →
    PLASMA, as (H, W, 3) u8."""
    gray = _gray(torch.from_numpy(np.array(image_rgb_u8)).to(device).float())
    inv = (255.0 - torch.round(gaussian_blur(gray, 15))).to(torch.uint8)
    return PLASMA_RGB[inv.cpu().numpy()]
