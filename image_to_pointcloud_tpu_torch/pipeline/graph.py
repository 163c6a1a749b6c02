"""The batched image→point-cloud pipeline over one depth model.

Counterpart of ``image_to_pointcloud_tpu/pipeline/graph.py``'s
``DepthPipeline`` with pixel ingest and the unquantized (f32 packed
buffer) return. One batch runs, on the model's device:

  uint8 RGB → [area-downscale] → bicubic resize + normalize →
  DINOv2-DPT forward → linear depth upscale → robust normalize →
  [gaussian blur] → gray preview → pinhole unprojection → packed
  (B, 8, N) point buffer → windowed grid-kNN outlier mask (row 6)

The JAX package compiles one graph per shape signature; PyTorch runs
eagerly, so there is no compile cache. :meth:`DepthPipeline.submit_batch`
enqueues the work (asynchronous on CUDA) and :meth:`DepthPipeline.collect`
brings the packed buffer to the host and splits it per image.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.models.depth_anything import DepthAnything
from image_to_pointcloud_tpu_torch.ops.colormap import PLASMA_RGB
from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth
from image_to_pointcloud_tpu_torch.ops.gaussian import gaussian_blur
from image_to_pointcloud_tpu_torch.ops.outlier import (
    grid_knn_mean_distances,
    outlier_keep_from_means,
)
from image_to_pointcloud_tpu_torch.ops.resize import resize_batched, resize_planes
from image_to_pointcloud_tpu_torch.ops.unproject import DENSITY_STRIDES, unproject
from image_to_pointcloud_tpu_torch.pipeline.preprocess import (
    model_preprocess_spec,
    preprocess_for_model,
    processor_output_size,
)

__all__ = ["DepthPipeline", "PipelineOptions", "PipelineResult"]

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
    packed: torch.Tensor  # (B, 8, N) on the model's device
    preview: torch.Tensor | None  # (B, ph, pw) gray or (B, ph, pw, 3) RGB u8
    grid_hw: tuple[int, int]


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


class DepthPipeline:
    """The depth→point-cloud pipeline over one model on one device (the
    model's own device and dtype: bf16 on CUDA for serving, f32 on CPU)."""

    def __init__(self, model: DepthAnything, *, model_target: int | None = None):
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

    @torch.inference_mode()
    def _forward(
        self,
        images_u8: torch.Tensor,
        depth_scales: torch.Tensor,
        options: PipelineOptions = PipelineOptions(),
        preview: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(B, h0, w0, 3) uint8 images + (B,) f32 scales, on the model's
        device → ((B, 8, N) packed points, preview or None)."""
        opts = options
        h0, w0 = images_u8.shape[1:3]
        h, w = _proc_hw(h0, w0)
        mh, mw = processor_output_size(
            h, w, self.model_target, multiple=self.size_multiple,
            keep_aspect_ratio=self.keep_aspect,
        )
        step = DENSITY_STRIDES[opts.density]
        pv_h, pv_w = _preview_hw(mh, mw)

        img = images_u8.float()
        if (h, w) != (h0, w0):
            # cv2 resizes the uint8 image (rounding); match it.
            img = resize_batched(img, (h, w), "area").round().clamp(0, 255)
        x = preprocess_for_model(
            img, (mh, mw), mean=self.pixel_mean, std=self.pixel_std,
            method=self.resize_method,
        )
        depth = self.model(x)  # (B, mh, mw) f32

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
            if (mh, mw) == (h, w) and not opts.smooth_depth:
                dn_prev = dn_all
            else:
                dn_prev = _normalize_each(depth, opts.invert_depth)
            prev = (dn_prev * 255.0).to(torch.uint8)
            if (pv_h, pv_w) != (mh, mw):
                lut = torch.from_numpy(PLASMA_RGB).to(prev.device)
                rgb = resize_batched(lut[prev.long()].float(), (pv_h, pv_w), "area")
                prev = rgb.round().clamp(0, 255).to(torch.uint8)

        packed = unproject(
            dn_all, img, depth_scale=depth_scales, step=step, h=h, w=w,
            fov_deg=opts.fov,
        )
        if opts.refine:
            hh, ww = -(-h // step), -(-w // step)
            # A strided view of rows 0-2: the CUDA kernel reads the planar
            # buffer in place.
            grids = packed[:, :3].transpose(1, 2).reshape(-1, hh, ww, 3)
            means = grid_knn_mean_distances(grids)
            keep = outlier_keep_from_means(means, means > 0.0, 2.0)
            packed[:, 6] = keep.float()  # in place: packed is this call's own
        return packed, prev

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
        scales = np.broadcast_to(np.asarray(depth_scales, np.float32), (b,))
        packed, prev = self._forward(
            torch.from_numpy(imgs).to(self.device),
            torch.from_numpy(scales.copy()).to(self.device),
            options,
            want_preview,
        )
        h, w = _proc_hw(h0, w0)
        step = DENSITY_STRIDES[options.density]
        return _Handle(packed, prev, (-(-h // step), -(-w // step)))

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
        packed_all = handle.packed.cpu().numpy()
        prev_np = prev_gray = None
        if want_preview and handle.preview is not None:
            prev_np = handle.preview.cpu().numpy()
            if prev_np.ndim == 3:  # gray u8 → PLASMA on the host
                prev_gray = prev_np
                prev_np = PLASMA_RGB[prev_np] if want_preview_rgb else None
        results = []
        for i in range(packed_all.shape[0]):
            keep = packed_all[i, 6] > 0.5
            results.append(
                PipelineResult(
                    points=np.ascontiguousarray(packed_all[i, :3].T[keep]),
                    colors=np.ascontiguousarray(packed_all[i, 3:6].T[keep]),
                    depth_preview_rgb=prev_np[i] if prev_np is not None else None,
                    depth_preview_gray=(
                        prev_gray[i] if prev_gray is not None else None
                    ),
                    raw_point_count=packed_all.shape[2],
                    kept_point_count=int(keep.sum()),
                    packed=packed_all[i] if want_packed else None,
                    grid_hw=handle.grid_hw,
                )
            )
        return results

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
