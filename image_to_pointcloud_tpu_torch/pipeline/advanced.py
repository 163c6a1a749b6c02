"""Advanced pipelines: metric depth with real intrinsics, tiled high
resolution, and video clips.

Counterpart of ``image_to_pointcloud_tpu/pipeline/advanced.py``. Each
pipeline takes the port's model (an ``nn.Module`` on its device and
dtype, as :class:`~.graph.DepthPipeline` does) in place of the JAX
package's ``(cfg, params)``, and keeps both of the JAX pipeline's
device→host contracts: the quantized transfer (the default on any device
but the CPU, :func:`~.graph.default_quantized_transfer`), where only a
packed depth crosses and the host rebuilds the points, and the f32 one.
The packed depth is 12-bit; ``IPC_TPU_DEPTH16=1`` selects u16.

* :class:`MetricPipeline`: a metric-head model (ZoeDepth, or the
  DA-metric sigmoid head) + a camera → metric-scale cloud; the predicted
  depth is z (no normalization). Quantized: the depth over its per-image
  max, the keep bits, and that max as f32.
* :class:`HighResPipeline`: overlapping model-native tiles as one batch,
  affine-aligned to a low-resolution anchor pass and feather-blended,
  then a voxel downsample to a point budget. Quantized, with the native
  library: only the packed blended depth grid crosses, the host
  reconstructs and voxel-averages; otherwise the device unprojects (K3)
  and voxel-downsamples, and a bbox-normalized u16 XYZ + u8 RGB payload
  crosses.
* :class:`VideoPipeline`: a clip as one batch; quantized, the packed
  strided depth crosses and the host reconstructs; with ``fuse_voxel``
  the device unprojects every frame (K3, once for the clip) and
  voxel-fuses the clip.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_to_pointcloud_tpu_torch.models.zoedepth import ZoeDepthConfig
from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth
from image_to_pointcloud_tpu_torch.ops.resize import resize_planes
from image_to_pointcloud_tpu_torch.ops.unproject import (
    focal_length,
    unproject,
    unproject_intrinsics,
)
from image_to_pointcloud_tpu_torch.ops.voxel import voxel_downsample
from image_to_pointcloud_tpu_torch.parallel.tiling import blend_tiles, extract_tiles, plan_tiles
from image_to_pointcloud_tpu_torch.pipeline.graph import default_quantized_transfer
from image_to_pointcloud_tpu_torch.pipeline.preprocess import (
    model_preprocess_spec,
    preprocess_for_model,
    processor_output_size,
    reflect_pad_margins,
)
from image_to_pointcloud_tpu_torch.pipeline.transfer import (
    depth16_to_xyz,
    pack_depth12,
    pack_depth16,
    pack_keep_bits,
    unpack_depth12,
)

__all__ = ["CameraIntrinsics", "HighResPipeline", "MetricPipeline", "VideoPipeline"]


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_fov(cls, h: int, w: int, fov_deg: float) -> "CameraIntrinsics":
        f = (w / 2.0) / math.tan(math.radians(fov_deg) / 2.0)
        return cls(fx=f, fy=f, cx=w / 2.0, cy=h / 2.0)


def _is_metric(cfg) -> bool:
    """Whether the config's model predicts metric depth (ZoeDepth, or a
    DA config with the metric head)."""
    return isinstance(cfg, ZoeDepthConfig) or bool(getattr(getattr(cfg, "neck", None),
                                                           "metric_depth", False))


def _depth_bits() -> int:
    """12-bit packed depth, or u16 with ``IPC_TPU_DEPTH16=1``."""
    return 16 if os.environ.get("IPC_TPU_DEPTH16") == "1" else 12


def _pack_depth(dn_s: torch.Tensor, bits: int) -> torch.Tensor:
    return pack_depth12(dn_s) if bits == 12 else pack_depth16(dn_s)


def _unpack_depth(sec: np.ndarray, n: int, bits: int) -> tuple[np.ndarray, float]:
    """(B, L) packed sections → ((B, n) u16 codes, their denominator)."""
    if bits == 12:
        return unpack_depth12(sec, n), 4095.0
    return np.ascontiguousarray(sec).view(np.uint16).reshape(sec.shape[0], n), 65535.0


class _ModelPipeline:
    """The model, its device and the family's preprocessing spec."""

    def __init__(self, model: nn.Module, model_target, quantized_transfer: bool | None):
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
        self.depth_bits = _depth_bits()

    def _size(self, h: int, w: int) -> tuple[int, int]:
        return processor_output_size(h, w, self.model_target, multiple=self.size_multiple,
                                     keep_aspect_ratio=self.keep_aspect)

    def _predict(self, img: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        """(B, H, W, 3) f32 pixels → (B, mh, mw) f32 model output at the
        model resolution for an (H, W) input."""
        x = preprocess_for_model(img, self._size(*hw), mean=self.pixel_mean,
                                 std=self.pixel_std, method=self.resize_method)
        return self.model(x)

    def _to_device(self, imgs_u8: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(imgs_u8, requirements=["C", "W"])).to(self.device).float()


class MetricPipeline(_ModelPipeline):
    """Metric depth + real intrinsics → metric-scale point cloud.

    Quantized: per image ``[packed depth / its max | keep bits | max as
    f32]`` in one u8 row; the host rebuilds ``x = (u - cx)·z / fx`` with z
    error ≤ max/4095 (12-bit) or max/65535 (u16) and takes the colours
    from its own copy of the image."""

    def __init__(
        self,
        model: nn.Module,
        model_target: int | tuple[int, int] | None = None,
        *,
        quantized_transfer: bool | None = None,
    ):
        if not _is_metric(model.cfg):
            raise ValueError("MetricPipeline needs a metric-head model (zoedepth*, "
                             "depth-anything-v2-metric-*)")
        super().__init__(model, model_target, quantized_transfer)

    @torch.inference_mode()
    def _forward(self, imgs_u8: np.ndarray, fx, fy, cx, cy, step: int) -> torch.Tensor:
        b, h, w = imgs_u8.shape[:3]
        img = self._to_device(imgs_u8)
        pad_h, pad_w = reflect_pad_margins(self.cfg, h, w)
        hp, wp = h + 2 * pad_h, w + 2 * pad_w
        img_in = img
        if pad_h or pad_w:
            # ZoeDepth's reflect pad, and the crop of its prediction.
            img_in = F.pad(img.permute(0, 3, 1, 2), (pad_w, pad_w, pad_h, pad_h),
                           mode="reflect").permute(0, 2, 3, 1)
        depth = self._predict(img_in, (hp, wp))
        if pad_h or pad_w:
            d = resize_planes(depth, (hp, wp), "bicubic_torch")[:, pad_h : hp - pad_h, pad_w : wp - pad_w]
        else:
            d = resize_planes(depth, (h, w), "linear")
        cam = [torch.from_numpy(v).to(self.device) for v in (fx, fy, cx, cy)]
        if not self.quantized_transfer:
            return unproject_intrinsics(d, img, fx=cam[0], fy=cam[1], cx=cam[2], cy=cam[3], step=step)
        ds = d[:, ::step, ::step]
        keep = (ds > 0.0).reshape(b, -1)
        maxd = ds.reshape(b, -1).amax(dim=1).clamp_min(1e-12)
        dn = (ds / maxd[:, None, None]).clamp(0.0, 1.0)
        return torch.cat([_pack_depth(dn, self.depth_bits), pack_keep_bits(keep),
                          maxd[:, None].contiguous().view(torch.uint8)], dim=1)

    def run_batch(
        self,
        images_rgb_u8: "np.ndarray | list[np.ndarray]",
        intrinsics: "CameraIntrinsics | list[CameraIntrinsics]",
        *,
        step: int = 1,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """B same-size images with per-image intrinsics, one forward →
        [(points (M, 3) metric, colors (M, 3)), ...]."""
        imgs = np.stack(images_rgb_u8)
        b, h, w = imgs.shape[:3]
        if isinstance(intrinsics, CameraIntrinsics):
            intrinsics = [intrinsics] * b
        fx, fy, cx, cy = (np.asarray([getattr(i, a) for i in intrinsics], np.float32)
                          for a in ("fx", "fy", "cx", "cy"))
        out = self._forward(imgs, fx, fy, cx, cy, step).cpu().numpy()
        results: list[tuple[np.ndarray, np.ndarray]] = []
        if not self.quantized_transfer:
            for packed in out:
                keep = packed[6] > 0.5
                results.append((packed[:3].T[keep], packed[3:6].T[keep]))
            return results
        hh, ww = -(-h // step), -(-w // step)
        n = hh * ww
        nb = -(-n // 8)
        dsec = 3 * (-(-n // 2)) if self.depth_bits == 12 else 2 * n
        dq, denom = _unpack_depth(out[:, :dsec], n, self.depth_bits)
        keep_all = np.unpackbits(np.ascontiguousarray(out[:, dsec : dsec + nb]), axis=-1,
                                 bitorder="little")[:, :n].astype(bool)
        maxd = np.ascontiguousarray(out[:, dsec + nb : dsec + nb + 4]).view(np.float32).reshape(b)
        for i in range(b):
            keep = keep_all[i]
            z = dq[i].astype(np.float32).reshape(hh, ww) * np.float32(float(maxd[i]) / denom)
            u = (np.arange(ww, dtype=np.float32) * step - np.float32(cx[i]))[None, :]
            v = (np.arange(hh, dtype=np.float32) * step - np.float32(cy[i]))[:, None]
            x = (u * z / np.float32(fx[i])).reshape(n)
            y = (v * z / np.float32(fy[i])).reshape(n)
            pts = np.stack([x[keep], y[keep], z.reshape(n)[keep]], axis=1)
            cols = imgs[i, ::step, ::step, :].reshape(n, 3)[keep].astype(np.float32)
            results.append((pts, cols))
        return results

    def run(
        self,
        image_rgb_u8: np.ndarray,
        intrinsics: CameraIntrinsics,
        *,
        step: int = 1,
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (points (M, 3) metric, colors (M, 3))."""
        return self.run_batch(image_rgb_u8[None], [intrinsics], step=step)[0]


class HighResPipeline(_ModelPipeline):
    """Tiled high-resolution depth → blended cloud → voxel budget.

    Quantized with the native library: only the packed blended depth
    grid crosses (1.5 B a point at 12 bits); the host rebuilds the points
    (z error ≤ depth_scale/4095), takes the colours from its own image,
    and voxel-averages in C++ (``native``, the same grid rule and order as
    :func:`~..ops.voxel.voxel_downsample`). Otherwise the device
    unprojects and voxel-downsamples, and the quantized transfer carries
    bbox-normalized u16 XYZ + u8 RGB (9 B a point; position error ≤
    extent/2¹⁶)."""

    def __init__(
        self,
        model: nn.Module,
        *,
        tile: int = 518,
        overlap: int = 128,
        model_target: int | tuple[int, int] | None = None,
        quantized_transfer: bool | None = None,
    ):
        super().__init__(model, model_target, quantized_transfer)
        self.tile = tile
        self.overlap = overlap

    @torch.inference_mode()
    def _forward(self, image_rgb_u8: np.ndarray, depth_scale: float, step: int, grid: bool):
        """→ the packed depth section (1, L) u8 when ``grid``, else the
        (8, N) packed cloud and its (2, 3) bbox."""
        h, w = image_rgb_u8.shape[:2]
        # Clamped to the image: a 640×480 photo tiles at 480, and the
        # overlap stays below the tile.
        tile = min(self.tile, h, w)
        overlap = max(0, min(self.overlap, tile - 1))
        corners = plan_tiles(h, w, tile, overlap)
        img = self._to_device(image_rgb_u8)
        # The global anchor pass at the model resolution, upsampled.
        anchor = resize_planes(self._predict(img[None], (h, w)), (h, w), "linear")[0]
        # Every tile in one batch.
        tiles = extract_tiles(img, corners, tile)
        td = resize_planes(self._predict(tiles, (tile, tile)), (tile, tile), "linear")
        dn = normalize_depth(blend_tiles(td, corners, (h, w), anchor=anchor), True)
        if grid:
            return _pack_depth(dn[None, ::step, ::step], self.depth_bits)
        packed = unproject(dn[None], img[None], depth_scale=depth_scale, step=step, h=h, w=w)[0]
        # The cloud's bbox: the host sizes the voxel from 24 bytes.
        return packed, torch.stack([packed[:3].amin(dim=1), packed[:3].amax(dim=1)])

    @staticmethod
    def _quantize_voxels(vp, vc, lo, hi) -> torch.Tensor:
        """(N, 3) f32 points + colours → (N, 9) u8 [u16 xyz LE | u8 rgb]."""
        scale = torch.where(hi > lo, hi - lo, 1.0)
        q = ((vp - lo) / scale).clamp(0.0, 1.0)
        xyz16 = torch.round(q * 65535.0).to(torch.int32)
        xyz8 = torch.stack([xyz16 & 0xFF, xyz16 >> 8], dim=-1).to(torch.uint8).reshape(-1, 6)
        rgb8 = torch.round(vc).clamp(0, 255).to(torch.uint8)
        return torch.cat([xyz8, rgb8], dim=1)

    def run(
        self,
        image_rgb_u8: np.ndarray,
        *,
        depth_scale: float = 10.0,
        step: int = 1,
        voxel_budget: int | None = 1_000_000,
    ) -> tuple[np.ndarray, np.ndarray]:
        if self.quantized_transfer:
            from image_to_pointcloud_tpu_torch import native

            if native.available():
                out = self._run_depth_grid(image_rgb_u8, depth_scale=depth_scale, step=step,
                                           voxel_budget=voxel_budget)
                if out is not None:
                    return out
        packed, bbox = self._forward(image_rgb_u8, depth_scale, step, grid=False)
        pts, cols = packed[:3].T, packed[3:6].T
        if voxel_budget is None or pts.shape[0] <= voxel_budget:
            return pts.cpu().numpy(), cols.cpu().numpy()
        # The voxel that meets the budget, from the bbox volume; one
        # downsample on the device.
        lo, hi = bbox.cpu().numpy()
        vol = float(np.prod(np.maximum(hi - lo, 1e-6)))
        voxel = (vol / voxel_budget) ** (1.0 / 3.0)
        with torch.inference_mode():
            vp, vc, _, cnt = voxel_downsample(pts, cols, voxel)
            cnt = int(cnt)
            if not self.quantized_transfer:
                return vp[:cnt].cpu().numpy(), vc[:cnt].cpu().numpy()
            # Sliced on the device, before the copy.
            buf = self._quantize_voxels(vp, vc, bbox[0], bbox[1])[:cnt].cpu().numpy()
        xyz16 = np.ascontiguousarray(buf[:, :6]).view(np.uint16).astype(np.float32)
        scale = np.where(hi > lo, hi - lo, 1.0).astype(np.float32)
        points = xyz16 / np.float32(65535.0) * scale + lo.astype(np.float32)
        return points, buf[:, 6:9].astype(np.float32)

    def _run_depth_grid(
        self,
        image_rgb_u8: np.ndarray,
        *,
        depth_scale: float,
        step: int,
        voxel_budget: int | None,
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """The depth-grid transfer with the native host half; None → the
        caller takes the device-voxel path."""
        from image_to_pointcloud_tpu_torch import native

        h, w = image_rgb_u8.shape[:2]
        sec = self._forward(image_rgb_u8, depth_scale, step, grid=True).cpu().numpy()
        hh, ww = -(-h // step), -(-w // step)
        d16, denom = _unpack_depth(sec, hh * ww, self.depth_bits)
        rec = native.reconstruct_points(
            d16.reshape(hh, ww), np.ones((hh, ww), bool), image_rgb_u8[::step, ::step, :],
            step=step, depth_scale=float(depth_scale), f=float(focal_length(h, w, None)),
            cx=float(w / 2.0), cy=float(h / 2.0), denom=denom,
        )
        if rec is None:
            return None
        pts, cols = rec
        if voxel_budget is None or len(pts) <= voxel_budget:
            return pts, cols
        extent = np.maximum(pts.max(axis=0) - pts.min(axis=0), 1e-6)
        voxel = (float(np.prod(extent)) / voxel_budget) ** (1.0 / 3.0)
        return native.voxel_downsample(pts, cols, voxel)  # None → the caller's fallback


class VideoPipeline(_ModelPipeline):
    """A clip of frames as one batch → one fused multi-frame cloud.

    Quantized and unfused: only the packed strided depth crosses (1.5 B a
    point at 12 bits, 2 B as u16), and the host rebuilds the points (the
    native reconstruct, else ``depth16_to_xyz``) with the colours of its
    own frames. With ``fuse_voxel`` the device unprojects and voxel-fuses
    the clip."""

    def __init__(
        self,
        model: nn.Module,
        model_target: int | tuple[int, int] | None = None,
        *,
        quantized_transfer: bool | None = None,
    ):
        super().__init__(model, model_target, quantized_transfer)

    @torch.inference_mode()
    def _forward(self, frames_u8: np.ndarray, depth_scale: float, step: int, quant: bool):
        t, h, w = frames_u8.shape[:3]
        img = self._to_device(frames_u8)
        d = resize_planes(self._predict(img, (h, w)), (h, w), "linear")
        dn = torch.stack([normalize_depth(dd, True) for dd in d])
        if quant:
            return _pack_depth(dn[:, ::step, ::step], self.depth_bits)  # (T, L) u8
        return unproject(dn, img, depth_scale=depth_scale, step=step, h=h, w=w)  # (T, 8, N)

    def run(
        self,
        frames_rgb_u8: np.ndarray,
        *,
        depth_scale: float = 10.0,
        step: int = 2,
        fuse_voxel: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(T, H, W, 3) clip → fused (points, colors)."""
        t, h, w = frames_rgb_u8.shape[:3]
        if fuse_voxel is None and self.quantized_transfer:
            out = self._forward(frames_rgb_u8, depth_scale, step, quant=True).cpu().numpy()
            hh, ww = -(-h // step), -(-w // step)
            n = hh * ww
            d16, denom = _unpack_depth(out, n, self.depth_bits)
            d16 = d16.reshape(-1, hh, ww)
            # One intrinsics rule with the device unproject.
            f = float(np.float32(focal_length(h, w, None)))
            cx, cy = float(np.float32(w / 2.0)), float(np.float32(h / 2.0))
            from image_to_pointcloud_tpu_torch import native

            if native.available():
                keep = np.ones((hh, ww), bool)
                rgbs = frames_rgb_u8[:, ::step, ::step, :]
                parts = [
                    native.reconstruct_points(d16[i], keep, rgbs[i], step=step,
                                              depth_scale=float(depth_scale), f=f, cx=cx, cy=cy,
                                              denom=denom)
                    for i in range(t)
                ]
                return np.concatenate([p for p, _ in parts]), np.concatenate([c for _, c in parts])
            xyz = depth16_to_xyz(d16, np.full((t,), depth_scale, np.float32), step=step, f=f,
                                 cx=cx, cy=cy, denom=denom)
            pts = xyz.transpose(0, 2, 1).reshape(t * n, 3)
            cols = frames_rgb_u8[:, ::step, ::step, :].reshape(t * n, 3).astype(np.float32)
            return pts, cols
        packed = self._forward(frames_rgb_u8, depth_scale, step, quant=False)
        tt, _, n = packed.shape
        pts = packed[:, :3, :].transpose(1, 2).reshape(tt * n, 3)
        cols = packed[:, 3:6, :].transpose(1, 2).reshape(tt * n, 3)
        if fuse_voxel is not None:
            with torch.inference_mode():
                vp, vc, _, cnt = voxel_downsample(pts, cols, fuse_voxel)
                cnt = int(cnt)
                return vp[:cnt].cpu().numpy(), vc[:cnt].cpu().numpy()
        return pts.cpu().numpy(), cols.cpu().numpy()
