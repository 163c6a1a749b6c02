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

As the JAX package compiles one XLA program per signature (batch, input
size or ``JpegSpec``, options, preview, sparse capacities, bundle layout),
the port captures one CUDA graph per signature
(:meth:`DepthPipeline.compiled_graph`, :meth:`DepthPipeline.compiled_graph_jpeg`)
and replays it as one launch: the payload (:meth:`DepthPipeline.pack_payload`,
or the JPEG packers) is the graph's one input, unpacked on the device by
the graph's first operations. The first call of a signature captures it
(one eager pass, then the capture: see :class:`_CompiledGraph`); the
server's warmup captures every batch bucket of its warmup sizes ahead of
traffic. On a mesh whose data slots are each one device, each data slot's
share of a signature is a graph of its own, on that slot's device; on the
CPU and on other meshes the same callable runs eagerly. The
advanced pipelines (``pipeline/advanced.py``) and the v2 matte
(``serve/matting.py``) keep their signatures the same way: each is a
:class:`_GraphOwner`, as :class:`DepthPipeline` is.
:meth:`DepthPipeline.submit_batch` enqueues the work (asynchronous on
CUDA) and :meth:`DepthPipeline.collect` brings the result to the host and
splits it per image.

The dummy models' graphs (:func:`dummy_point_cloud_graph`,
:func:`demo_depth_map_graph`) are plain torch ops on the service's device.

f32 on CUDA means f32: torch runs f32 convolutions through cuDNN in TF32
by default (``torch.backends.cudnn.allow_tf32``), and a caller may have
turned TF32 on for matmuls. A pipeline over an f32 model on CUDA runs each
forward inside :func:`exact_f32`, which turns both flags off and restores
them afterwards; a bf16 model's forward is left as it is. So do the
advanced pipelines (``pipeline/advanced.py``), the v2 matte
(``serve/matting.py``) and the trainer, forward and backward
(``train/trainer.py``): every f32 forward on CUDA, as
:func:`wants_exact_f32` decides. The flags are
process-wide, not per thread: :func:`exact_f32` counts the forwards inside
it under a lock, so the first to enter saves the flags and the last to
leave restores them, and concurrent f32 forwards (the server's executor
threads) never see them restored early. While any f32 forward runs, other
threads' f32 work runs without TF32 too; bf16 work is unaffected. The
flags are read when an operation is enqueued, so the scope covers the
host's enqueue of the forward, which is all that decides the kernels: a
CUDA graph is captured inside it, and its replays need no flags.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import logging
import os
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_to_pointcloud_tpu_torch import cuda
from image_to_pointcloud_tpu_torch.ops.colormap import PLASMA_RGB, apply_colormap
from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth_planes
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
    grid_statistical_outlier_mask,
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
from image_to_pointcloud_tpu_torch.utils import spans

__all__ = [
    "DepthPipeline",
    "JpegInput",
    "PipelineOptions",
    "PipelineResult",
    "default_quantized_transfer",
    "demo_depth_map_graph",
    "depth_to_packed_points",
    "dummy_point_cloud_graph",
    "exact_f32",
    "plan_jpeg_input",
    "plan_sparse_batch",
    "wants_exact_f32",
]

logger = logging.getLogger(__name__)

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
    """A submitted batch. ``out`` and ``preview`` are host tensors: on a
    card, pinned ones that the batch's device→host copy fills, enqueued
    straight behind the batch's own replay (under the replay lock, so no
    later replay of another batch or drain lands between them), and
    ``copied`` is the event recorded after that copy; :meth:`DepthPipeline.
    collect` waits on it. Enqueued at submit, the copy runs as soon as the
    batch's forward ends, not behind the forward of the batch submitted
    next. On the CPU the outputs are the host tensors and ``copied`` is
    None."""

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
    # Seconds of the batch's pipeline stages ("pipeline.pack", "pipeline.replay";
    # collect adds "pipeline.d2h_wait" and "pipeline.unbundle").
    stages: dict
    copied: "torch.cuda.Event | None" = None


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


def _view(payload: torch.Tensor, off: int, size: int, dtype: torch.dtype) -> torch.Tensor:
    """Bytes [off, off+size) of every payload row, reinterpreted as
    ``dtype`` (little-endian, as the host packed them); copied first when
    the bytes are not contiguous or not aligned to ``dtype``."""
    x = payload[:, off : off + size]
    if not x.is_contiguous() or x.storage_offset() % dtype.itemsize:
        x = x.clone(memory_format=torch.contiguous_format)
    return x.view(dtype)


def _unpack_pixel_batch(
    payload_u8: torch.Tensor, in_hw: tuple[int, int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel payload rows (:meth:`DepthPipeline.pack_payload`: [H·W·3 u8
    RGB | f32 depth scale]) → ((B, H, W, 3) f32 pixels, (B,) f32 scales)."""
    h0, w0 = in_hw
    n = h0 * w0 * 3
    return (payload_u8[:, :n].reshape(-1, h0, w0, 3).float(),
            _view(payload_u8, n, 4, torch.float32).reshape(-1))


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


def _points_depth(depth: torch.Tensor, h: int, w: int, opts: PipelineOptions) -> torch.Tensor:
    """(B, mh, mw) model depth → the (B, h, w) normalized, optionally
    blurred depth the points are made of."""
    dn = normalize_depth_planes(resize_planes(depth, (h, w), "linear"), opts.invert_depth)
    if opts.smooth_depth:
        dn = gaussian_blur(dn, _smooth_ksize(opts.smooth_ksize))
    return dn


def _packed_points(
    dn: torch.Tensor,
    img: torch.Tensor,
    depth_scale: "torch.Tensor | float",
    *,
    opts: PipelineOptions,
    h: int,
    w: int,
    step: int,
) -> torch.Tensor:
    """(B, h, w) normalized depth + (B, h, w, 3) RGB → (B, 8, N) packed
    points (K3 on CUDA), row 6 the outlier keep mask when ``opts.refine``:
    the exact kNN, or the windowed grid search (K2 on CUDA, reading rows
    0-2 of the planar buffer in place)."""
    packed = unproject(
        dn, img, depth_scale=depth_scale, step=step, h=h, w=w, fov_deg=opts.fov,
    )
    if opts.refine and opts.exact_outlier:
        keep = torch.stack([statistical_outlier_mask(pk[:3].T) for pk in packed])
        packed[:, 6] = keep.float()  # in place: packed is this call's own
    elif opts.refine:
        hh, ww = -(-h // step), -(-w // step)
        grids = packed[:, :3].transpose(1, 2).reshape(-1, hh, ww, 3)
        packed[:, 6] = grid_statistical_outlier_mask(grids).float()
    return packed


def depth_to_packed_points(
    depth: torch.Tensor,
    image_rgb: torch.Tensor,
    depth_scale: "torch.Tensor | float",
    *,
    opts: PipelineOptions,
    h: int,
    w: int,
    step: int,
) -> torch.Tensor:
    """Model-resolution (mh, mw) depth + working-size (h, w, 3) RGB →
    packed (8, N) points: the single-image graph of the reference's resize
    → normalize → blur → per-pixel loop → outlier removal chain
    (backend/app.py:174-269), on the tensors' device; the batched
    pipeline runs the same two steps. On CUDA it launches K3 once, and K2
    once unless ``opts.exact_outlier``."""
    dn = _points_depth(depth[None], h, w, opts)
    return _packed_points(
        dn, image_rgb[None], depth_scale, opts=opts, h=h, w=w, step=step
    )[0]


_TF32_LOCK = threading.Lock()
_tf32_users = 0
_tf32_saved: tuple[bool, bool] = (False, False)


def wants_exact_f32(device: "str | torch.device", dtype: torch.dtype) -> bool:
    """Whether a forward in ``dtype`` on ``device`` runs inside
    :func:`exact_f32`: f32 on CUDA (the module docstring)."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


@contextlib.contextmanager
def exact_f32(on: bool = True):
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the scope
    (when ``on``), restored when the last concurrent scope leaves."""
    global _tf32_users, _tf32_saved
    if not on:
        yield
        return
    with _TF32_LOCK:
        if _tf32_users == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_users -= 1
            if _tf32_users == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _tf32_saved


# One capture at a time in the process (torch's rule for CUDA graphs), each
# on its device's one capture stream, where its warm-up pass ran too: the
# stream's cuBLAS workspace is made once, outside any capture.
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: dict = {}


def _clone(out):
    """Fresh copies of a callable's outputs (a tensor, None, or a tuple or
    a dict of them)."""
    if isinstance(out, tuple):
        return tuple(_clone(t) for t in out)
    if isinstance(out, dict):
        return {k: _clone(t) for k, t in out.items()}
    return None if out is None else out.clone()


def _tensors(inputs) -> list:
    """A call's inputs as tensors (a host numpy array without a copy)."""
    return [torch.from_numpy(np.require(a, requirements=["C", "W"]))
            if isinstance(a, np.ndarray) else a for a in inputs]


def _to_host(out: tuple) -> tuple:
    """``(copies, event)``: a tuple of outputs (tensors or None) on a
    card, copied into pinned host tensors from torch's caching host
    allocator, enqueued on the current stream of their device, and the
    (timing) event recorded after the copies; outputs on the host as they
    are, with no event."""
    dev = next((t.device for t in out if t is not None), None)
    if dev is None or dev.type != "cuda":
        return out, None
    host = tuple(None if t is None else torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 .copy_(t, non_blocking=True) for t in out)
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(dev))
    return host, event


class _CompiledGraph:
    """``fn(*inputs) -> outputs`` of one signature, the port's counterpart
    of one of the JAX package's jitted functions; ``run(*tensors)`` is the
    signature's eager body (for :class:`DepthPipeline`: the payload tensor
    → unpack → :meth:`DepthPipeline._forward`, under :func:`exact_f32` as
    every forward). An input is a host numpy array (u8 pixels, a packed
    payload, f32 scalars) or a tensor on the graph's device; the outputs
    are a tensor, None, or a tuple or a dict of them. ``device`` is where
    the graph runs: the owner's, or a meshed pipeline's data slot's
    (:class:`_SlotGraphs`).

    When its owner runs no graphs (the CPU, a mesh that
    :func:`~..parallel.sharding.captures_graphs` refuses) a call runs
    ``run`` eagerly on the inputs as tensors. On CUDA the first call
    captures ``run`` into a CUDA graph, under the owner's build lock: one
    eager pass first, on the device's capture stream (it makes the device
    constants and settles cuBLAS and cuDNN; its result is dropped and,
    like an XLA compile, it counts no launch), inside the owner's
    :meth:`_GraphOwner._warm_up` scope (where a body with side effects,
    the trainer's step, undoes what the pass updated, so that the first
    call's step is its replay's and no other), then the capture on the
    same stream, into the memory pool that the owner's graphs on that
    device share. Each input has a
    static tensor of its own in the graph. A capture that fails raises,
    naming the signature; nothing falls back to eager. Each call (the
    first too) copies each host input from pinned memory, and each device
    input on the device, into its static input, replays the graph and
    returns fresh copies of its static outputs: two calls may be in flight
    before either is read, and the JAX package's executables return new
    buffers on every call. A call returns them on the device;
    :meth:`to_host` (what :class:`DepthPipeline`'s submits call) copies the
    static outputs straight into pinned host memory instead, with no
    device copy, and returns the event after that copy. The copies in,
    the replay and the copies out hold the replay lock of the owner's
    graphs on that device, and a replay waits for their previous one on
    the card (the event recorded after the copies out): they share one
    pool, so no two of their replays may overlap, and a replay cannot
    overwrite the static outputs before they are copied. So a batch's copy
    to the host follows its own replay on the stream, before any later
    replay, and runs as soon as its forward ends. Each replay counts the
    hand kernels' launches it replays (``cuda.replayed``)."""

    def __init__(self, owner: "_GraphOwner", key: tuple, run, device: "torch.device | None" = None):
        self.owner, self.key, self.run = owner, key, run
        self.device = owner.device if device is None else device
        self.graph: "torch.cuda.CUDAGraph | None" = None
        self.static_in: tuple = ()
        self.static_out = None
        self.launches: dict = {}  # cuda.Kernel → launches a replay
        self.capture_s: float | None = None  # wall seconds of the warm-up and capture

    def __call__(self, *inputs):
        args = _tensors(inputs)
        if not self.owner.cuda_graphs:
            return self.run(*args)
        return self._replay(self._staged(args))

    def to_host(self, *inputs) -> tuple:
        """``(outputs, event)``: the call's outputs on the host and the
        event after their copy (:func:`_to_host`). A replay on a card
        enqueues the copy of its static outputs under the replay lock,
        before the event the next replay waits on; an eager body's outputs
        on a card are copied behind it; on the CPU, the outputs and None."""
        if self.owner.cuda_graphs and self.device.type == "cuda":
            return self._replay(self._staged(_tensors(inputs)), host=True)
        return _to_host(self(*inputs))

    def _staged(self, args: list) -> list:
        """The inputs staged for a replay (host ones in pinned memory), the
        graph captured on the first call and the inputs checked against
        its signature."""
        owner = self.owner
        staged = [a.pin_memory() if a.device.type == "cpu" else a for a in args]
        if self.graph is None:
            with owner._build_lock:
                if self.graph is None:
                    self._capture(staged)
                    spans.count("ipc_graph_captures_total")
        if [(s.shape, s.dtype) for s in staged] != [(t.shape, t.dtype) for t in self.static_in]:
            raise ValueError(
                f"inputs {[(tuple(s.shape), s.dtype) for s in staged]} do not match the "
                f"signature {self.key}'s {[(tuple(t.shape), t.dtype) for t in self.static_in]}")
        return staged

    def _capture(self, staged: list) -> None:
        owner, dev = self.owner, self.device
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            stream = _CAPTURE_STREAMS.get(dev)
            if stream is None:
                stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
            shared = owner._on_device(dev)
            static_in = tuple(torch.empty(tuple(s.shape), dtype=s.dtype, device=dev)
                              for s in staged)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream), cuda.recording_launches():
                for t, s in zip(static_in, staged):
                    t.copy_(s, non_blocking=True)
                with owner._warm_up():
                    self.run(*static_in)  # the warm-up pass
            graph = torch.cuda.CUDAGraph()
            # A graph that the cyclic collector destroyed during the capture
            # (pipelines and their graphs hold each other) would free its
            # memory on this thread, which the capture refuses: collect
            # first, and not during the capture.
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with cuda.recording_launches() as launches, torch.cuda.graph(
                    graph, pool=shared.pool, stream=stream,
                    capture_error_mode="thread_local",
                ):
                    static_out = self.run(*static_in)
            except RuntimeError as e:
                raise RuntimeError(
                    f"CUDA graph capture of signature {self.key} on {dev} failed: {e}") from e
            finally:
                if collecting:
                    gc.enable()
        self.static_in, self.static_out, self.launches = static_in, static_out, launches
        self.capture_s = time.perf_counter() - t0
        self.graph = graph  # last: a caller that sees the graph sees the rest

    def _replay(self, staged: list, host: bool = False):
        """The replay, and its outputs: fresh device copies, or with
        ``host`` the (host copies, event) of :func:`_to_host`."""
        shared = self.owner._on_device(self.device)
        with shared.replay_lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            if shared.replay_done is None:
                shared.replay_done = torch.cuda.Event()
            stream.wait_event(shared.replay_done)
            for t, s in zip(self.static_in, staged):
                t.copy_(s, non_blocking=True)
            self.graph.replay()
            out = _to_host(self.static_out) if host else _clone(self.static_out)
            shared.replay_done.record(stream)
        cuda.replayed(self.launches)
        return out


class _SlotGraphs:
    """The callable of one signature of a :class:`DepthPipeline` on a mesh
    of several data slots: one :class:`_CompiledGraph` per data slot
    (``slots``), on that slot's device, whose input is the slot's rows of
    the payload, sliced on the host (each copy in stays on its device) and
    whose body is the slot's whole pipeline on its rows. A call runs every
    slot's callable (a replay, or its eager body where the pipeline runs
    no graphs) and gathers their outputs on the first slot, outside the
    graphs, as ``_run_slots`` gathers them. ``run(payload)`` is the
    signature's eager body; ``graph`` is every slot's graph (None before
    the capture), ``capture_s`` the sum of the slots' capture times."""

    def __init__(self, owner: "DepthPipeline", key: tuple, run, slots: list):
        self.owner, self.key, self.run, self.slots = owner, key, run, slots

    def __call__(self, payload: np.ndarray):
        per = payload.shape[0] // len(self.slots)
        return self.owner._gather([fn(payload[d * per : (d + 1) * per])
                                   for d, fn in enumerate(self.slots)])

    def to_host(self, payload: np.ndarray) -> tuple:
        """``(outputs, event)``: the gathered outputs copied to the host
        behind the gather on the first slot (:func:`_to_host`)."""
        return _to_host(self(payload))

    @property
    def graph(self) -> "tuple | None":
        graphs = tuple(fn.graph for fn in self.slots)
        return None if None in graphs else graphs

    @property
    def capture_s(self) -> "float | None":
        times = [fn.capture_s for fn in self.slots]
        return None if None in times else sum(times)


class _DeviceGraphs:
    """What an owner's CUDA graphs on one device share: the memory pool
    (so the graphs of its signatures reuse one another's memory), the
    replay lock and the last replay's event."""

    def __init__(self, device: torch.device):
        with torch.cuda.device(device):
            self.pool = torch.cuda.graph_pool_handle()
        self.replay_lock = threading.Lock()
        self.replay_done: "torch.cuda.Event | None" = None


class _GraphOwner:
    """The signature cache of an object that runs compiled programs
    (:class:`DepthPipeline`, the advanced pipelines, the v2 matte): its
    callables (:class:`_CompiledGraph`) under the JAX package's keys in
    ``_compiled``, the shape-keyed ones of its ops (:meth:`_op`), the
    build lock, and what the CUDA graphs on each device share
    (:class:`_DeviceGraphs`). ``device`` is the owner's (a meshed
    pipeline's first slot, where its results gather); ``cuda_graphs``
    says whether the callables capture (on CUDA) or run eagerly. Without
    a mesh every graph is on ``device``; a meshed :class:`DepthPipeline`
    captures one graph per data slot on that slot's device where each
    data slot is one device (:func:`~..parallel.sharding.captures_graphs`),
    and the meshed trainer one graph a step where the whole mesh is one
    device; other meshes run eagerly, which their owners log once. The
    trainer and ``train/eval.py``'s ``depth_metrics`` own their graphs the
    same way."""

    def __init__(self, device: torch.device, cuda_graphs: bool):
        self.device = device
        self.cuda_graphs = cuda_graphs
        self._compiled: dict[tuple, _CompiledGraph] = {}
        self._op_graphs: dict[tuple, _CompiledGraph] = {}
        self._build_lock = threading.Lock()
        self._devices: dict = {}  # torch.device → _DeviceGraphs

    def _on_device(self, device: torch.device) -> _DeviceGraphs:
        """What the owner's graphs on ``device`` share, made at its first
        capture (under the capture lock); a replay follows a capture."""
        shared = self._devices.get(device)
        if shared is None:
            shared = self._devices[device] = _DeviceGraphs(device)
        return shared

    def _get(self, key: tuple, builder, cache: "dict | None" = None) -> _CompiledGraph:
        cache = self._compiled if cache is None else cache
        fn = cache.get(key)
        if fn is None:
            # Concurrent callers (two drains in flight) share one
            # callable, so one capture, per signature.
            with self._build_lock:
                fn = cache.get(key)
                if fn is None:
                    fn = builder()
                    cache[key] = fn
        return fn

    def _warm_up(self):
        """The scope of a capture's eager warm-up pass: nothing around it
        here; an owner whose bodies update its state in place (the
        trainer) undoes the pass's updates when the scope closes."""
        return contextlib.nullcontext()

    def _signature(self, key: tuple, run) -> _CompiledGraph:
        """The callable of the JAX cache key ``key``, ``run`` its body."""
        return self._get(key, lambda: _CompiledGraph(self, key, run))

    def _op(self, name: str, fn, *inputs):
        """``fn(*inputs)`` through its callable keyed by ``name`` and the
        inputs' shapes, as a jitted op of the JAX package retraces on
        shapes."""
        key = (name, *(tuple(np.shape(a)) for a in inputs))
        return self._get(key, lambda: _CompiledGraph(self, key, fn), self._op_graphs)(*inputs)

    def graph_pool_bytes(self) -> int:
        """Device bytes reserved by the memory pools the CUDA graphs share,
        over every device (0 before the first capture)."""
        if not self._devices:
            return 0
        pools = {tuple(shared.pool) for shared in self._devices.values()}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)


class DepthPipeline(_GraphOwner):
    """The depth→point-cloud pipeline over one model of any family on one
    device (the model's own device and dtype: bf16 on CUDA for serving,
    f32 on CPU).

    ``quantized_transfer=None`` follows :func:`default_quantized_transfer`
    for the model's device. The bundle's depth codec is the 8×8-tiled
    sub-byte one; ``IPC_TPU_DEPTH12=1`` selects the flat 12-bit pack and
    ``IPC_TPU_DEPTH16=1`` the u16 contract. On the JPEG ingest the host
    rebuilds the grid colours from the coefficients when it can;
    ``IPC_TPU_HOST_COLORS=0`` keeps the device's 4:2:0 ride-along.

    ``mesh`` (``parallel/``) serves on a grid of device slots: each batch
    is padded to a multiple of the ``data`` slots, its rows split over
    them, and every data slot runs the whole pipeline on its rows (K2 and
    K3 once per data slot), the results gathered on the first slot and cut
    back to the real batch. The model runs megatron-sharded over the
    ``model`` slots (:class:`~..parallel.sharding.MeshedModel`), or, on a
    (data, pipe) mesh with ``pipe`` > 1, GPipe-pipelined over the ``pipe``
    slots in up to ``pipe_microbatches`` microbatches
    (:class:`~..parallel.pipeline_par.PipelinedModel`); a mesh with
    neither replicates it on every data slot. On a mesh the pipeline takes
    ``model`` over (best given on the CPU, as :class:`~..serve.models.
    ModelManager` gives it) and keeps its blocks only as the slots hold
    them: :attr:`model` is then the model without its blocks.

    On CUDA each signature is a CUDA graph per data slot, on that slot's
    device (:class:`_SlotGraphs`; with one data slot, one graph, as
    without a mesh), wherever every data slot's slots are one device
    (:func:`~..parallel.sharding.captures_graphs`: DP over any devices,
    TP, int8 TP or GPipe inside one card, every slot of one card). A mesh
    with TP or GPipe across cards inside a data slot runs its eager body,
    and the pipeline logs so once."""

    def __init__(
        self,
        model: nn.Module,
        *,
        model_target: "int | tuple[int, int] | None" = None,
        quantized_transfer: bool | None = None,
        mesh=None,
        pipe_microbatches: int = 4,
    ):
        self.cfg = model.cfg
        self.mesh = mesh
        # The compute dtype: the first floating parameter's (an int8
        # encoder keeps f32 or bf16 around its int8 weights).
        self.dtype = next(t.dtype for t in model.parameters() if t.is_floating_point())
        self.meshed, self._slots = self._place(model.eval(), mesh, pipe_microbatches)
        if mesh is not None:
            from image_to_pointcloud_tpu_torch.parallel.sharding import without_blocks

            model = without_blocks(model)
        self.model = model
        # One callable per signature (:meth:`_get`); on CUDA each is a CUDA
        # graph (one per data slot on a mesh), captured on first use.
        first = self._slots[0][0]
        graphs = first.type == "cuda"
        if mesh is not None and graphs:
            from image_to_pointcloud_tpu_torch.parallel.sharding import captures_graphs

            graphs = captures_graphs(mesh)
            if not graphs:
                logger.warning("DepthPipeline on %r: a data slot spans several devices, so "
                               "every signature runs its eager body (no CUDA graphs)", mesh)
        super().__init__(first, graphs)
        # f32 on CUDA runs without TF32 (the module docstring).
        self.exact_f32 = wants_exact_f32(self.device, self.dtype)
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
        # Per-JpegSpec floor of the sparse capacities (select_sparse_caps).
        self._sparse_caps: dict = {}

    @staticmethod
    def _place(model: nn.Module, mesh, pipe_microbatches: int) -> tuple:
        """The meshed model (None without a mesh, or where the data slots
        hold replicas) and the (device, depth forward) of each data slot."""
        if mesh is None:
            return None, [(next(model.parameters()).device, model)]
        from image_to_pointcloud_tpu_torch.parallel.sharding import (
            DATA_AXIS,
            MODEL_AXIS,
            MeshedModel,
            replicate,
        )

        n = mesh.shape[DATA_AXIS]
        if mesh.shape.get("pipe", 1) > 1:
            from image_to_pointcloud_tpu_torch.parallel.pipeline_par import PipelinedModel

            meshed = PipelinedModel(model, mesh, num_microbatches=pipe_microbatches)
        elif MODEL_AXIS in mesh.shape:
            meshed = MeshedModel(model, mesh)
        else:  # e.g. --mesh pipe=1,data=N: plain DP, the model replicated
            return None, [(mesh.device(data=d),
                           replicate(model, mesh.device(data=d), detach=True))
                          for d in range(n)]
        return meshed, [(mesh.device(data=d), functools.partial(meshed.forward_slot, d))
                        for d in range(n)]

    def _data_pad(self, b: int) -> int:
        """Rows of padding so the batch divides the mesh's data slots (a
        lone request on a data=2 mesh must still split)."""
        return (-b) % len(self._slots)

    def _run_slots(self, rows, in_hw, options, want_preview, **kw):
        """``rows(d, device) -> (img, scales)`` of each data slot → the
        batch's (out, preview) on the first slot, eagerly."""
        with exact_f32(self.exact_f32):
            outs = [
                self._forward(*rows(d, dev), in_hw, options, want_preview, model=fwd, **kw)
                for d, (dev, fwd) in enumerate(self._slots)
            ]
        return self._gather(outs)

    def _gather(self, outs: list) -> tuple:
        """Each data slot's (out, preview) → the batch's, on the first
        slot."""
        if len(outs) == 1:
            return outs[0]
        out = torch.cat([o.to(self.device) for o, _ in outs])
        prev = None if outs[0][1] is None else torch.cat([p.to(self.device) for _, p in outs])
        return out, prev

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
        model=None,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(B, sh, sw, 3) f32 source pixels (the upload, or its JPEG
        decode at ``spec.out_hw``) + (B,) f32 scales, on the model's
        device, of an upload of size ``in_hw`` → (the (B, 8, N) packed
        points or the (B, nbytes) u8 bundle, preview or None); ``model``
        is the depth forward (default: the pipeline's model)."""
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
        depth = (model or self.model)(x)  # (B, mh, mw) f32
        if pad_h or pad_w:
            # ZoeDepth's post-process: bicubic (align_corners=False) back
            # to the padded size, then the margins cropped.
            depth = resize_planes(depth, (hp, wp), "bicubic_torch")
            depth = depth[:, pad_h : hp - pad_h, pad_w : wp - pad_w]  # (B, h, w)

        # Point path: upscale to working size, re-normalize, [blur].
        dn_all = _points_depth(depth, h, w, opts)

        # Preview: normalized at model resolution (shared with the point
        # path when the sizes coincide), as gray u8; the host applies the
        # PLASMA table. Oversized previews colorize then area-resize here,
        # the reference's order.
        prev = None
        if preview:
            if (dmh, dmw) == (h, w) and not opts.smooth_depth:
                dn_prev = dn_all
            else:
                dn_prev = normalize_depth_planes(depth, opts.invert_depth)
            prev = (dn_prev * 255.0).to(torch.uint8)
            if (pv_h, pv_w) != (dmh, dmw):
                rgb = resize_batched(apply_colormap(prev).float(), (pv_h, pv_w), "area")
                prev = rgb.round().clamp(0, 255).to(torch.uint8)

        packed = _packed_points(dn_all, img, depth_scales, opts=opts, h=h, w=w, step=step)
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

    def _handle(self, out, prev, in_hw, options, depth_scales, b, imgs=None, host_rgb=None,
                stages=None, copied=None):
        """The handle of a submitted batch, its outputs cut back to the
        ``b`` real rows (a mesh pads a batch to its data slots);
        ``stages``, its submit's; ``copied``, the event after the outputs'
        copy to the host (outputs still on a card are copied here)."""
        if copied is None:
            (out, prev), copied = _to_host((out, prev))
        if out.shape[0] != b:
            out, prev = out[:b], None if prev is None else prev[:b]
        h, w = _proc_hw(*in_hw)
        step = DENSITY_STRIDES[options.density]
        return _Handle(
            out, prev, self.quantized_transfer, (-(-h // step), -(-w // step)), (h, w),
            step, options.fov, depth_scales, imgs, host_rgb, {} if stages is None else stages,
            copied,
        )

    # ---------- the signature cache ----------

    def _build(
        self,
        key: tuple,
        in_hw: tuple[int, int],
        opts: PipelineOptions,
        batch: int,
        preview: bool = True,
        jpeg_spec: "JpegSpec | None" = None,
        jpeg_sparse_cap: "tuple[int, int] | None" = None,
        jpeg_host_colors: bool = False,
    ) -> _CompiledGraph:
        """The callable of one signature: a (``batch``, nbytes) u8 payload
        → (out, preview). ``jpeg_spec`` switches its head to the hybrid
        JPEG ingest (coefficients in the payload, sparse when
        ``jpeg_sparse_cap`` gives the capacities; ``in_hw`` stays the
        original image size), ``jpeg_host_colors`` drops the colour
        ride-along from the bundle (the host rebuilds the colours)."""
        if jpeg_spec is not None and jpeg_sparse_cap is not None:
            unpack = functools.partial(_unpack_jpeg_sparse_batch, spec=jpeg_spec,
                                       cap=jpeg_sparse_cap[0], exc_cap=jpeg_sparse_cap[1])
        elif jpeg_spec is not None:
            unpack = functools.partial(_unpack_jpeg_batch, spec=jpeg_spec)
        else:
            unpack = functools.partial(_unpack_pixel_batch, in_hw=in_hw)
        kw = {} if jpeg_spec is None else {"jpeg": True, "host_colors": jpeg_host_colors}
        per = batch // len(self._slots)

        @torch.inference_mode()
        def run(payload_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
            def rows(d, dev):
                return unpack(payload_u8[d * per : (d + 1) * per].to(dev))

            return self._run_slots(rows, in_hw, opts, preview, **kw)

        if len(self._slots) == 1:
            return _CompiledGraph(self, key, run)

        def slot_run(d: int):
            @torch.inference_mode()
            def run_slot(rows_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
                dev, fwd = self._slots[d]
                with exact_f32(self.exact_f32):
                    return self._forward(*unpack(rows_u8.to(dev)), in_hw, opts, preview,
                                         model=fwd, **kw)

            return run_slot

        return _SlotGraphs(self, key, run, [_CompiledGraph(self, key, slot_run(d), device=dev)
                                            for d, (dev, _) in enumerate(self._slots)])

    @staticmethod
    def pack_payload(imgs: np.ndarray, depth_scales: np.ndarray) -> np.ndarray:
        """Fuse (B, H, W, 3) u8 images + (B,) f32 scales into the one
        (B, H·W·3+4) u8 host→device buffer of the pixel ingest's graph:
        [pixels | f32 scale as 4 little-endian bytes] per row."""
        return np.concatenate(
            [
                imgs.reshape(len(imgs), -1),
                np.ascontiguousarray(depth_scales, np.float32).view(np.uint8).reshape(len(imgs), 4),
            ],
            axis=1,
        )

    def compiled_graph(
        self,
        batch: int,
        in_hw: tuple[int, int],
        options: PipelineOptions,
        want_preview: bool,
    ) -> _CompiledGraph:
        """The callable of one pixel-ingest signature (made on first ask,
        captured on first call): ``fn(payload_u8) -> (out, preview)``, the
        payload from :meth:`pack_payload`. Public so that benches and
        checks run the exact serving graph under its cache key."""
        key = ("depth", batch, in_hw[0], in_hw[1], options, want_preview)
        return self._get(key, lambda: self._build(key, in_hw, options, batch, preview=want_preview))

    def compiled_graph_jpeg(
        self,
        batch: int,
        spec: JpegSpec,
        options: PipelineOptions,
        want_preview: bool,
        sparse_cap: "tuple[int, int] | None" = None,
        host_colors: bool = False,
    ) -> _CompiledGraph:
        """Hybrid-ingest variant of :meth:`compiled_graph`: the JpegSpec is
        the shape part of the signature, with the (AC, exception) capacity
        buckets of a sparse payload (:meth:`select_sparse_caps`) and the
        host-colours bundle layout."""
        key = ("depth-jpeg", batch, spec, options, want_preview, sparse_cap, host_colors)
        return self._get(key, lambda: self._build(
            key, (spec.height, spec.width), options, batch, preview=want_preview,
            jpeg_spec=spec, jpeg_sparse_cap=sparse_cap, jpeg_host_colors=host_colors,
        ))

    def select_sparse_caps(self, jpegs: "list[JpegInput]") -> "tuple[int, int] | None":
        """(AC, exception) capacity buckets for one hybrid batch with the
        per-spec floor applied and ratcheted up, or None when the dense
        payload wins. Caps are part of a signature: without the floor
        almost every JPEG batch would capture a graph of its own. The
        floor's read-modify-write holds the build lock, so two concurrent
        submits for one spec never pick different caps from a stale floor."""
        caps = plan_sparse_batch(jpegs)
        if caps is None:
            return None
        spec = jpegs[0].spec
        with self._build_lock:
            floor = self._sparse_caps.get(spec)
            if floor is not None:
                caps = (max(caps[0], floor[0]), max(caps[1], floor[1]))
            self._sparse_caps[spec] = caps
        return caps

    # ---------- host-facing API ----------

    def submit_batch(
        self,
        images_rgb_u8: "np.ndarray | list[np.ndarray]",
        *,
        depth_scales: "np.ndarray | list[float] | float" = 10.0,
        options: PipelineOptions = PipelineOptions(),
        want_preview: bool = True,
    ) -> _Handle:
        """Enqueue one batch of same-size images through its signature's
        graph; returns a handle for :meth:`collect`. On CUDA the work runs
        asynchronously."""
        stages: dict = {}
        with spans.span("pipeline.pack", stages):
            imgs = np.stack(images_rgb_u8)
            b, h0, w0 = imgs.shape[:3]
            scales = np.broadcast_to(np.asarray(depth_scales, np.float32), (b,)).copy()
            pad = self._data_pad(b)
            run_imgs = np.concatenate([imgs, imgs[-1:].repeat(pad, 0)]) if pad else imgs
            run_scales = np.concatenate([scales, scales[-1:].repeat(pad)]) if pad else scales
            fn = self.compiled_graph(b + pad, (h0, w0), options, want_preview)
            payload = self.pack_payload(run_imgs, run_scales)
        (out, prev), copied = self._launch(fn, payload, stages)
        return self._handle(out, prev, (h0, w0), options, scales, b, imgs=imgs, stages=stages,
                            copied=copied)

    @staticmethod
    def _launch(fn, payload: np.ndarray, stages: dict):
        """``fn.to_host(payload)`` as the batch's "pipeline.replay" stage:
        the pinned staging, the copy in, the replay and the copy out
        enqueued behind it (or the eager body where no graphs run), →
        ((out, preview), event). Counts the payload's bytes to the
        device."""
        spans.count("ipc_h2d_bytes_total", payload.nbytes)
        with spans.span("pipeline.replay", stages):
            return fn.to_host(payload)

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
        The payload is the sparse one whenever :meth:`select_sparse_caps`
        finds it smaller than the dense one."""
        stages: dict = {}
        with spans.span("pipeline.pack", stages):
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
            pad = self._data_pad(b)
            run = jpegs + [jpegs[-1]] * pad
            run_scales = np.concatenate([scales, scales[-1:].repeat(pad)]) if pad else scales
            caps = self.select_sparse_caps(run)
            fn = self.compiled_graph_jpeg(b + pad, spec, options, want_preview, sparse_cap=caps,
                                          host_colors=host_rgb is not None)
            if caps is not None:
                payload = self.pack_jpeg_sparse_payload(run, run_scales, *caps)
            else:
                payload = self.pack_jpeg_payload(run, run_scales)
        (out, prev), copied = self._launch(fn, payload, stages)
        return self._handle(out, prev, (spec.height, spec.width), options, scales, b,
                            host_rgb=host_rgb, stages=stages, copied=copied)

    def collect(
        self,
        handle: _Handle,
        *,
        want_preview: bool = True,
        want_packed: bool = True,
        want_preview_rgb: bool = True,
    ) -> list[PipelineResult]:
        """Wait for a submitted batch on the host and split it per image.
        ``want_preview_rgb=False`` skips the host PLASMA lookup for callers
        that render the gray preview themselves. Its stages, "pipeline.d2h_wait"
        (the wait for the device and the copies) and "pipeline.unbundle"
        (the split into clouds), add to ``handle.stages``.

        The batch's device→host copy was enqueued at submit, behind the
        batch's own replay (:class:`_Handle`), so the wait here is on the
        event after that copy, never behind a batch submitted later. A
        collect of a batch copied from a card counts
        ``ipc_d2h_collects_total``, and ``ipc_d2h_ready_total`` too where
        the copy had already completed when the collect began."""
        prev = handle.preview if want_preview else None
        if handle.copied is not None:
            spans.count("ipc_d2h_collects_total")
            if handle.copied.query():
                spans.count("ipc_d2h_ready_total")
        with spans.span("pipeline.d2h_wait", handle.stages):
            if handle.copied is not None:
                handle.copied.synchronize()
            out = handle.out.numpy()
            prev_np = None if prev is None else prev.numpy()
        spans.count("ipc_d2h_bytes_total", out.nbytes + (0 if prev_np is None else prev_np.nbytes))
        with spans.span("pipeline.unbundle", handle.stages):
            prev_gray = None
            if prev_np is not None and prev_np.ndim == 3:  # gray u8 → PLASMA on the host
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
    image_rgb_u8: np.ndarray, density: str, device: "str | torch.device" = "cuda"
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
    image_u8_rgb: np.ndarray, device: "str | torch.device" = "cuda"
) -> np.ndarray:
    """Fake depth-map preview for the dummy models (reference
    backend/app.py:589-607): gray → 15×15 Gaussian blur → inverted →
    PLASMA, as (H, W, 3) u8."""
    gray = _gray(torch.from_numpy(np.array(image_u8_rgb)).to(device).float())
    inv = (255.0 - torch.round(gaussian_blur(gray, 15))).to(torch.uint8)
    return PLASMA_RGB[inv.cpu().numpy()]
