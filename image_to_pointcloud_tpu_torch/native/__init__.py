"""Native host-side components (C++ via ctypes).

The reference leans on native libraries for host geometry (Open3D's C++
decimation/meshing, backend/app.py:516) and formatting hot loops; this
package holds the framework's own C++ equivalents, built on demand with
g++ and bound through ctypes (no pybind11 in this toolchain).

Public functions degrade gracefully: if the toolchain is unavailable the
callers fall back to the pure-Python/numpy paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "src"
_BUILD = Path(__file__).parent / "build"
_LIB: ctypes.CDLL | None | bool = None  # None = untried, False = unavailable
# First call may compile: serialize it. Serving runs 4 executor threads
# (serve/app_v1.py) — two unsynchronized check-then-build races would run
# two g++ processes writing the same .so and load a truncated library.
_LOAD_LOCK = threading.Lock()


def _load() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is False:
        return None
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is not None:  # lost the race; winner already resolved it
            return None if _LIB is False else _LIB
        return _load_locked()


def _source_hash(srcs: list[Path], headers: list[Path]) -> str:
    """SHA-256 over the contents of every source + header, path-ordered.

    This is the staleness criterion for a built binary: mtimes are
    useless after a clone (uniform checkout times), so the hash is
    embedded in the .so at build time (src/version.cpp) and compared to
    the sources actually on disk at load time.
    """
    h = hashlib.sha256()
    for p in sorted([*srcs, *headers]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _load_locked() -> ctypes.CDLL | None:
    global _LIB
    so = _BUILD / "libipc_native.so"
    srcs = sorted(_SRC.glob("*.cpp"))
    try:
        expected = _source_hash(srcs, sorted(_SRC.glob("*.h")))
        # The stamp is a plain string literal in the binary: substring
        # search avoids dlopen-ing a library we may be about to rewrite.
        # Chunked scan (overlap = stamp length) instead of read_bytes():
        # loading the whole .so into memory once per process is waste.
        def _contains(path, needle: bytes, chunk=1 << 20) -> bool:
            tail = b""
            with open(path, "rb") as f:
                while True:
                    block = f.read(chunk)
                    if not block:
                        return False
                    if needle in tail + block:
                        return True
                    tail = block[-(len(needle) - 1):]

        stale = not so.exists() or not _contains(so, expected.encode())
        if stale:
            try:
                _BUILD.mkdir(exist_ok=True)
                # Processes (test workers, servers) can reach the first
                # build together: one compiles under the lock, the others
                # wait and find the finished library; the build writes a
                # temporary name and renames, so no one loads half a file.
                with open(_BUILD / "build.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not so.exists() or not _contains(so, expected.encode()):
                        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                        subprocess.run(
                            [
                                "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                                f'-DIPC_SOURCE_HASH="{expected}"',
                                *map(str, srcs), "-o", str(tmp),
                            ],
                            check=True,
                            capture_output=True,
                        )
                        os.replace(tmp, so)
            except Exception as build_err:  # noqa: BLE001
                # No toolchain: a stale binary must NOT silently serve
                # old code for edited sources — fall back to Python.
                logger.error(
                    "native library is stale for the checked-out sources "
                    "and rebuilding failed (%s); using Python fallbacks. "
                    "Run g++ per native/__init__.py to restore it.",
                    build_err,
                )
                _LIB = False
                return None
        lib = ctypes.CDLL(str(so))
        lib.ipc_source_hash.restype = ctypes.c_char_p
        lib.ipc_source_hash.argtypes = []
        loaded = lib.ipc_source_hash().decode()
        if loaded != expected:  # pragma: no cover - build/loader bug guard
            logger.error(
                "native library stamp %s != source hash %s; "
                "using Python fallbacks", loaded[:12], expected[:12],
            )
            _LIB = False
            return None
        lib.ipc_decimate.restype = ctypes.c_int32
        lib.ipc_decimate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.ipc_format_xyz.restype = ctypes.c_int64
        lib.ipc_format_xyz.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ipc_surface_reconstruct.restype = ctypes.c_int32
        lib.ipc_surface_reconstruct.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ipc_surface_release.restype = None
        lib.ipc_surface_release.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ipc_poisson_reconstruct.restype = ctypes.c_int32
        lib.ipc_poisson_reconstruct.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ipc_mean_nn_distance.restype = ctypes.c_float
        lib.ipc_mean_nn_distance.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ipc_bpa_reconstruct.restype = ctypes.c_int64
        lib.ipc_bpa_reconstruct.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.ipc_bpa_release.restype = None
        lib.ipc_bpa_release.argtypes = [ctypes.c_void_p]
        lib.ipc_json_f32_list.restype = ctypes.c_int64
        lib.ipc_json_f32_list.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ipc_json_f32_triplets.restype = ctypes.c_int64
        lib.ipc_json_f32_triplets.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ipc_json_f64_triplets.restype = ctypes.c_int64
        lib.ipc_json_f64_triplets.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ipc_json_i32_triplets.restype = ctypes.c_int64
        lib.ipc_json_i32_triplets.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ipc_json_i32_list.restype = ctypes.c_int64
        lib.ipc_json_i32_list.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ipc_ply_pack.restype = ctypes.c_int64
        lib.ipc_ply_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.ipc_reconstruct.restype = ctypes.c_int64
        lib.ipc_reconstruct.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ipc_reconstruct_ycc420.restype = ctypes.c_int64
        lib.ipc_reconstruct_ycc420.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ipc_jpeg_probe.restype = ctypes.c_int32
        lib.ipc_jpeg_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.ipc_jpeg_coeffs.restype = ctypes.c_int32
        lib.ipc_jpeg_coeffs.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ipc_jpeg_sparse_pack.restype = ctypes.c_int32
        lib.ipc_jpeg_sparse_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ipc_voxel_downsample.restype = ctypes.c_int64
        lib.ipc_voxel_downsample.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ipc_jpeg_grid_colors.restype = ctypes.c_int32
        lib.ipc_jpeg_grid_colors.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        _LIB = lib
        return lib
    except Exception as e:  # noqa: BLE001
        logger.warning("native module unavailable (%s); using Python fallbacks", e)
        _LIB = False
        return None


def available() -> bool:
    return _load() is not None


def voxel_downsample(
    points: np.ndarray, colors: np.ndarray, voxel_size: float
) -> tuple[np.ndarray, np.ndarray] | None:
    """Average points/colors per occupied voxel (Open3D
    voxel_down_sample semantics, same grid rule and output order as
    ops/voxel.py's XLA kernel); None if the native lib is unavailable
    or the index range exceeds the packed-key bound (±2²¹ cells/axis —
    caller falls back to the device path)."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(points, np.float32)
    c = np.ascontiguousarray(colors, np.float32)
    if p.ndim != 2 or p.shape[1] != 3 or c.shape != p.shape:
        raise ValueError(
            f"expected (N, 3) points/colors, got {p.shape}/{c.shape}"
        )
    n = len(p)
    if n == 0:
        return p.copy(), c.copy()
    out_p = np.empty((n, 3), np.float32)
    out_c = np.empty((n, 3), np.float32)
    m = lib.ipc_voxel_downsample(
        p.ctypes.data, c.ctypes.data, n, float(voxel_size),
        out_p.ctypes.data, out_c.ctypes.data,
    )
    if m < 0:
        return None
    if 2 * m <= n:
        return out_p[:m].copy(), out_c[:m].copy()
    return out_p[:m], out_c[:m]


def decimate_mesh(
    verts: np.ndarray,
    colors: np.ndarray,
    faces: np.ndarray,
    target_faces: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Quadric edge-collapse decimation; None if native lib unavailable.

    Raises on colors/verts length mismatch or out-of-range face indices
    — the C kernel has no bounds checks (by design, it's the hot path),
    so bad indices from e.g. an externally loaded mesh must fail here as
    a Python exception, not heap corruption in-process."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64).copy()
    c = np.ascontiguousarray(colors, np.float64).copy()
    f = np.ascontiguousarray(faces, np.int32).copy().reshape(-1, 3)
    if len(c) != len(v):
        raise ValueError(f"colors length {len(c)} != verts length {len(v)}")
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError(
            f"face indices [{f.min()}, {f.max()}] out of range for "
            f"{len(v)} vertices"
        )
    new_nv = ctypes.c_int32(0)
    nf = lib.ipc_decimate(
        v.ctypes.data, c.ctypes.data, len(v),
        f.ctypes.data, len(f), int(target_faces),
        ctypes.byref(new_nv),
    )
    return (
        v[: new_nv.value].astype(np.float32),
        c[: new_nv.value].astype(np.float32),
        f[:nf].copy(),
    )


def reconstruct_points(
    d16: np.ndarray,
    keep: np.ndarray,
    rgb: np.ndarray,
    *,
    step: int,
    depth_scale: float,
    f: float,
    cx: float,
    cy: float,
    denom: float = 65535.0,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Fused dequantize+unproject+color-gather+compact; None if unavailable.

    Args:
      d16: (hh, ww) uint16 quantized normalized depth (values in
        [0, denom] — the 12-bit packed transfer passes denom=4095).
      keep: (hh, ww) bool/uint8 keep mask.
      rgb: (hh, ww, 3) uint8 color source — may be a strided view.
    """
    lib = _load()
    if lib is None:
        return None
    hh, ww = d16.shape
    d16 = np.ascontiguousarray(d16, np.uint16)
    keep_u8 = np.ascontiguousarray(keep, np.uint8)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.strides[2] != 1:
        # The C kernel handles arbitrary row/col strides but needs the
        # channel axis contiguous; copy rather than assert (backends
        # differ in the strides np.asarray hands back).
        rgb = np.ascontiguousarray(rgb, np.uint8)
    out_xyz = np.empty((hh * ww, 3), np.float32)
    out_rgb = np.empty((hh * ww, 3), np.float32)
    m = lib.ipc_reconstruct(
        d16.ctypes.data, keep_u8.ctypes.data, rgb.ctypes.data,
        rgb.strides[0], rgb.strides[1],
        hh, ww, step, float(depth_scale), float(f), float(cx), float(cy),
        float(np.float32(1.0 / denom)),
        out_xyz.ctypes.data, out_rgb.ctypes.data,
    )
    if 2 * m <= hh * ww:
        # Results are retained by the job registry; when the keep mask
        # dropped most of the grid, don't let slim views pin the full
        # 24-bytes/pixel base buffers for the job's retention window.
        return out_xyz[:m].copy(), out_rgb[:m].copy()
    return out_xyz[:m], out_rgb[:m]


def reconstruct_points_ycc420(
    d16: np.ndarray,
    keep: np.ndarray,
    y: np.ndarray,
    cb: np.ndarray,
    cr: np.ndarray,
    *,
    step: int,
    depth_scale: float,
    f: float,
    cx: float,
    cy: float,
    denom: float = 65535.0,
) -> tuple[np.ndarray, np.ndarray] | None:
    """:func:`reconstruct_points` for the hybrid-JPEG 4:2:0 color
    ride-along: colors come from a (hh, ww) u8 luma plane plus
    (ceil(hh/2), ceil(ww/2)) u8 chroma planes, converted per kept point
    (BT.601 full-range inverse, ties-to-even rounding — bit-identical
    to the numpy fallback in pipeline/graph.py)."""
    lib = _load()
    if lib is None:
        return None
    hh, ww = d16.shape
    d16 = np.ascontiguousarray(d16, np.uint16)
    keep_u8 = np.ascontiguousarray(keep, np.uint8)
    y = np.ascontiguousarray(y, np.uint8)
    cb = np.ascontiguousarray(cb, np.uint8)
    cr = np.ascontiguousarray(cr, np.uint8)
    out_xyz = np.empty((hh * ww, 3), np.float32)
    out_rgb = np.empty((hh * ww, 3), np.float32)
    m = lib.ipc_reconstruct_ycc420(
        d16.ctypes.data, keep_u8.ctypes.data,
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
        hh, ww, cb.shape[1],
        step, float(depth_scale), float(f), float(cx), float(cy),
        float(np.float32(1.0 / denom)),
        out_xyz.ctypes.data, out_rgb.ctypes.data,
    )
    if 2 * m <= hh * ww:
        # Same slim-view rule as reconstruct_points: don't pin the full
        # base buffers in the job registry when most points dropped.
        return out_xyz[:m].copy(), out_rgb[:m].copy()
    return out_xyz[:m], out_rgb[:m]


def json_f32_list(values: np.ndarray) -> bytes | None:
    """``[v0,v1,...]`` JSON bytes for a flat f32 array; None if unavailable.

    Serves the reference's inline preview contract (backend/app.py:545-559)
    without materializing 10^5 Python float objects per job."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.float32).reshape(-1)
    cap = 32 * max(len(v), 1) + 16
    buf = ctypes.create_string_buffer(cap)
    written = lib.ipc_json_f32_list(v.ctypes.data, len(v), buf, cap)
    if written < 0:
        return None
    return buf.raw[:written]


def json_f32_triplets(values: np.ndarray) -> bytes | None:
    """``[[x,y,z],...]`` JSON bytes for an (N,3) f32 array; None if
    unavailable. The reference's preview shape (backend/app.py:504-505)."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.float32).reshape(-1, 3)
    n = len(v)
    cap = 3 * 32 * max(n, 1) + 4 * max(n, 1) + 16
    buf = ctypes.create_string_buffer(cap)
    written = lib.ipc_json_f32_triplets(v.ctypes.data, n, buf, cap)
    if written < 0:
        return None
    return buf.raw[:written]


def json_f64_triplets(values: np.ndarray) -> bytes | None:
    """``[[x,y,z],...]`` JSON bytes for an (N,3) f64 array (exact
    doubles); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.float64).reshape(-1, 3)
    n = len(v)
    cap = 3 * 32 * max(n, 1) + 4 * max(n, 1) + 16
    buf = ctypes.create_string_buffer(cap)
    written = lib.ipc_json_f64_triplets(v.ctypes.data, n, buf, cap)
    if written < 0:
        return None
    return buf.raw[:written]


def json_i32_triplets(values: np.ndarray) -> bytes | None:
    """``[[a,b,c],...]`` JSON bytes for an (N,3) int32 array; None if
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.int32).reshape(-1, 3)
    n = len(v)
    cap = 3 * 16 * max(n, 1) + 4 * max(n, 1) + 16
    buf = ctypes.create_string_buffer(cap)
    written = lib.ipc_json_i32_triplets(v.ctypes.data, n, buf, cap)
    if written < 0:
        return None
    return buf.raw[:written]


def json_i32_list(values: np.ndarray) -> bytes | None:
    """``[v0,v1,...]`` JSON bytes for a flat int32 array; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.int32).reshape(-1)
    cap = 16 * max(len(v), 1) + 16
    buf = ctypes.create_string_buffer(cap)
    written = lib.ipc_json_i32_list(v.ctypes.data, len(v), buf, cap)
    if written < 0:
        return None
    return buf.raw[:written]


def ply_pack(points: np.ndarray, colors: np.ndarray | None) -> bytes | None:
    """Binary PLY vertex records (f64 xyz + u8 rgb); None if unavailable
    OR if points aren't float32 — the header advertises doubles, and the
    C path promotes f32→f64 exactly; a float64 input would be silently
    rounded through f32, so it routes to the exact Python writer instead.

    Raises on a colors/points length mismatch — silently emitting
    colorless 24-byte records under a header advertising RGB would be a
    corrupt file (callers decide the has-colors question explicitly)."""
    lib = _load()
    if lib is None:
        return None
    if np.asarray(points).dtype != np.float32:
        return None
    p = np.ascontiguousarray(points, np.float32)
    n = len(p)
    has_c = colors is not None
    if has_c and len(colors) != n:
        raise ValueError(
            f"colors length {len(colors)} != points length {n}"
        )
    rec = 27 if has_c else 24
    out = ctypes.create_string_buffer(rec * max(n, 1))
    c = np.ascontiguousarray(colors, np.float32) if has_c else None
    written = lib.ipc_ply_pack(
        p.ctypes.data, c.ctypes.data if has_c else None, n, out
    )
    return out.raw[:written]


def format_xyz(points: np.ndarray, colors: np.ndarray) -> bytes | None:
    """Native XYZ ASCII formatting; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(points, np.float64)
    c = np.ascontiguousarray(colors, np.int32)
    n = len(p)
    cap = 128 * max(n, 1)
    buf = ctypes.create_string_buffer(cap)
    written = lib.ipc_format_xyz(p.ctypes.data, c.ctypes.data, n, buf, cap)
    if written < 0:
        return None
    return buf.raw[:written]


def _unpack_mesh(lib, vp, cp, fp, nv, nf):
    """Copy C-allocated (verts, colors, faces) buffers out and release
    them — shared by surface_reconstruct and poisson_reconstruct."""
    try:
        verts = np.ctypeslib.as_array(
            ctypes.cast(vp, ctypes.POINTER(ctypes.c_float)), (nv.value, 3)
        ).copy()
        vcols = np.ctypeslib.as_array(
            ctypes.cast(cp, ctypes.POINTER(ctypes.c_uint8)), (nv.value, 3)
        ).copy()
        faces = np.ctypeslib.as_array(
            ctypes.cast(fp, ctypes.POINTER(ctypes.c_int32)), (nf.value, 3)
        ).copy()
    finally:
        lib.ipc_surface_release(vp, cp, fp)
    return verts, vcols, faces


def surface_reconstruct(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    *,
    depth: int = 6,
    orient: str = "centroid",
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Poisson-class implicit reconstruction of an arbitrary point cloud.

    Native SDF (oriented PCA normals, Hoppe-style tangent-plane
    projection) + marching tetrahedra — the framework's equivalent of the
    reference's Open3D ``create_from_point_cloud_poisson(depth=8)`` /
    ball-pivoting (backend/app.py:283-305) for clouds with no known grid
    topology. Returns (verts f32 (V,3), colors u8 (V,3), faces i32 (F,3))
    or None if the native module is unavailable / reconstruction fails.

    Args:
      points: (N, 3) positions.
      colors: optional (N, 3) uint8 (0-255) per-point colors.
      depth: resolution exponent (grid ≈ 2**depth per axis, clamped).
      orient: 'centroid' (closed objects — normals point away from the
        centroid) or 'camera' (depth clouds — normals toward the origin).
    """
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(points, np.float32)
    if colors is not None:
        c = np.ascontiguousarray(np.clip(colors, 0, 255), np.uint8)
        cptr = c.ctypes.data
    else:
        c, cptr = None, None
    vp = ctypes.c_void_p()
    cp = ctypes.c_void_p()
    fp = ctypes.c_void_p()
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    status = lib.ipc_surface_reconstruct(
        p.ctypes.data, cptr, len(p), int(depth),
        1 if orient == "camera" else 0,
        ctypes.byref(vp), ctypes.byref(cp), ctypes.byref(nv),
        ctypes.byref(fp), ctypes.byref(nf),
    )
    if status != 0:
        return None
    return _unpack_mesh(lib, vp, cp, fp, nv, nf)


def poisson_reconstruct(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    *,
    depth: int = 8,
    orient: str = "centroid",
    crop: bool = True,
    screen_alpha: float = 4.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Poisson surface reconstruction (multigrid Poisson-equation solve).

    The genuine Kazhdan formulation behind the reference's Open3D
    ``create_from_point_cloud_poisson(pcd, depth=8)`` (backend/app.py:
    297-301): splat the oriented normal field, solve lap(chi)=div V with
    geometric multigrid, screened second pass, isovalue = mean chi at the
    samples, marching-tet extraction. ``crop=True`` restricts extraction
    to the sample bounding box, the reference's ``mesh.crop(bbox)``
    behavior (backend/app.py:299-301). Returns (verts f32 (V,3), colors
    u8 (V,3), faces i32 (F,3)) or None on failure.
    """
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(points, np.float32)
    if colors is not None:
        c = np.ascontiguousarray(np.clip(colors, 0, 255), np.uint8)
        cptr = c.ctypes.data
    else:
        c, cptr = None, None
    vp = ctypes.c_void_p()
    cp = ctypes.c_void_p()
    fp = ctypes.c_void_p()
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    status = lib.ipc_poisson_reconstruct(
        p.ctypes.data, cptr, len(p), int(depth),
        1 if orient == "camera" else 0, 1 if crop else 0,
        float(screen_alpha),
        ctypes.byref(vp), ctypes.byref(cp), ctypes.byref(nv),
        ctypes.byref(fp), ctypes.byref(nf),
    )
    if status != 0:
        return None
    return _unpack_mesh(lib, vp, cp, fp, nv, nf)


def mean_nn_distance(points: np.ndarray) -> float | None:
    """Mean nearest-neighbor distance (Open3D
    compute_nearest_neighbor_distance, reference backend/app.py:288-290).
    None if the native module is unavailable or the cloud is degenerate."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(points, np.float32)
    d = lib.ipc_mean_nn_distance(p.ctypes.data, len(p))
    return float(d) if d > 0 else None


def bpa_reconstruct(
    points: np.ndarray,
    radii: np.ndarray | list[float] | None = None,
    *,
    orient: str = "centroid",
) -> np.ndarray | None:
    """Ball-pivoting reconstruction (Bernardini et al.).

    The algorithm behind the reference's ``method="bpa"`` branch
    (Open3D create_from_point_cloud_ball_pivoting, backend/app.py:
    285-294). Vertices are the input points; the returned (F, 3) int32
    faces index into ``points``. When ``radii`` is None the reference's
    radius schedule mean-NN-distance x {1.5, 2.0, 2.5} is used
    (backend/app.py:291). Returns None on failure or if the native
    module is unavailable; an empty (0, 3) array when no ball fits.
    """
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(points, np.float32)
    if radii is None:
        avg = mean_nn_distance(p)
        if avg is None:
            return None
        radii = [avg * 1.5, avg * 2.0, avg * 2.5]
    r = np.ascontiguousarray(np.sort(np.asarray(radii)), np.float32)
    fp = ctypes.c_void_p()
    nf = lib.ipc_bpa_reconstruct(
        p.ctypes.data, len(p), r.ctypes.data, len(r),
        1 if orient == "camera" else 0, ctypes.byref(fp),
    )
    if nf < 0:
        return None
    if nf == 0:
        return np.zeros((0, 3), np.int32)
    try:
        faces = np.ctypeslib.as_array(
            ctypes.cast(fp, ctypes.POINTER(ctypes.c_int32)), (nf, 3)
        ).copy()
    finally:
        lib.ipc_bpa_release(fp)
    return faces


def jpeg_sparse_pack(coeffs):
    """C++ split-sparse pack of truncated JPEG coefficients — the hot
    loop of :func:`ops.jpeg_sparse.block_pack` (which documents the
    layout contract and keeps the numpy oracle the tests compare
    against; this one-pass C++ version is ~15-20x faster on the 1-core
    host, where the pack was ~37% of per-image JPEG planning).

    ``coeffs``: per-component (BH, BW, k, k) int16 arrays in natural
    order, blocks numbering consecutively across components in pack
    order. Returns (counts u8, dc i16, pos u8, val i8, exc_idx i32,
    exc_val i16) exactly as block_pack does, or None when the native
    library is unavailable (callers fall back to the numpy pack)."""
    lib = _load()
    if lib is None:
        return None
    nblocks = sum(c.shape[0] * c.shape[1] for c in coeffs)
    total_ac = sum(
        c.shape[0] * c.shape[1] * (c.shape[2] * c.shape[3] - 1)
        for c in coeffs
    )
    counts = np.empty(nblocks, np.uint8)
    dc = np.empty(nblocks, np.int16)
    pos = np.empty(total_ac, np.uint8)
    val = np.empty(total_ac, np.int8)
    # Worst case every AC nonzero is out of int8 range (synthetic
    # high-contrast content); np.empty is a plain malloc, untouched
    # pages cost nothing.
    exc_idx = np.empty(total_ac, np.int32)
    exc_val = np.empty(total_ac, np.int16)
    n_ac = ctypes.c_int64(0)
    n_exc = ctypes.c_int64(0)
    boff = 0
    for c in coeffs:
        nb = c.shape[0] * c.shape[1]
        k2 = c.shape[2] * c.shape[3]
        arr = np.ascontiguousarray(c, np.int16)
        rc = lib.ipc_jpeg_sparse_pack(
            arr.ctypes.data, nb, k2,
            counts.ctypes.data + boff, dc.ctypes.data + 2 * boff,
            pos.ctypes.data, val.ctypes.data, total_ac,
            exc_idx.ctypes.data, exc_val.ctypes.data, total_ac,
            ctypes.byref(n_ac), ctypes.byref(n_exc),
        )
        if rc != 0:  # capacity overflow: impossible by construction
            return None
        boff += nb
    na, ne = n_ac.value, n_exc.value
    return counts, dc, pos[:na], val[:na], exc_idx[:ne], exc_val[:ne]


def jpeg_coefficients(data: bytes):
    """Entropy-decode a JPEG into quantized DCT coefficients — the
    host half of the hybrid decode path (the dequant/IDCT/upsample/
    color math runs on the device, ops/jpeg.py). Handles sequential
    (SOF0/SOF1) and progressive (SOF2) Huffman streams, interleaved and
    non-interleaved scans, restart intervals. Returns None when the
    native module is unavailable or the stream is unsupported
    (arithmetic coding, 12-bit, CMYK, non-JPEG bytes...), in which case
    the caller falls back to the full host decode (reference's
    cv2.imdecode slot, backend/app.py:433).

    Returns a dict:
      width, height, ncomp
      h, v: per-component sampling factors (len ncomp)
      coeffs: list of (blocks_h, blocks_w, 64) int16 arrays (natural
        order within each block; includes MCU padding blocks)
      qtables: (ncomp, 64) uint16 dequantization tables, natural order
    """
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(14, np.int32)
    rc = lib.ipc_jpeg_probe(buf.ctypes.data, len(buf), info.ctypes.data)
    if rc != 0:
        return None
    w, h, ncomp = int(info[0]), int(info[1]), int(info[2])
    hs, vs = info[3 : 3 + ncomp], info[6 : 6 + ncomp]
    hmax, vmax = int(info[12]), int(info[13])
    if w <= 0 or h <= 0:
        return None
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    coeffs = [
        np.zeros((mcus_y * int(vs[c]), mcus_x * int(hs[c]), 64), np.int16)
        for c in range(ncomp)
    ]
    qt = np.zeros((3, 64), np.uint16)
    ptrs = [c.ctypes.data for c in coeffs] + [0] * (3 - ncomp)
    rc = lib.ipc_jpeg_coeffs(
        buf.ctypes.data, len(buf), ptrs[0], ptrs[1], ptrs[2], qt.ctypes.data
    )
    if rc != 0:
        return None
    return {
        "width": w,
        "height": h,
        "ncomp": ncomp,
        "h": [int(x) for x in hs],
        "v": [int(x) for x in vs],
        "coeffs": coeffs,
        "qtables": qt[:ncomp].copy(),
    }


def jpeg_grid_colors(
    coeffs: "list[np.ndarray]",
    qtables: np.ndarray,
    spec,
    step: int,
) -> "np.ndarray | None":
    """Strided-grid RGB colors of the hybrid-JPEG pipeline, computed on
    the host from the entropy-decoded coefficients (src/colorgrid.cpp)
    instead of riding the D2H bundle as 4:2:0 YCbCr. Returns
    (ceil(h/step), ceil(w/step), 3) uint8, or None when the native
    library is unavailable or the layout is unsupported (k<8, exotic
    sampling factors, strides outside {1,2,4}) — callers then keep the
    device color ride-along (pipeline/graph.py).

    ``spec`` is an ops.jpeg.JpegSpec at k=8 whose out_hw equals the
    working size (no device resize — the caller gates that)."""
    lib = _load()
    if lib is None or spec.k != 8:
        return None
    out_h, out_w = spec.out_hw
    arrs = []
    dims = np.zeros(12, np.int32)
    for c in range(spec.ncomp):
        a = np.ascontiguousarray(coeffs[c], np.int16)
        bh, bw = spec.block_grid(c)
        if a.shape != (bh, bw, 8, 8):
            return None
        arrs.append(a)
        dims[4 * c : 4 * c + 4] = (
            bh, bw, spec.vmax // spec.v[c], spec.hmax // spec.h[c],
        )
    qt = np.ascontiguousarray(qtables, np.float32)
    if qt.shape != (spec.ncomp, 64):
        return None
    gh = -(-out_h // step)
    gw = -(-out_w // step)
    out = np.empty((gh, gw, 3), np.uint8)
    ptrs = [a.ctypes.data for a in arrs] + [0] * (3 - spec.ncomp)
    rc = lib.ipc_jpeg_grid_colors(
        ptrs[0], ptrs[1], ptrs[2], qt.ctypes.data, spec.ncomp,
        dims.ctypes.data, out_h, out_w, int(step), out.ctypes.data,
    )
    if rc != 0:
        return None
    return out
