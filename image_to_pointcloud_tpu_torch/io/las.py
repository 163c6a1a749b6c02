"""First-party LAS 1.2 writer (point format 2), byte-compatible with the
reference's laspy export (backend/app.py:343-377):

* scale 0.01 on all axes, offsets = per-axis minima,
* RGB stored as ``clip(c, 0, 255).astype(uint16) * 256`` — astype
  TRUNCATES fractional colors exactly like the reference's
  ``np.clip(colors, 0, 255).astype(np.uint16)`` (backend/app.py:366);
  gray 32768 fallback when no colors are supplied,
* LAS 1.2 public header (227 bytes), zero VLRs, point record length 26.

Pure numpy struct packing — no per-point Python. A reader is included
for round-trip tests and for the v2 API's file introspection.
"""

from __future__ import annotations

import datetime
import struct

import numpy as np

__all__ = ["write_las", "las_bytes", "read_las"]

_HEADER_SIZE = 227
_POINT_LEN = 26  # point format 2
_SOFTWARE = b"image_to_pointcloud_tpu"


def las_bytes(
    points: np.ndarray,
    colors: np.ndarray | None,
    scale: float = 0.01,
    day_year: tuple[int, int] | None = None,
) -> bytes:
    if points is None or len(points) == 0:
        # The reference computes offsets from points[:, 0].min() *before* its
        # empty-input guard (SURVEY.md §8 quirk 4) and therefore raises on
        # empty input; we raise the intended error.
        raise ValueError("No points to write to LAS")
    p = np.asarray(points, np.float64)
    n = len(p)
    offset = p.min(axis=0)
    inv = 1.0 / scale
    ixyz = np.round((p - offset) * inv).astype(np.int64)
    if np.any(np.abs(ixyz) > 2**31 - 1):
        raise ValueError("Coordinates overflow LAS int32 at scale %g" % scale)
    ixyz = ixyz.astype("<i4")

    if colors is not None and len(colors) != n:
        # The gray fallback is for "no colors supplied" — silently
        # graying a MIS-MATCHED colors array would mask a caller bug
        # (ply raises on the same condition; exporters must agree).
        raise ValueError(f"colors length {len(colors)} != points length {n}")
    if colors is not None:
        c = np.clip(np.asarray(colors), 0, 255).astype(np.uint16) * 256
    else:
        c = np.full((n, 3), 32768, np.uint16)

    rec = np.zeros(
        n,
        dtype=np.dtype(
            [
                ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
                ("intensity", "<u2"), ("flags", "u1"), ("cls", "u1"),
                ("scan_angle", "i1"), ("user", "u1"), ("src", "<u2"),
                ("red", "<u2"), ("green", "<u2"), ("blue", "<u2"),
            ]
        ),
    )
    rec["x"], rec["y"], rec["z"] = ixyz[:, 0], ixyz[:, 1], ixyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]

    if day_year is None:
        today = datetime.date.today()
        day_year = (today.timetuple().tm_yday, today.year)

    maxs = p.max(axis=0)
    mins = p.min(axis=0)
    header = b"".join(
        [
            b"LASF",
            struct.pack("<H", 0),          # file source id
            struct.pack("<H", 0),          # global encoding
            struct.pack("<L", 0),          # GUID data 1
            struct.pack("<H", 0),          # GUID data 2
            struct.pack("<H", 0),          # GUID data 3
            b"\0" * 8,                     # GUID data 4
            struct.pack("<BB", 1, 2),      # version
            b"\0" * 32,                    # system identifier
            _SOFTWARE.ljust(32, b"\0"),    # generating software
            struct.pack("<HH", *day_year),
            struct.pack("<H", _HEADER_SIZE),
            struct.pack("<L", _HEADER_SIZE),
            struct.pack("<L", 0),          # num VLRs
            struct.pack("<B", 2),          # point data format 2
            struct.pack("<H", _POINT_LEN),
            struct.pack("<L", n),          # number of point records
            struct.pack("<5L", n, 0, 0, 0, 0),  # points by return
            struct.pack("<3d", scale, scale, scale),
            struct.pack("<3d", *offset),
            struct.pack("<dd", maxs[0], mins[0]),
            struct.pack("<dd", maxs[1], mins[1]),
            struct.pack("<dd", maxs[2], mins[2]),
        ]
    )
    assert len(header) == _HEADER_SIZE, len(header)
    return header + rec.tobytes()


def write_las(
    path: str, points: np.ndarray, colors: np.ndarray | None, scale: float = 0.01
) -> str:
    with open(path, "wb") as f:
        f.write(las_bytes(points, colors, scale))
    return path


def read_las(path_or_bytes) -> dict:
    """Minimal LAS 1.2 pf2 reader for round-trip tests."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    assert data[:4] == b"LASF"
    (fmt,) = struct.unpack_from("<B", data, 104)
    (plen,) = struct.unpack_from("<H", data, 105)
    (count,) = struct.unpack_from("<L", data, 107)
    scales = struct.unpack_from("<3d", data, 131)
    offsets = struct.unpack_from("<3d", data, 155)
    (off_pts,) = struct.unpack_from("<L", data, 96)
    assert fmt == 2 and plen == _POINT_LEN
    rec = np.frombuffer(
        data[off_pts : off_pts + count * _POINT_LEN],
        dtype=np.dtype(
            [
                ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
                ("intensity", "<u2"), ("flags", "u1"), ("cls", "u1"),
                ("scan_angle", "i1"), ("user", "u1"), ("src", "<u2"),
                ("red", "<u2"), ("green", "<u2"), ("blue", "<u2"),
            ]
        ),
    )
    pts = np.stack(
        [
            rec["x"] * scales[0] + offsets[0],
            rec["y"] * scales[1] + offsets[1],
            rec["z"] * scales[2] + offsets[2],
        ],
        axis=1,
    )
    rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
    return {"points": pts, "rgb16": rgb, "scales": scales, "offsets": offsets}
