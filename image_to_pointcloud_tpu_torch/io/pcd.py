"""PCD (Point Cloud Data / PCL) writer — binary, xyz + packed rgb.

Interchange format beyond the reference's PLY/LAS/XYZ set: PCD is the
native format of the Point Cloud Library, widely used in robotics
pipelines. Layout: ASCII header, then binary little-endian records of
x y z (f32) and rgb packed as a float-reinterpreted 0x00RRGGBB u32 —
PCL's standard color convention.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pcd_bytes", "write_pcd"]


def pcd_bytes(points: np.ndarray, colors: np.ndarray | None = None) -> bytes:
    p = np.ascontiguousarray(points, np.float32)
    n = len(p)
    has_rgb = colors is not None
    fields = "x y z rgb" if has_rgb else "x y z"
    sizes = "4 4 4 4" if has_rgb else "4 4 4"
    types = "F F F F" if has_rgb else "F F F"
    counts = "1 1 1 1" if has_rgb else "1 1 1"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        "DATA binary\n"
    ).encode()
    if not has_rgb:
        return header + p.tobytes()
    c = np.clip(np.asarray(colors), 0, 255).astype(np.uint32)
    packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    rgb_f = packed.view(np.float32)
    rec = np.empty((n, 4), np.float32)
    rec[:, :3] = p
    rec[:, 3] = rgb_f
    return header + rec.tobytes()


def write_pcd(path: str, points, colors=None) -> str:
    with open(path, "wb") as f:
        f.write(pcd_bytes(points, colors))
    return path
