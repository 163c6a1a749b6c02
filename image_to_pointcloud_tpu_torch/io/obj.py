"""Wavefront OBJ writer (meshes with per-vertex colors, or point sets).

Interchange format beyond the reference's exporter set. Vertex colors
use the widely supported unofficial `v x y z r g b` extension
(MeshLab/Blender read it); faces are 1-indexed triangles.
"""

from __future__ import annotations

import numpy as np

__all__ = ["obj_bytes", "write_obj"]


def obj_bytes(
    vertices: np.ndarray,
    faces: np.ndarray | None = None,
    colors: np.ndarray | None = None,
) -> bytes:
    """``colors`` are 0–255 (the framework convention, matching the PCD
    writer); they are scaled to the 0–1 floats the `v x y z r g b`
    extension expects."""
    v = np.asarray(vertices, np.float64)
    out = ["# image_to_pointcloud_tpu OBJ export"]
    if colors is not None and len(v):
        if len(colors) != len(v):
            # zip() would silently truncate the vertex list while faces
            # still reference the dropped indices — a corrupt OBJ.
            raise ValueError(
                f"colors length {len(colors)} != vertices length {len(v)}"
            )
        c = np.clip(np.asarray(colors, np.float64), 0, 255) / 255.0
        for (x, y, z), (r, g, b) in zip(v, c):
            out.append(f"v {x:.6f} {y:.6f} {z:.6f} {r:.4f} {g:.4f} {b:.4f}")
    else:
        for x, y, z in v:
            out.append(f"v {x:.6f} {y:.6f} {z:.6f}")
    if faces is not None:
        for a, b, cc in np.asarray(faces, np.int64) + 1:
            out.append(f"f {a} {b} {cc}")
    return ("\n".join(out) + "\n").encode()


def write_obj(path: str, vertices, faces=None, colors=None) -> str:
    with open(path, "wb") as f:
        f.write(obj_bytes(vertices, faces, colors))
    return path
