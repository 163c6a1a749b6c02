"""XYZ ASCII exporter, line-compatible with the reference
(backend/app.py:379-389): ``"%.6f %.6f %.6f %d %d %d"`` per point, colors
truncated to int exactly like Python's ``int()`` on the float32 values,
``128 128 128`` when no colors are present.

Vectorized via numpy savetxt-style formatting in C, not a Python loop.
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_xyz", "xyz_bytes"]


def xyz_bytes(points: np.ndarray, colors: np.ndarray | None) -> bytes:
    n = len(points)
    p = np.asarray(points, np.float64)
    if colors is not None and len(colors) > 0:
        if len(colors) != n:
            # The native formatter indexes colors per point with no
            # bounds check — a short array would read past the buffer.
            raise ValueError(
                f"colors length {len(colors)} != points length {n}"
            )
        c = np.asarray(colors, np.float64).astype(np.int64)  # trunc, like int()
    else:
        c = np.full((n, 3), 128, np.int64)

    from image_to_pointcloud_tpu_torch import native

    fast = native.format_xyz(p, c.astype(np.int32))
    if fast is not None:
        return fast
    lines = [
        b"%.6f %.6f %.6f %d %d %d"
        % (p[i, 0], p[i, 1], p[i, 2], c[i, 0], c[i, 1], c[i, 2])
        for i in range(n)
    ]
    return b"\n".join(lines) + (b"\n" if n else b"")


def write_xyz(path: str, points: np.ndarray, colors: np.ndarray | None) -> str:
    with open(path, "wb") as f:
        f.write(xyz_bytes(points, colors))
    return path
