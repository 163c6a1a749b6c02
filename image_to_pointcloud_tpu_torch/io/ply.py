"""First-party PLY writer/reader (binary little-endian).

Replaces the reference's Open3D PLY export (backend/app.py:329-341):
float64 x/y/z + uchar red/green/blue vertex properties, binary
little-endian — the same on-disk layout Open3D produces for a colored
point cloud (colors round-tripped via the reference's ``colors / 255``
convention). Mesh PLY (vertices + faces) covers the ``mesh_ply`` output
format (backend/app.py:509-535).

The writer consumes the packed planar point buffer straight from HBM
pulls; packing is one numpy structured-array assignment (no per-point
Python), with an optional C++ fast path in native/.
"""

from __future__ import annotations

import io as _io

import numpy as np

__all__ = ["write_ply_points", "write_ply_mesh", "read_ply", "ply_points_bytes"]


def ply_points_bytes(points: np.ndarray, colors: np.ndarray | None) -> bytes:
    """Serialize (N,3) points [+ (N,3) 0-255 colors] to binary PLY bytes."""
    n = len(points)
    has_c = colors is not None and len(colors) == n
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += ["property double x", "property double y", "property double z"]
    if has_c:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header += ["end_header", ""]

    head = "\n".join(header).encode("ascii")

    # Native fast path (exact same byte layout; f32 inputs only so the
    # f64 promotion happens in C with no precision change).
    pts = np.asarray(points)
    if pts.dtype == np.float32 and (
        not has_c or np.asarray(colors).dtype in (np.float32, np.uint8)
    ):
        from image_to_pointcloud_tpu_torch import native

        body = native.ply_pack(pts, np.asarray(colors) if has_c else None)
        if body is not None:
            return head + body

    fields = [("x", "<f8"), ("y", "<f8"), ("z", "<f8")]
    if has_c:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, dtype=np.dtype(fields))
    p = np.asarray(points, np.float64)
    rec["x"], rec["y"], rec["z"] = p[:, 0], p[:, 1], p[:, 2]
    if has_c:
        c = np.clip(np.round(np.asarray(colors, np.float64)), 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
    return head + rec.tobytes()


def write_ply_points(
    path: str, points: np.ndarray, colors: np.ndarray | None
) -> str:
    with open(path, "wb") as f:
        f.write(ply_points_bytes(points, colors))
    return path


def write_ply_mesh(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
) -> str:
    """Binary PLY triangle mesh (double verts, optional normals/colors)."""
    n, m = len(vertices), len(faces)
    has_c = colors is not None and len(colors) == n
    has_n = normals is not None and len(normals) == n
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += ["property double x", "property double y", "property double z"]
    if has_n:
        header += ["property double nx", "property double ny", "property double nz"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [
        f"element face {m}",
        "property list uchar int vertex_indices",
        "end_header",
        "",
    ]
    fields = [("x", "<f8"), ("y", "<f8"), ("z", "<f8")]
    if has_n:
        fields += [("nx", "<f8"), ("ny", "<f8"), ("nz", "<f8")]
    if has_c:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, dtype=np.dtype(fields))
    v = np.asarray(vertices, np.float64)
    rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
    if has_n:
        nn = np.asarray(normals, np.float64)
        rec["nx"], rec["ny"], rec["nz"] = nn[:, 0], nn[:, 1], nn[:, 2]
    if has_c:
        c = np.clip(np.round(np.asarray(colors, np.float64)), 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]

    frec = np.empty(
        m, dtype=np.dtype([("cnt", "u1"), ("idx", "<i4", (3,))])
    )
    frec["cnt"] = 3
    frec["idx"] = np.asarray(faces, np.int32)

    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())
        f.write(frec.tobytes())
    return path


def read_ply(path_or_bytes) -> dict:
    """Minimal binary/ascii PLY reader for round-trip tests."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = _io.BytesIO(path_or_bytes)
    else:
        buf = open(path_or_bytes, "rb")
    try:
        # header
        lines = []
        while True:
            line = buf.readline().decode("ascii").strip()
            lines.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in lines if l.startswith("format"))
        elements = []  # (name, count, [(prop, type) or ("list", ...)])
        cur = None
        for l in lines:
            t = l.split()
            if not t:
                continue
            if t[0] == "element":
                cur = {"name": t[1], "count": int(t[2]), "props": []}
                elements.append(cur)
            elif t[0] == "property" and cur is not None:
                if t[1] == "list":
                    cur["props"].append(("list", t[2], t[3], t[4]))
                else:
                    cur["props"].append((t[2], t[1]))  # (name, type)

        tmap = {
            "double": "<f8", "float64": "<f8", "float": "<f4", "float32": "<f4",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
            "uint": "<u4", "uint32": "<u4",
        }
        out: dict = {}
        for el in elements:
            if any(p[0] == "list" for p in el["props"]):
                # face element: assume single uchar-count + int list of 3
                faces = []
                for _ in range(el["count"]):
                    cnt = np.frombuffer(buf.read(1), "u1")[0]
                    faces.append(np.frombuffer(buf.read(4 * cnt), "<i4"))
                out[el["name"]] = np.array(faces)
            else:
                dt = np.dtype([(p[0], tmap[p[1]]) for p in el["props"]])
                data = np.frombuffer(buf.read(dt.itemsize * el["count"]), dt)
                out[el["name"]] = data
        assert fmt == "binary_little_endian"
        return out
    finally:
        buf.close()
