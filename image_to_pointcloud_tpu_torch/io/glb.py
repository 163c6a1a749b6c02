"""First-party minimal glTF 2.0 binary (GLB) writer.

Replaces the reference's trimesh GLB export
(backend/models/spar3d_processor.py:241-258): a single-mesh scene with
positions, optional normals / vertex colors / UVs, optional embedded PNG
base-color texture, triangles or points mode. One JSON chunk + one BIN
chunk, 4-byte aligned, little-endian — loadable by Three.js GLTFLoader
(the reference frontend's consumer).
"""

from __future__ import annotations

import json
import struct

import numpy as np

__all__ = ["glb_bytes", "write_glb"]

_COMPONENT_F32 = 5126
_COMPONENT_U32 = 5125


def _pad4(b: bytes, fill: bytes = b"\0") -> bytes:
    return b + fill * (-len(b) % 4)


def glb_bytes(
    vertices: np.ndarray,
    faces: np.ndarray | None = None,
    *,
    normals: np.ndarray | None = None,
    colors01: np.ndarray | None = None,
    uvs: np.ndarray | None = None,
    texture_png: bytes | None = None,
    name: str = "mesh",
) -> bytes:
    v = np.ascontiguousarray(vertices, np.float32)
    if len(v) == 0:
        # A 0-count POSITION accessor is invalid glTF, and arr.min(axis=0)
        # below would raise a cryptic numpy reduction error; fail clearly.
        raise ValueError("Cannot export GLB with no vertices")
    buffers: list[bytes] = []
    buffer_views: list[dict] = []
    accessors: list[dict] = []

    def add_view(data: bytes, target: int | None = None) -> int:
        offset = sum(len(b) for b in buffers)
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        buffers.append(_pad4(data))
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, comp: int, type_: str, target: int) -> int:
        view = add_view(np.ascontiguousarray(arr).tobytes(), target)
        acc = {
            "bufferView": view,
            "componentType": comp,
            "count": int(arr.shape[0]),
            "type": type_,
        }
        if type_ == "VEC3" and comp == _COMPONENT_F32:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    attributes = {"POSITION": add_accessor(v, _COMPONENT_F32, "VEC3", 34962)}
    if normals is not None:
        attributes["NORMAL"] = add_accessor(
            np.ascontiguousarray(normals, np.float32), _COMPONENT_F32, "VEC3", 34962
        )
    if colors01 is not None:
        attributes["COLOR_0"] = add_accessor(
            np.ascontiguousarray(colors01, np.float32), _COMPONENT_F32, "VEC3", 34962
        )
    if uvs is not None:
        attributes["TEXCOORD_0"] = add_accessor(
            np.ascontiguousarray(uvs, np.float32), _COMPONENT_F32, "VEC2", 34962
        )

    primitive: dict = {"attributes": attributes}
    if faces is not None and len(faces):
        idx = np.ascontiguousarray(np.asarray(faces, np.uint32).reshape(-1))
        view = add_view(idx.tobytes(), 34963)
        accessors.append(
            {
                "bufferView": view,
                "componentType": _COMPONENT_U32,
                "count": int(idx.shape[0]),
                "type": "SCALAR",
            }
        )
        primitive["indices"] = len(accessors) - 1
        primitive["mode"] = 4  # TRIANGLES
    else:
        primitive["mode"] = 0  # POINTS

    gltf: dict = {
        "asset": {"version": "2.0", "generator": "image_to_pointcloud_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": name}],
        "meshes": [{"primitives": [primitive], "name": name}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    if texture_png is not None:
        img_view = add_view(texture_png)
        gltf["images"] = [{"bufferView": img_view, "mimeType": "image/png"}]
        gltf["samplers"] = [{"magFilter": 9729, "minFilter": 9987}]
        gltf["textures"] = [{"source": 0, "sampler": 0}]
        gltf["materials"] = [
            {
                "pbrMetallicRoughness": {
                    "baseColorTexture": {"index": 0},
                    "metallicFactor": 0.0,
                    "roughnessFactor": 0.9,
                },
                "name": f"{name}_material",
            }
        ]
        primitive["material"] = 0

    bin_chunk = b"".join(buffers)
    gltf["buffers"] = [{"byteLength": len(bin_chunk)}]

    json_chunk = _pad4(json.dumps(gltf, separators=(",", ":")).encode(), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    out = b"".join(
        [
            struct.pack("<4sLL", b"glTF", 2, total),
            struct.pack("<L4s", len(json_chunk), b"JSON"),
            json_chunk,
            struct.pack("<L4s", len(bin_chunk), b"BIN\0"),
            bin_chunk,
        ]
    )
    return out


def write_glb(path: str, *args, **kwargs) -> str:
    with open(path, "wb") as f:
        f.write(glb_bytes(*args, **kwargs))
    return path
