"""The port's own copies of the host modules against the JAX package's
originals, byte for byte, on seeded numpy inputs.

The port carries its own ``io/``, ``native/``, ``pipeline/meshing.py``,
``core/config.py`` and HTTP layer so that it imports nothing of the JAX
package. The copies must keep the originals' behaviour and output bytes:
each case below runs one function on both sides with the same inputs and
compares everything it returns (array dtypes, shapes and bytes; file
bytes for the writers). Tolerance: none.
"""

from __future__ import annotations

import io
import json
from types import SimpleNamespace

import numpy as np
import pytest

from image_to_pointcloud_tpu import io as j_io
from image_to_pointcloud_tpu import native as j_native
from image_to_pointcloud_tpu.core import config as j_config
from image_to_pointcloud_tpu.io import image as j_image
from image_to_pointcloud_tpu.pipeline import meshing as j_meshing
from image_to_pointcloud_tpu_torch import io as t_io
from image_to_pointcloud_tpu_torch import native as t_native
from image_to_pointcloud_tpu_torch.core import config as t_config
from image_to_pointcloud_tpu_torch.io import image as t_image
from image_to_pointcloud_tpu_torch.pipeline import meshing as t_meshing

SIDES = (
    SimpleNamespace(name="jax", io=j_io, image=j_image, native=j_native, meshing=j_meshing,
                    config=j_config),
    SimpleNamespace(name="torch", io=t_io, image=t_image, native=t_native, meshing=t_meshing,
                    config=t_config),
)


def _bytes(obj) -> bytes:
    """Everything a result holds, as bytes: arrays with dtype and shape."""
    if obj is None:
        return b"None"
    if isinstance(obj, np.ndarray):
        return f"{obj.dtype.str}{obj.shape}".encode() + np.ascontiguousarray(obj).tobytes()
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj)
    if isinstance(obj, str):
        return obj.encode()
    if isinstance(obj, dict):
        return b"{" + b",".join(_bytes(k) + b":" + _bytes(v) for k, v in sorted(obj.items())) + b"}"
    if isinstance(obj, (list, tuple)):
        return b"[" + b",".join(_bytes(v) for v in obj) + b"]"
    return repr(obj).encode()  # numbers, and load_config's frozen dataclasses


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _points(n=500, seed=0):
    r = _rng(seed)
    pts = (r.normal(0, 3, (n, 3))).astype(np.float32)
    cols = r.integers(0, 256, (n, 3)).astype(np.float32)
    return pts, cols


def _mesh(seed=1):
    r = _rng(seed)
    hh, ww = 9, 11
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float64)
    verts = np.stack([xx, yy, r.normal(0, 0.1, (hh, ww))], -1).reshape(-1, 3)
    quads = [(y * ww + x, y * ww + x + 1, (y + 1) * ww + x, (y + 1) * ww + x + 1)
             for y in range(hh - 1) for x in range(ww - 1)]
    faces = np.array([t for a, b, c, d in quads for t in ((a, c, b), (b, c, d))], np.int32)
    cols = r.integers(0, 256, (len(verts), 3)).astype(np.float64)
    return verts, cols, faces


def _frame(h=37, w=53, seed=2):
    return _rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _jpeg(subsampling: int, seed=3) -> bytes:
    from PIL import Image

    yy, xx = np.mgrid[0:88, 0:120]
    base = np.stack([xx * 2, yy * 2, (xx + yy)], -1)
    img = np.clip(base + _rng(seed).integers(0, 24, base.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=88, subsampling=subsampling)
    return buf.getvalue()


def _grid(seed=4, hh=24, ww=30):
    r = _rng(seed)
    d16 = r.integers(0, 65536, (hh, ww)).astype(np.uint16)
    keep = r.random((hh, ww)) < 0.8
    return d16, keep


def _written(tmp_path, side, name, write, *args, **kw) -> bytes:
    path = tmp_path / f"{side}_{name}"
    write(str(path), *args, **kw)
    return path.read_bytes()


def _packed(seed=5, hh=12, ww=14):
    r = _rng(seed)
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    z = 5 + r.normal(0, 0.05, (hh, ww)).astype(np.float32)
    z[4:7, 5:9] += 4.0  # a depth edge for the edge cut
    packed = np.zeros((8, hh * ww), np.float32)
    packed[0], packed[1], packed[2] = xx.ravel(), yy.ravel(), z.ravel()
    packed[3:6] = r.integers(0, 256, (3, hh * ww))
    packed[6] = (r.random(hh * ww) < 0.9).astype(np.float32)
    return packed, (hh, ww)


def _config_file(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "_comment": "ignored", "port": "8123", "max_batch": 4, "jpeg_device_decode": True,
        "defaults": {"depth_scale": "12.5", "output_format": "ply"},
        "v2": {"texture_resolution_range": [256, 1024]},
    }))
    return str(path)


# name -> fn(side, tmp_path) -> object compared as bytes
CASES = {
    "write_ply_points/colors": lambda s, t: _written(
        t, s.name, "p.ply", s.io.write_ply_points, *_points()),
    "write_ply_points/no_colors": lambda s, t: _written(
        t, s.name, "p.ply", s.io.write_ply_points, _points()[0], None),
    "write_ply_mesh/colors_normals": lambda s, t: _written(
        t, s.name, "m.ply", s.io.write_ply_mesh, _mesh()[0], _mesh()[2],
        colors=_mesh()[1], normals=s.meshing.vertex_normals(_mesh()[0], _mesh()[2])),
    "write_ply_mesh/bare": lambda s, t: _written(
        t, s.name, "m.ply", s.io.write_ply_mesh, _mesh()[0], _mesh()[2]),
    "write_las/colors": lambda s, t: _written(t, s.name, "p.las", s.io.write_las, *_points()),
    "write_las/no_colors": lambda s, t: _written(
        t, s.name, "p.las", s.io.write_las, _points()[0], None, 0.001),
    "write_xyz/colors": lambda s, t: _written(t, s.name, "p.xyz", s.io.write_xyz, *_points()),
    "write_xyz/no_colors": lambda s, t: _written(
        t, s.name, "p.xyz", s.io.write_xyz, _points()[0], None),
    "generate_gis_metadata/plain": lambda s, t: json.dumps(s.io.generate_gis_metadata(
        _points()[0], coordinate_system="WGS84", model="depth-anything-v2",
        output_format="las", point_density="medium", depth_scale=10.0, invert_depth=True,
        smooth_depth=False), sort_keys=True),
    "generate_gis_metadata/gps": lambda s, t: json.dumps(s.io.generate_gis_metadata(
        _points(seed=9)[0], coordinate_system="UTM", model="dpt-large", output_format="ply",
        point_density="high", depth_scale=2.5, invert_depth=False, smooth_depth=True,
        gps_coords={"latitude": 47.5, "longitude": -122.25, "altitude": 12.0}),
        sort_keys=True),
    "png/round_trip": lambda s, t: (
        s.image.encode_png(_frame()), s.image.decode_image_rgb(s.image.encode_png(_frame()))),
    "png/data_urls": lambda s, t: (
        s.image.png_data_url(_frame(20, 30, 6)),
        s.image.png_data_url_palette(_frame(20, 30, 7)[..., 0],
                                     _rng(8).integers(0, 256, (256, 3)).astype(np.uint8))),
    "decode_image_rgb/jpeg": lambda s, t: s.image.decode_image_rgb(_jpeg(2)),
    "native/reconstruct_points": lambda s, t: s.native.reconstruct_points(
        *_grid(), _frame(24, 30, 10), step=2, depth_scale=15.0, f=331.5, cx=259.0, cy=259.0),
    "native/reconstruct_points/denom4095": lambda s, t: s.native.reconstruct_points(
        _grid()[0] % 4096, _grid()[1], _frame(48, 60, 11)[::2, ::2], step=1, depth_scale=2.5,
        f=100.0, cx=30.0, cy=24.0, denom=4095.0),
    "native/reconstruct_points_ycc420": lambda s, t: s.native.reconstruct_points_ycc420(
        *_grid(), _frame(24, 30, 12)[..., 0], _frame(12, 15, 13)[..., 0],
        _frame(12, 15, 14)[..., 0], step=2, depth_scale=15.0, f=331.5, cx=259.0, cy=259.0),
    "native/jpeg_coefficients/444": lambda s, t: s.native.jpeg_coefficients(_jpeg(0)),
    "native/jpeg_coefficients/420": lambda s, t: s.native.jpeg_coefficients(_jpeg(2)),
    "native/jpeg_sparse_pack": lambda s, t: s.native.jpeg_sparse_pack(
        [c.reshape(c.shape[0], c.shape[1], 8, 8)
         for c in s.native.jpeg_coefficients(_jpeg(2, seed=15))["coeffs"]]),
    "native/json_f32_triplets": lambda s, t: s.native.json_f32_triplets(_points(300)[0]),
    "native/ply_pack/colors": lambda s, t: s.native.ply_pack(*_points()),
    "native/ply_pack/no_colors": lambda s, t: s.native.ply_pack(_points()[0], None),
    "native/decimate_mesh": lambda s, t: s.native.decimate_mesh(*_mesh(), 60),
    "meshing/grid_mesh_from_packed/stride1": lambda s, t: s.meshing.grid_mesh_from_packed(
        *_packed()),
    "meshing/grid_mesh_from_packed/stride2": lambda s, t: s.meshing.grid_mesh_from_packed(
        *_packed(seed=16), stride=2, edge_cut=2.0),
    "load_config/file_and_env": lambda s, t: s.config.load_config(
        _config_file(t), env={"IPC_TPU_WARMUP": "518", "IPC_TPU_HONOR_FOV": "yes"}),
}


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not (t_native.available() and j_native.available()):
        pytest.skip("the native library (g++ build) is unavailable")


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_copy_matches_original_bytes(case, tmp_path):
    out = {}
    for side in SIDES:
        result = CASES[case](side, tmp_path)
        assert result is not None, f"{case}: the {side.name} side returned None"
        out[side.name] = _bytes(result)
    assert out["torch"] == out["jax"], case
    assert len(out["torch"]) > 8
