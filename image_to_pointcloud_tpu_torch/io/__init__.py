"""First-party exporters and host-side image codecs."""

from image_to_pointcloud_tpu_torch.io.image import (
    decode_image_rgb,
    encode_png,
    png_data_url,
    png_data_url_palette,
)
from image_to_pointcloud_tpu_torch.io.las import las_bytes, read_las, write_las
from image_to_pointcloud_tpu_torch.io.metadata import generate_gis_metadata
from image_to_pointcloud_tpu_torch.io.ply import (
    ply_points_bytes,
    read_ply,
    write_ply_mesh,
    write_ply_points,
)
from image_to_pointcloud_tpu_torch.io.xyz import write_xyz, xyz_bytes

__all__ = [
    "decode_image_rgb",
    "encode_png",
    "png_data_url",
    "png_data_url_palette",
    "las_bytes",
    "read_las",
    "write_las",
    "generate_gis_metadata",
    "ply_points_bytes",
    "read_ply",
    "write_ply_mesh",
    "write_ply_points",
    "xyz_bytes",
    "write_xyz",
]
